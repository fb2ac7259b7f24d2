"""Tracing & profiling: distributed spans, task timeline export, profiler hooks.

Role-equivalent to the reference's tracing stack (SURVEY §5): the C++
TaskEventBuffer -> GcsTaskManager -> `ray timeline` pipeline
(src/ray/core_worker/task_event_buffer.h) becomes per-worker event buffers
shipped with the metrics reporter and aggregated on the controller. Device
traces (``profile_tpu``) are torch.profiler captures through
``obs.profiler.device_capture``, where the reference captures a JAX trace.

Distributed tracing (this module's Span API): a trace context
``(trace_id, span_id)`` rides a contextvar inside one process and the
task-spec / call payloads across processes (core/worker.py attaches the
caller's active context to every submitted task; the executor re-activates
it around user code). Every cross-process hop — task submission, actor
calls, serve handle -> proxy -> replica, compiled-DAG pushes, the LLM
engine — therefore stitches into ONE trace with parent/child span links,
aggregated on the controller (indexable via ``get_trace``/``list_traces``
and the dashboard's ``/api/traces``) and rendered by ``export_timeline``
as connected chrome-trace lanes with flow arrows (``ph: s/f``) across
process boundaries.

Cost contract: with no span active the ONLY per-call cost anywhere on the
hot path is one ``ContextVar.get`` returning None (guards sit before any
dict building or id minting); ``child_span`` is a no-op then. Creating a
root span is explicit (``span(...)`` or the serve proxy's ``x-trace``
header / ``set_trace_enabled``).
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from typing import Optional

# The active trace context of this thread/task: (trace_id, span_id) or None.
_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "raytpu_trace_ctx", default=None
)

# Process-wide default for auto-root spans (serve proxy ingress): off by
# default so the serving hot path pays nothing unless asked.
_trace_all = os.environ.get("RAYTPU_TRACE", "") in ("1", "true", "on")


def now() -> float:
    """THE event/span timestamp clock. Every producer on the observability
    plane (worker `_event`/`_task_event`, controller `_event`, Span,
    `event()`) stamps through here, so state-index timings and span timings
    land on one comparable timeline — swap the time source in one place,
    never per-emitter."""
    return time.time()


def set_trace_enabled(on: bool):
    """Enable auto-root spans for ingress points that support them (the
    serve HTTP proxy traces every request when on; individual requests can
    also opt in with an ``x-trace: 1`` header)."""
    global _trace_all
    _trace_all = bool(on)


def trace_enabled() -> bool:
    return _trace_all


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def current_trace() -> Optional[tuple]:
    """The active (trace_id, span_id) of this thread/task, or None. This is
    what cross-process propagation attaches to outgoing payloads."""
    return _ctx.get()


# Per-trace profiling hook: (begin(trace_id) -> token, end(token)), installed
# by obs.profiler.arm when the continuous sampler runs. activate/deactivate
# bracket traced exec spans, so the sampler can attribute an executor
# thread's samples to the trace it is serving — the cost contract holds:
# untraced paths never reach the hook (activate(None) returns first), and
# traced paths pay one extra global read when no profiler is armed.
_prof_hook: Optional[tuple] = None


def set_profile_hook(begin, end):
    """Install (or clear, with begin=None) the per-trace profile scope hook.
    Owner: obs.profiler — nothing else should call this."""
    global _prof_hook
    _prof_hook = (begin, end) if begin is not None else None


def activate(ctx: Optional[tuple]):
    """Install a propagated (trace_id, span_id) as this thread's active
    context; returns a token for ``deactivate``. None -> no-op (None token).
    With a profiler armed, also opens the trace's profile scope on this
    thread (the token carries the scope; deactivate closes it)."""
    if ctx is None:
        return None
    tok = _ctx.set((ctx[0], ctx[1]))
    hook = _prof_hook
    if hook is None:
        return tok
    try:
        ptok = hook[0](ctx[0])
    except Exception:
        return tok  # profiling must never break task execution
    return (tok, hook[1], ptok)


def deactivate(token):
    if token is None:
        return
    if type(token) is tuple:  # (ctx token, profile end fn, profile token)
        tok, end, ptok = token
        try:
            end(ptok)
        except Exception:
            pass
        _ctx.reset(tok)
        return
    _ctx.reset(token)


def _record_event(ev: dict):
    """Append a span event to this process's task-event buffer (ships to the
    controller with the metrics reporter). No core worker -> dropped."""
    from ray_tpu_torch.core import api

    core = api._global_worker
    if core is not None:
        core._event("span", **ev)


class Span:
    """One timed span. Context manager; re-entrant use is NOT supported
    (create a new Span per block). On exit records a single ``span`` task
    event carrying (trace_id, span_id, parent_id, name, start, dur)."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id", "_token", "_t0")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs
        parent = _ctx.get()
        if parent is None:
            self.trace_id = new_trace_id()
            self.parent_id = ""
        else:
            self.trace_id = parent[0]
            self.parent_id = parent[1]
        self.span_id = new_span_id()
        self._token = None
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._token = _ctx.set((self.trace_id, self.span_id))
        self._t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        _ctx.reset(self._token)
        ev = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self._t0,
            "dur": now() - self._t0,
        }
        if self.attrs:
            ev["attrs"] = self.attrs
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        _record_event(ev)
        return False


def span(name: str, **attrs) -> Span:
    """Start a span (new root trace if none is active)."""
    return Span(name, attrs or None)


def event(name: str, **attrs):
    """Record a point event (zero-duration span) onto the ACTIVE trace —
    chunk retries, queue admissions, anything worth a timeline tick without
    its own span. Free no-op when no trace is active."""
    ctx = _ctx.get()
    if ctx is None:
        return
    ev = {
        "name": name,
        "trace_id": ctx[0],
        "span_id": new_span_id(),
        "parent_id": ctx[1],
        "ts": now(),
        "dur": 0.0,
    }
    if attrs:
        ev["attrs"] = attrs
    _record_event(ev)


def child_span(name: str, **attrs):
    """A span ONLY when a trace is already active, else a free no-op — the
    form internal subsystems (LLM engine, serve replica) use so untraced
    hot paths pay a single contextvar read."""
    if _ctx.get() is None:
        return contextlib.nullcontext()
    return Span(name, attrs or None)


def get_task_events(limit: int = 20000) -> list[dict]:
    """Cluster-wide task events (submission, execution spans, recoveries)."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    # Flush this process's own buffer first so driver-side events are current
    # (events only; metrics ship on their periodic schedule).
    core._run(core._flush_task_events())
    return core._run(core.controller.call("get_task_events", {"limit": limit}))


def get_trace(trace_id: str) -> list[dict]:
    """All events recorded under one trace id, cluster-wide, time-ordered.

    Staleness window: only THIS process's buffer is flushed on demand;
    events recorded on other workers arrive with their periodic reporter
    tick (metrics_report_interval_s, default 5s). Poll until the expected
    hops appear when reading a trace immediately after the request."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    return core._run(core.controller.call("get_trace", {"trace_id": trace_id}))


def list_traces(limit: int = 100, q: str = "") -> list[dict]:
    """Recent traces: [{trace_id, name, start, dur, spans, workers}];
    ``q`` filters by trace id prefix or root-span name substring. Same
    staleness window as get_trace: remote workers' spans land on their
    reporter tick, so a just-finished request may list incomplete."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    return core._run(core.controller.call("list_traces", {"limit": limit, "q": q}))


def _flow_id(task_id: str) -> int:
    """Stable numeric flow-event id from a task id (chrome trace ids are
    uint64; 15 hex chars keeps it comfortably in range)."""
    return int(task_id[:15] or "0", 16)


def export_timeline(path: str, limit: int = 20000) -> int:
    """Write a chrome://tracing-format timeline of task execution across the
    cluster (the `ray timeline` equivalent). Returns the number of trace
    events written.

    Events carrying a trace context additionally emit flow events
    (``ph: "s"`` at submission on the caller's lane, ``ph: "f"`` at
    execution start on the executor's lane) so one request renders as a
    connected arrow chain across processes, and ``span`` events (the Span
    API) render as their own slices."""
    return render_timeline(get_task_events(limit), path)


def render_timeline(events: list[dict], path: str) -> int:
    """THE event-list -> chrome-trace renderer: `export_timeline` (live
    cluster), flight-recorder dumps (obs/flight.export_dump_timeline), and
    `raytpu trace export` all render through this one path, so a black-box
    post-mortem opens in the same tooling as a live timeline."""
    trace: list[dict] = []
    open_spans: dict[tuple, dict] = {}  # (worker, task_id) -> start event
    for ev in events:
        kind = ev.get("kind", "")
        worker = ev.get("worker", "?")
        ts_us = ev["ts"] * 1e6
        if kind == "span":
            trace.append({
                "name": ev.get("name", "span"),
                "cat": "span",
                "ph": "X",
                "ts": ts_us,
                "dur": max(1.0, ev.get("dur", 0.0) * 1e6),
                "pid": worker,
                "tid": "span",
                "args": {
                    "trace_id": ev.get("trace_id"),
                    "span_id": ev.get("span_id"),
                    "parent_id": ev.get("parent_id"),
                    **(ev.get("attrs") or {}),
                },
            })
        elif kind == "task_exec_start":
            open_spans[(worker, ev.get("task_id"))] = ev
            if ev.get("trace_id"):
                # Flow arrival: binds this execution to its submission arrow.
                trace.append({
                    "name": "task_flow",
                    "cat": "flow",
                    "ph": "f",
                    "bp": "e",
                    "id": _flow_id(ev.get("task_id", "")),
                    "ts": ts_us,
                    "pid": worker,
                    "tid": "exec",
                    "args": {"trace_id": ev["trace_id"]},
                })
        elif kind == "task_exec_end":
            start = open_spans.pop((worker, ev.get("task_id")), None)
            if start is not None:
                args = {"task_id": ev.get("task_id")}
                if start.get("trace_id"):
                    args.update(
                        trace_id=start["trace_id"],
                        span_id=start.get("span_id"),
                        parent_id=start.get("parent_id"),
                    )
                trace.append({
                    "name": start.get("fn") or ev.get("task_id", "task")[:8],
                    "cat": "task",
                    "ph": "X",
                    "ts": start["ts"] * 1e6,
                    "dur": max(1.0, ts_us - start["ts"] * 1e6),
                    "pid": worker,
                    "tid": "exec",
                    "args": args,
                })
        elif kind in ("task_submitted", "object_recovery", "task_finished"):
            if kind == "task_submitted" and ev.get("trace_id"):
                # Flow departure: the submission side of the cross-process arrow.
                trace.append({
                    "name": "task_flow",
                    "cat": "flow",
                    "ph": "s",
                    "id": _flow_id(ev.get("task_id", "")),
                    "ts": ts_us,
                    "pid": worker,
                    "tid": "control",
                    "args": {"trace_id": ev["trace_id"]},
                })
            trace.append({
                "name": kind,
                "cat": "control",
                "ph": "i",
                "s": "p",
                "ts": ts_us,
                "pid": worker,
                "tid": "control",
                "args": {k: v for k, v in ev.items() if k not in ("ts", "kind", "worker")},
            })
        else:
            # Everything else (chaos injections, qos shed/expiry, conn
            # lifecycle, lag spikes — the flight recorder's extra feeds)
            # renders as an instant tick so dumps lose nothing.
            trace.append({
                "name": kind or "event",
                "cat": "event",
                "ph": "i",
                "s": "p",
                "ts": ts_us,
                "pid": worker,
                "tid": "events",
                "args": {k: v for k, v in ev.items() if k not in ("ts", "kind", "worker")},
            })
    with open(path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
    return len(trace)


@contextlib.contextmanager
def profile_tpu(logdir: str):
    """Capture a torch.profiler device trace (a Chrome trace under
    ``logdir``; the reference captures a JAX XPlane trace here) around a
    block of device work; yields the ``obs.profiler.DeviceTrace``.

    Routed through the obs.profiler capture-session API (ONE entry point
    for device profiling: session-bounded, visible in profiler status).
    On a host without a CUDA device this raises
    obs.profiler.DeviceProfilerUnavailable at entry — a typed, named
    refusal instead of a silent empty trace."""
    from ray_tpu_torch.obs import profiler as _profiler

    with _profiler.device_capture(logdir) as trace:
        yield trace


def profile_server(port: int = 9012):
    """Start the device-profiler listener for on-demand remote capture
    (``obs.profiler.device_server``: one request runs one bounded capture in
    this process). Same typed-and-loud gate as profile_tpu."""
    from ray_tpu_torch.obs import profiler as _profiler

    return _profiler.device_server(port)
