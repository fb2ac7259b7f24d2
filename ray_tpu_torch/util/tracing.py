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

In-process recording: ``start_recording`` / ``stop_recording`` keep this
process's span events in a bounded list as well, with or without a core
worker (an engine driven in-process has none); the list renders through
``render_timeline``. ``phase`` is the entry point of internal phase spans
(the LLM engine's step and its parts): a Span while recording is on or a
trace is active, and a ``torch.profiler.record_function`` range while
torch's profiler runs, so the phase lies on the device trace's timeline;
with none of the three it costs three reads and returns a shared no-op.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import threading
import time
from typing import Optional

# The active trace context of this thread/task: (trace_id, span_id) or None.
_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "raytpu_trace_ctx", default=None
)

# Process-wide default for auto-root spans (serve proxy ingress): off by
# default so the serving hot path pays nothing unless asked.
_trace_all = os.environ.get("RAYTPU_TRACE", "") in ("1", "true", "on")


# The in-memory sink of span events (start_recording): a list while on,
# appended to under its lock by whichever thread ends a span.
_recording: Optional[list] = None
_recording_limit = 0
_recording_lock = threading.Lock()


def now() -> float:
    """THE event/span timestamp clock. Every producer on the observability
    plane (worker `_event`/`_task_event`, controller `_event`, Span,
    `event()`) stamps through here, so state-index timings and span timings
    land on one comparable timeline — swap the time source in one place,
    never per-emitter.

    It is also torch.profiler's clock: a Kineto Chrome trace's event ``ts``
    (microseconds) plus its ``baseTimeNanoseconds`` / 1e3 is this clock in
    microseconds, so spans stamped here line up with a device trace."""
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


def start_recording(limit: int = 100_000) -> None:
    """Keeps this process's span events in memory until ``stop_recording``
    (at most ``limit``; later ones are not kept), besides shipping them to
    the core worker when there is one. Starting again discards what was
    kept."""
    global _recording, _recording_limit
    _recording_limit = int(limit)
    _recording = []


def stop_recording() -> list[dict]:
    """Stops the in-memory recording and returns its span events in the
    order they were recorded, each when it ended (``{"kind": "span", "name",
    "trace_id", "span_id", "parent_id", "ts", "dur", "attrs"?}``, times on
    ``now()``'s clock): the list ``render_timeline`` writes out as a Chrome
    trace."""
    global _recording
    out, _recording = _recording, None
    return out or []


def _record_event(ev: dict):
    """Append a span event to this process's task-event buffer (ships to the
    controller with the metrics reporter) and, while recording, to the
    in-memory list. No core worker and no recording -> dropped."""
    buf = _recording
    if buf is not None:
        with _recording_lock:
            if len(buf) < _recording_limit:
                buf.append({"kind": "span", **ev})
    # A core worker exists only once the runtime's api module is loaded:
    # looked up, not imported, so in-process recording pulls in no runtime.
    api = sys.modules.get("ray_tpu_torch.core.api")
    core = getattr(api, "_global_worker", None)
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


def request_trace() -> Optional[tuple]:
    """The (trace_id, parent span id) that a unit of work started now (a
    request queued for another thread) should record its spans under: the
    active trace, else a fresh trace id while recording, else None (record
    nothing)."""
    ctx = _ctx.get()
    if ctx is not None:
        return ctx
    return (new_trace_id(), "") if _recording is not None else None


def record_span(name: str, trace: tuple, start: float, end: float, **attrs) -> None:
    """Records a span measured elsewhere (``start``/``end`` on ``now()``'s
    clock) under ``trace``, a ``request_trace()`` value."""
    ev = {
        "name": name,
        "trace_id": trace[0],
        "span_id": new_span_id(),
        "parent_id": trace[1],
        "ts": start,
        "dur": end - start,
    }
    if attrs:
        ev["attrs"] = attrs
    _record_event(ev)


def _profiler_on() -> bool:
    """Whether torch's profiler is running in this process (read without
    importing torch: the flag lives in torch.autograd.profiler)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class _NoPhase:
    """The shared no-op ``phase`` returns when nothing would record it."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_PHASE = _NoPhase()


class _Phase:
    __slots__ = ("_span", "_range")

    def __init__(self, name: str, attrs: dict, span: bool, profiled: bool):
        self._span = Span(name, attrs) if span else None
        if profiled:
            import torch

            self._range = torch.autograd.profiler.record_function(name)
        else:
            self._range = None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._span is not None:
            self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False

    def set(self, **attrs):
        """Attributes known only once the phase's work is done."""
        if self._span is not None:
            self._span.attrs.update(attrs)


def phase(name: str, **attrs):
    """An internal phase (not tied to one request): a Span, child of the
    active trace or a root while recording, and a ``record_function`` range
    while torch's profiler runs. With neither recording, a trace nor the
    profiler, a shared no-op. ``set(**attrs)`` on what it yields adds
    attributes before the span closes."""
    span = _recording is not None or _ctx.get() is not None
    profiled = _profiler_on()
    if not (span or profiled):
        return _NO_PHASE
    return _Phase(name, attrs, span, profiled)


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
