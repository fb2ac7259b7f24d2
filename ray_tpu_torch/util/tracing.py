"""Distributed-tracing span API: trace contexts, spans and point events.

Counterpart of the span API of ``ray_tpu/util/tracing.py``, stdlib only. A
trace context ``(trace_id, span_id)`` rides a contextvar inside one process;
``span`` opens a root (or a child of the active context), ``child_span`` is
a span only under an active trace and a free no-op otherwise, ``event``
drops a zero-duration tick onto the active trace.

Cost contract (the reference's): with no span active the only per-call cost
on the hot path is one ``ContextVar.get`` returning None; ``child_span`` is
a no-op then.

Finished spans go to ``_record_event``, which hands them to this process's
core worker in the reference and drops them when there is none. The port
has no runtime yet, so every event is dropped here; the task-event export
(``get_task_events``, ``get_trace``, ``list_traces``, the timeline and the
profiler hooks) comes with the runtime.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Optional

# The active trace context of this thread/task: (trace_id, span_id) or None.
_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "raytpu_trace_ctx", default=None
)


def now() -> float:
    """THE event/span timestamp clock: spans, events and QoS deadlines all
    stamp through here, so they land on one comparable timeline."""
    return time.time()


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def current_trace() -> Optional[tuple]:
    """The active (trace_id, span_id) of this thread/task, or None."""
    return _ctx.get()


def activate(ctx: Optional[tuple]):
    """Install a propagated (trace_id, span_id) as this thread's active
    context; returns a token for ``deactivate``. None -> no-op (None token)."""
    if ctx is None:
        return None
    return _ctx.set((ctx[0], ctx[1]))


def deactivate(token):
    if token is not None:
        _ctx.reset(token)


def _record_event(ev: dict):
    """Where a finished span or point event goes. With no core worker to
    buffer it (the port has no runtime yet), the event is dropped, as the
    reference drops it in a process without one."""


class Span:
    """One timed span. Context manager; re-entrant use is NOT supported
    (create a new Span per block). On exit records a single ``span`` event
    carrying (trace_id, span_id, parent_id, name, start, dur)."""

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
    """Record a point event (zero-duration span) onto the ACTIVE trace.
    Free no-op when no trace is active."""
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
    form internal subsystems (the LLM engine and server) use so untraced
    hot paths pay a single contextvar read."""
    if _ctx.get() is None:
        return contextlib.nullcontext()
    return Span(name, attrs or None)
