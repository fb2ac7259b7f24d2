"""Request context: priority class, tenant, absolute deadline — the unit the
QoS plane propagates end to end.

Reference gap this fills: Ray Serve bounds replicas with
``max_ongoing_requests`` and queues excess in the router, but a request's
``timeout_s`` dies at the first hop and nothing distinguishes an interactive
user from a batch backfill — under sustained overload every class degrades
together. Here every serve request carries a :class:`RequestContext`:

* ``priority``: ``interactive`` > ``batch`` > ``best_effort`` — strict
  priority between classes at every queue, and the shedding order under
  overload (lowest class sheds first).
* ``tenant``: fair-queuing key — deficit-round-robin across tenants within
  a class so one tenant's flood cannot starve another's trickle.
* ``deadline``: ABSOLUTE time on the shared ``tracing.now()`` clock, derived
  once from the client's ``timeout_s`` at ingress. Every hop (proxy queue,
  handle admission, worker dispatch, replica inbox) drops already-expired
  requests with a typed :class:`DeadlineExceeded` — counted
  (``serve.request.expired_total{hop}``), never silently — so a request
  whose caller gave up stops consuming capacity instead of burning a
  replica slot to completion.

In-process the context rides a contextvar (one ``ContextVar.get`` on the
quiet path); cross-process it rides the task-spec / lean-frame mechanism as
a compact wire tuple (``TaskSpec.qos_ctx`` / the ``"qc"`` payload key) —
the same scheme as the tracing context, no wire-version bump.
"""
from __future__ import annotations

import contextvars
import os
import threading
from dataclasses import dataclass, replace
from typing import Optional

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

# Priority classes, strict rank order (0 = most important). The rank is the
# wire encoding; names are the API and the metric tag.
PRIORITIES = ("interactive", "batch", "best_effort")
_RANK = {name: i for i, name in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "interactive"
DEFAULT_TENANT = "default"


class DeadlineExceeded(TimeoutError):
    """A request's absolute deadline passed before (or while) a hop could
    serve it. Subclasses TimeoutError so callers that already handle
    timeouts keep working; picklable, so it crosses the wire typed (rt.get
    re-raises the cause of a RemoteError)."""


class RequestCancelled(RuntimeError):
    """The client abandoned this request (timeout/disconnect) and the
    cancellation reached the executing side."""


@dataclass(frozen=True)
class RequestContext:
    """Immutable per-request QoS context. ``deadline`` is absolute on the
    ``tracing.now()`` clock (None = no deadline); ``rid`` identifies the
    request for cancel propagation (minted by the serve handle)."""

    priority: str = DEFAULT_PRIORITY
    tenant: str = DEFAULT_TENANT
    deadline: Optional[float] = None
    rid: str = ""

    @property
    def rank(self) -> int:
        return _RANK.get(self.priority, 0)

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the deadline (may be negative), or None."""
        if self.deadline is None:
            return None
        return self.deadline - (_tracing.now() if now is None else now)

    def expired(self, now: Optional[float] = None) -> bool:
        rem = self.remaining(now)
        return rem is not None and rem <= 0.0


# The active context of this thread/task, or None (the overwhelmingly common
# case — the quiet path pays one ContextVar.get).
_ctx: contextvars.ContextVar[Optional[RequestContext]] = contextvars.ContextVar(
    "raytpu_qos_ctx", default=None
)

# Replica-side cancellation: the executing request's cancel event (set by
# Replica.cancel_request when the client gives up). Separate var so plain
# contexts never allocate an Event.
_cancel_ev: contextvars.ContextVar[Optional[threading.Event]] = contextvars.ContextVar(
    "raytpu_qos_cancel", default=None
)

# -- observability (module-level: every process that expires/starts requests
# shares these series through its own reporter) ------------------------------
_expired_total = _metrics.Counter(
    "serve.request.expired_total",
    "requests dropped because their deadline passed before the hop could serve them",
    tag_keys=("hop", "class"),
)
# Tripwire for the core invariant "no deadline-expired request ever begins
# executing": incremented ONLY if user code is about to run with a deadline
# that had already passed at the hop's own gate timestamp — i.e. a gate was
# bypassed. Asserted zero by the overload_storm chaos scenario.
_expired_exec_total = _metrics.Counter(
    "qos.exec.expired_total",
    "requests that began executing despite an already-expired deadline (gate bypass tripwire)",
    tag_keys=("hop",),
)


def current() -> Optional[RequestContext]:
    """The active RequestContext of this thread/task, or None."""
    return _ctx.get()


def current_wire() -> Optional[tuple]:
    """The active context as its compact wire tuple (what cross-process
    submission attaches to specs), or None. One ContextVar.get when unset."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    return (ctx.rank, ctx.tenant, ctx.deadline, ctx.rid)


def to_wire(ctx: RequestContext) -> tuple:
    return (ctx.rank, ctx.tenant, ctx.deadline, ctx.rid)


def from_wire(wire: Optional[tuple]) -> Optional[RequestContext]:
    if wire is None:
        return None
    rank, tenant, deadline, rid = wire
    rank = int(rank)
    return RequestContext(
        priority=PRIORITIES[rank] if 0 <= rank < len(PRIORITIES) else DEFAULT_PRIORITY,
        tenant=tenant or DEFAULT_TENANT,
        deadline=deadline,
        rid=rid or "",
    )


def activate(wire: Optional[tuple]):
    """Install a propagated wire context as this thread's active context;
    returns a token for :func:`deactivate`. None -> no-op (None token)."""
    if wire is None:
        return None
    return _ctx.set(from_wire(wire))


def deactivate(token) -> None:
    if token is not None:
        _ctx.reset(token)


def suspend():
    """Mask the active RequestContext (returns a token for
    :func:`deactivate`): control-plane submissions — cancel notifications,
    membership refreshes — must NOT inherit the data request's deadline or
    class, or an expired request's own cancel gets dropped (and re-counted)
    at the worker gate."""
    if _ctx.get() is None:
        return None
    return _ctx.set(None)


class request_context:
    """Context manager installing a RequestContext for the calling thread:

        with qos.request_context(priority="batch", tenant="team-a", timeout_s=5):
            handle.remote(...).result()

    ``timeout_s`` converts to an absolute deadline ONCE, here, on the shared
    clock; downstream hops compare against it, they never re-derive. An
    explicit ``deadline`` wins over ``timeout_s``. Nested contexts inherit
    missing fields from the enclosing one."""

    def __init__(self, priority: Optional[str] = None, tenant: Optional[str] = None,
                 timeout_s: Optional[float] = None, deadline: Optional[float] = None):
        if priority is not None and priority not in _RANK:
            raise ValueError(f"unknown priority {priority!r} (one of {PRIORITIES})")
        self._priority = priority
        self._tenant = tenant
        if deadline is None and timeout_s is not None:
            deadline = _tracing.now() + float(timeout_s)
        self._deadline = deadline
        self._token = None

    def __enter__(self) -> RequestContext:
        base = _ctx.get() or RequestContext()
        ctx = replace(
            base,
            priority=self._priority if self._priority is not None else base.priority,
            tenant=self._tenant if self._tenant is not None else base.tenant,
            deadline=self._deadline if self._deadline is not None else base.deadline,
        )
        self._token = _ctx.set(ctx)
        return ctx

    def __exit__(self, *exc) -> bool:
        _ctx.reset(self._token)
        return False


def mint_rid() -> str:
    """Request id for cancel propagation (handle-minted, rides the wire)."""
    return os.urandom(8).hex()


# THE upper bound on any client-supplied timeout, shared by every ingress
# lane (HTTP headers, binary-RPC fields, OpenAI body keys) — one place to
# change, no per-lane drift.
MAX_CLIENT_TIMEOUT_S = 600.0


def parse_timeout_s(value) -> float:
    """Parse a client-supplied timeout into seconds: 0.0 for absent /
    unparsable / non-positive (meaning "no opinion"), else capped at
    :data:`MAX_CLIENT_TIMEOUT_S`."""
    try:
        t = float(value or 0.0)
    except (TypeError, ValueError):
        return 0.0
    return min(t, MAX_CLIENT_TIMEOUT_S) if t > 0 else 0.0


def raise_expired(hop: str, detail: str = "") -> None:
    """THE expiry exit: count (``serve.request.expired_total{hop,class}``),
    drop a point event onto the active trace, tee into the flight recorder
    (whose deadline-storm detector dumps the ring when expiries burst), raise
    typed. Every hop that drops an expired request goes through here — no
    silent expiry (machine-enforced by graftlint rule ``counted-sheds``)."""
    ctx = _ctx.get()
    klass = ctx.priority if ctx is not None else DEFAULT_PRIORITY
    _expired_total.inc(tags={"hop": hop, "class": klass})
    _tracing.event("qos.expired", hop=hop)
    from ray_tpu_torch.obs import flight as _flight

    _flight.record("qos.expired", hop=hop, cls=klass, detail=detail)
    _flight.note_expiry()
    raise DeadlineExceeded(
        f"request deadline exceeded at hop {hop!r}{': ' + detail if detail else ''}"
    )


def check_deadline(hop: str, ctx: Optional[RequestContext] = None,
                   now: Optional[float] = None, detail: str = "") -> Optional[float]:
    """Drop-expired gate for one hop. Uses the given (or active) context;
    returns the gate's own timestamp when a deadline exists, or None when
    there is nothing to enforce."""
    ctx = _ctx.get() if ctx is None else ctx
    if ctx is None or ctx.deadline is None:
        return None
    now = _tracing.now() if now is None else now
    if now >= ctx.deadline:
        raise_expired(hop, detail)
    return now


# How stale a deadline must be AT USER-CODE ENTRY before the tripwire fires.
# A hop's gate runs microseconds before the invoke; even heavy GIL/thread
# scheduling jitter between the two stays far below this. A BYPASSED gate
# (a request that queued past its deadline and was executed without a
# re-check) shows up hundreds of ms stale — exactly what this catches.
EXEC_EXPIRY_GRACE_S = 0.05


def mark_exec_start(hop: str, ctx: Optional[RequestContext] = None) -> None:
    """Tripwire for "no expired request ever begins executing": called at
    the moment user code is invoked, against the ACTIVE context's deadline
    with :data:`EXEC_EXPIRY_GRACE_S` of slack for gate->invoke scheduling
    jitter. Counts qos.exec.expired_total — a nonzero value means some hop
    let a long-expired request through to user code."""
    ctx = _ctx.get() if ctx is None else ctx
    if ctx is None or ctx.deadline is None:
        return
    if _tracing.now() - ctx.deadline > EXEC_EXPIRY_GRACE_S:
        _expired_exec_total.inc(tags={"hop": hop})


# -- cooperative cancellation ------------------------------------------------

def set_cancel_event(ev: Optional[threading.Event]):
    """Install the executing request's cancel event (replica side); returns
    a token for :func:`reset_cancel_event`."""
    return _cancel_ev.set(ev)


def reset_cancel_event(token) -> None:
    if token is not None:
        _cancel_ev.reset(token)


def cancel_requested() -> bool:
    """True when the client abandoned the request this thread is executing.
    Long-running user code (LLM generate loops, pollers) checks this to
    free replica capacity early instead of computing for a departed caller."""
    ev = _cancel_ev.get()
    return ev is not None and ev.is_set()


def cancel_event() -> Optional[threading.Event]:
    """The executing request's cancel event, for code that wants to wait on
    it directly. None when no cancellable request is active."""
    return _cancel_ev.get()
