"""QoS request context: deadline, priority class, tenant and cooperative
cancellation, in-process.

Counterpart of ``ray_tpu.qos``'s context API (``context.py``), stdlib only.
The serving surface reads it: ``OpenAIServer`` maps a request's
``priority`` / ``tenant`` / ``timeout_s`` into a :class:`RequestContext`,
and ``LLMServer.generate`` caps its wait at the deadline and aborts the
engine request when the deadline passes or the caller's cancel event is
set. The fair wait queue and the admission controller belong to serve and
come with the runtime.

Usage::

    from ray_tpu_torch import qos
    with qos.request_context(priority="batch", tenant="team-a", timeout_s=5):
        server.generate(tokens)
"""
from ray_tpu_torch.qos.context import (
    DEFAULT_PRIORITY,
    DEFAULT_TENANT,
    MAX_CLIENT_TIMEOUT_S,
    PRIORITIES,
    DeadlineExceeded,
    RequestCancelled,
    RequestContext,
    activate,
    cancel_event,
    cancel_requested,
    check_deadline,
    current,
    current_wire,
    deactivate,
    from_wire,
    mark_exec_start,
    mint_rid,
    parse_timeout_s,
    raise_expired,
    request_context,
    reset_cancel_event,
    set_cancel_event,
    suspend,
    to_wire,
)

__all__ = [
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "DeadlineExceeded",
    "MAX_CLIENT_TIMEOUT_S",
    "PRIORITIES",
    "RequestCancelled",
    "RequestContext",
    "activate",
    "cancel_event",
    "cancel_requested",
    "check_deadline",
    "current",
    "current_wire",
    "deactivate",
    "from_wire",
    "mark_exec_start",
    "mint_rid",
    "parse_timeout_s",
    "raise_expired",
    "request_context",
    "reset_cancel_event",
    "set_cancel_event",
    "suspend",
    "to_wire",
]
