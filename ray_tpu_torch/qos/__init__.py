"""QoS plane: deadline propagation, priority classes, per-tenant fair
queuing, and adaptive load shedding — end to end.

The serving path's overload story (what the reference's serve stack lacks):

* :class:`RequestContext` (``priority`` | ``tenant`` | absolute
  ``deadline``) carried by contextvar in-process and riding the task-spec /
  lean-frame mechanism cross-process (``context.py``);
* deadline enforcement at every hop — proxy HTTP queue, handle admission
  queue, worker dispatch, replica inbox — each dropping already-expired
  requests with a typed :class:`DeadlineExceeded`, counted on
  ``serve.request.expired_total{hop}``, and cancel propagation so a caller
  that gave up frees its replica slot (``cancel_requested()``);
* :class:`FairWaitQueue` — strict priority between classes, deficit-round-
  robin across tenants within a class, FIFO within a tenant — the serve
  handle's admission queue (``fair_queue.py``);
* :class:`AdmissionController` — AIMD concurrency limit driven by observed
  queue delay (CoDel-style), shedding ``best_effort``/``batch`` first with
  ``429 + Retry-After`` at the proxy (``admission.py``).

Usage (client side)::

    from ray_tpu_torch import qos
    with qos.request_context(priority="batch", tenant="team-a", timeout_s=5):
        handle.remote(payload).result()

or over HTTP: ``x-priority`` / ``x-tenant`` / ``x-request-timeout-s``
headers on any proxied request.
"""
from ray_tpu_torch.qos.admission import AdmissionController
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
from ray_tpu_torch.qos.fair_queue import FairWaitQueue, Waiter

__all__ = [
    "AdmissionController",
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "DeadlineExceeded",
    "MAX_CLIENT_TIMEOUT_S",
    "FairWaitQueue",
    "PRIORITIES",
    "RequestCancelled",
    "RequestContext",
    "Waiter",
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
