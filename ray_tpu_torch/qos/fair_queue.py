"""Weighted fair wait-queue: strict priority between classes, deficit-
round-robin across tenants within a class, FIFO within a tenant.

This replaces the serve handle's unordered ``Condition.notify`` scrum: with
a bare condition, whichever waiter thread the OS wakes first wins the freed
replica slot — a burst can starve an old waiter indefinitely, and priority
classes are impossible. Here waiters park on their OWN event and a grant
loop (run by whoever frees capacity, under the owner's lock) hands slots
out in policy order.

The queue itself is NOT thread-safe: the owner (``_ReplicaSet``) already
serializes all router state under one lock, and this structure is only ever
touched under it. Waiter removal (deadline expiry, caller abandonment) is
O(1): the waiter is flagged and lazily skipped at pop time.

DRR mechanics (Shreedhar & Varghese): each class keeps an insertion-ordered
ring of active tenants with a deficit counter. Visiting the head tenant
recharges its deficit by ``quantum * weight``; a tenant with deficit >= 1
serves one waiter (cost 1) and pays for it; an exhausted tenant rotates to
the back. With unit costs and weight 1 this degrades to round-robin —
two tenants with wildly skewed offered load get ~equal admitted throughput,
which is the fairness contract the QoS tests pin.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ray_tpu_torch.qos.context import PRIORITIES


class Waiter:
    """One queued admission request. The owning thread parks on ``event``;
    the grant loop fills ``admitted`` (or sets ``expired``) before setting
    it. ``removed`` is the lazy-deletion flag (set by the waiter's own
    thread on timeout/abandon; skipped at pop)."""

    __slots__ = ("rank", "tenant", "affinity", "deadline", "enqueued_at",
                 "event", "admitted", "expired", "removed")

    def __init__(self, rank: int, tenant: str, affinity: str = "",
                 deadline: Optional[float] = None, enqueued_at: float = 0.0):
        self.rank = rank
        self.tenant = tenant
        self.affinity = affinity
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.event = threading.Event()
        self.admitted = None  # (replica_name, handle) once granted
        self.expired = False
        self.removed = False


class _ClassQueue:
    """One priority class: per-tenant FIFOs + the DRR ring."""

    __slots__ = ("tenants", "ring", "deficit", "live")

    def __init__(self):
        self.tenants: dict[str, deque] = {}
        self.ring: deque[str] = deque()
        self.deficit: dict[str, float] = {}
        self.live = 0  # waiters not yet popped/removed (ring bookkeeping aside)


class FairWaitQueue:
    """See module docstring. ``weights`` maps tenant -> relative DRR weight
    (default 1.0; a weight-2 tenant is granted twice per round)."""

    def __init__(self, quantum: float = 1.0, weights: Optional[dict] = None):
        self.quantum = quantum
        self.weights = dict(weights or {})
        self._classes = [_ClassQueue() for _ in PRIORITIES]
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def empty(self) -> bool:
        return self._live == 0

    def push(self, w: Waiter) -> None:
        c = self._classes[w.rank]
        q = c.tenants.get(w.tenant)
        if q is None:
            q = c.tenants[w.tenant] = deque()
            c.ring.append(w.tenant)
            c.deficit.setdefault(w.tenant, 0.0)
        q.append(w)
        c.live += 1
        self._live += 1

    def requeue_front(self, w: Waiter) -> None:
        """Put a just-popped waiter back at the HEAD of its tenant FIFO
        (pop_next already decremented the live counts). Tail re-insertion
        would silently break the FIFO-within-tenant contract."""
        c = self._classes[w.rank]
        q = c.tenants.get(w.tenant)
        if q is None:
            q = c.tenants[w.tenant] = deque()
            c.ring.append(w.tenant)
            c.deficit.setdefault(w.tenant, 0.0)
        q.appendleft(w)
        c.live += 1
        self._live += 1

    def discard(self, w: Waiter) -> None:
        """O(1) removal: flag the waiter; pop_next skips it. Caller (the
        waiter's own thread, on timeout/abandon) sets the reason flags."""
        if not w.removed:
            w.removed = True
            self._classes[w.rank].live -= 1
            self._live -= 1

    def pop_next(self) -> Optional[Waiter]:
        """Next waiter per policy, or None when empty. Strict priority:
        class 0 drains before class 1 is even looked at."""
        for c in self._classes:
            if c.live <= 0:
                continue
            w = self._pop_class(c)
            if w is not None:
                self._live -= 1
                return w
        return None

    def _pop_class(self, c: _ClassQueue) -> Optional[Waiter]:
        # Terminates: every full rotation recharges every live tenant by at
        # least one quantum, so some tenant with a waiter reaches deficit>=1
        # within two rotations of the (bounded) ring.
        while c.ring:
            tenant = c.ring[0]
            q = c.tenants.get(tenant)
            # Drop flagged waiters at the head lazily (their live counts
            # were already decremented by discard()).
            while q and q[0].removed:
                q.popleft()
            if not q:
                c.ring.popleft()
                c.tenants.pop(tenant, None)
                c.deficit.pop(tenant, None)
                continue
            if c.deficit.get(tenant, 0.0) >= 1.0:
                c.deficit[tenant] -= 1.0
                w = q.popleft()
                c.live -= 1
                return w
            # Head tenant out of deficit: recharge and rotate to the back.
            c.deficit[tenant] = c.deficit.get(tenant, 0.0) + self.quantum * self.weights.get(tenant, 1.0)
            c.ring.rotate(-1)
        return None

    def depth(self, rank: Optional[int] = None) -> int:
        if rank is None:
            return self._live
        return max(0, self._classes[rank].live)
