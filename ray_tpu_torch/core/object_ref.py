"""ObjectRef: a first-class future naming a value owned by some worker.

Mirrors the reference's ObjectRef + ownership model
(src/ray/core_worker/reference_counter.h:44 — the owner is the
worker that created the value; borrowers resolve and refcount through it).
The ref carries its owner's RPC address so any holder can resolve it without a
central directory lookup (the directory is a fallback, as in the reference's
OwnershipObjectDirectory).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ray_tpu_torch.core.ids import ObjectID

# Set by the core worker at init; used by ObjectRef.__del__ / get.
_ref_removed_hook: Optional[Callable] = None
_ref_created_hook: Optional[Callable] = None


def set_ref_hooks(created: Callable | None, removed: Callable | None):
    global _ref_created_hook, _ref_removed_hook
    _ref_created_hook = created
    _ref_removed_hook = removed


class ObjectRef:
    __slots__ = ("id", "owner_addr", "size_hint", "_registered", "__weakref__")

    def __init__(self, oid: ObjectID, owner_addr: str, size_hint: int = 0, _register: bool = True):
        self.id = oid
        self.owner_addr = owner_addr
        self.size_hint = size_hint
        self._registered = False
        if _register and _ref_created_hook is not None:
            _ref_created_hook(self)
            self._registered = True

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def __reduce__(self):
        return (_reconstruct_ref, (self.id, self.owner_addr, self.size_hint))

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]}, owner={self.owner_addr})"

    def __del__(self):
        if self._registered and _ref_removed_hook is not None:
            try:
                _ref_removed_hook(self)
            except Exception:
                pass

    # Allow ``await ref`` inside async actors / driver coroutines.
    def __await__(self):
        from ray_tpu_torch.core import api

        return api.get_async(self).__await__()

    def future(self):
        from ray_tpu_torch.core import api

        return api.get_async(self)


def _reconstruct_ref(oid: ObjectID, owner_addr: str, size_hint: int) -> ObjectRef:
    return ObjectRef(oid, owner_addr, size_hint)


class ObjectRefGenerator:
    """Iterator over the streamed returns of a generator task.

    Reference: streaming generators — the executor reports each yielded item
    as its own return object (core_worker.proto ReportGeneratorItemReturns;
    TaskManager streaming-generator returns) and the caller iterates
    ObjectRefs as they arrive, before the task finishes. Items are pushed
    from the IO loop (``_push``); ``__next__`` blocks the consuming thread
    until the next indexed item or end-of-stream. A worker-crash retry
    replays the stream from index 0; ``reserve`` dedups already-seen indices
    so consumers observe each index exactly once.
    """

    def __init__(self, task_id, owner_addr: str):
        import threading

        self.task_id = task_id
        self.owner_addr = owner_addr
        self._cond = threading.Condition()
        self._items: dict[int, ObjectRef] = {}  # arrived, unconsumed
        self._seen: set[int] = set()
        self._next = 0
        self._total: Optional[int] = None
        self._error: Optional[BaseException] = None
        # Consumption-ack hook for backpressured streams (set by the core
        # worker when the producer requests acks).
        self._ack = None
        # Early-close hook (set at submit time): tells the producing worker
        # to stop at its next yield (reference: CancelTask for streaming).
        self._cancel = None
        # Optional arrival callback for async consumers (the serve proxy):
        # invoked after items/finish land so an event loop can wake and
        # drain via poll() instead of parking a thread in __next__.
        self._wakeup = None

    # -- producer side (IO loop) --------------------------------------
    def reserve(self, index: int) -> bool:
        """True if this index is new (caller should register + push)."""
        with self._cond:
            if index in self._seen:
                return False
            self._seen.add(index)
            return True

    def _push(self, index: int, ref: ObjectRef):
        with self._cond:
            self._items[index] = ref
            self._cond.notify_all()
        self._notify_wakeup()

    def _push_many(self, pairs):
        """Absorb one batch frame's refs under a single lock acquisition
        (one notify_all for N items — the owner-side half of the streaming
        fast lane's batching)."""
        with self._cond:
            for index, ref in pairs:
                self._items[index] = ref
            self._cond.notify_all()
        self._notify_wakeup()

    def _finish(self, total: Optional[int] = None, error: BaseException | None = None):
        with self._cond:
            if total is not None:
                self._total = total
            if error is not None:
                # Same contract as rt.get (worker.get_sync): a RemoteError
                # carrying a picklable cause re-raises the TYPED original —
                # a streamed DeadlineExceeded must reach the consumer as
                # DeadlineExceeded, not as a generic RemoteError wrapper.
                cause = getattr(error, "cause", None)
                error = cause if cause is not None else error
                self._error = error
                if self._total is None:
                    # Hand out what already arrived, then raise.
                    self._total = max(self._items, default=-1) + 1
            self._cond.notify_all()
        self._notify_wakeup()

    def _notify_wakeup(self):
        wake = self._wakeup
        if wake is not None:
            try:
                wake()
            except Exception:
                pass  # a dead consumer loop must not poison the producer

    # -- consumer side -------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._next_item(None)

    def next_with_timeout(self, timeout: float) -> ObjectRef:
        return self._next_item(timeout)

    def _next_item(self, timeout) -> ObjectRef:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            while True:
                if self._next in self._items:
                    ref = self._items.pop(self._next)
                    self._next += 1
                    ack, consumed = self._ack, self._next
                    if ack is not None:
                        ack(consumed)
                    return ref
                if self._total is not None and self._next >= self._total:
                    if self._error is not None:
                        raise self._error
                    raise StopIteration
                remaining = None if deadline is None else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError("generator item timeout")
                self._cond.wait(remaining if remaining is not None else 1.0)

    def set_wakeup(self, cb):
        """Register an arrival callback for async consumption (see poll);
        called after every push/finish, outside the lock."""
        self._wakeup = cb
        # Items that landed before registration would otherwise never wake
        # the consumer: fire once so it drains the backlog immediately.
        if cb is not None:
            self._notify_wakeup()

    def poll(self):
        """Non-blocking probe for async consumers: returns one of
        ('item', ObjectRef) — the next indexed item (consumption-acked like
        __next__), ('wait', None) — nothing available yet (await the wakeup
        callback), ('end', None) — exhausted, or ('error', err) — the stream
        failed after handing out everything that arrived."""
        with self._cond:
            if self._next in self._items:
                ref = self._items.pop(self._next)
                self._next += 1
                ack, consumed = self._ack, self._next
                if ack is not None:
                    ack(consumed)
                return ("item", ref)
            if self._total is not None and self._next >= self._total:
                if self._error is not None:
                    return ("error", self._error)
                return ("end", None)
            return ("wait", None)

    def completed(self) -> bool:
        with self._cond:
            return self._total is not None

    def close(self):
        """Stop consuming: best-effort cancellation of the producing task.
        Idempotent; a no-op once the stream has finished."""
        cb, self._cancel = self._cancel, None
        if cb is not None and not self.completed():
            try:
                cb()
            except Exception:
                pass  # core already shut down: nothing to cancel

    def __del__(self):
        self.close()
        # Unconsumed item refs drop their pins through ObjectRef.__del__.
        with self._cond:
            self._items.clear()


class ObjectLostError(Exception):
    pass


class GetTimeoutError(TimeoutError):
    pass
