"""@serve.batch: transparent request batching inside a replica.

Role-equivalent to the reference's batching decorator
(python/ray/serve/batching.py — _BatchQueue collecting
concurrent calls into lists up to max_batch_size / batch_wait_timeout_s).
Redesigned for the thread-pool replica execution model: callers block on a
per-call Future; the first caller in a window becomes the batch leader,
waits out the window, runs the wrapped function once on the collected list,
and fans results back out.
"""
from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future
from typing import Callable


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.pending: list[tuple[object, Future]] = []
        self.leader_active = False

    def submit(self, self_obj, item):
        fut: Future = Future()
        with self.lock:
            self.pending.append((item, fut))
            lead = not self.leader_active
            if lead:
                self.leader_active = True
            else:
                self.cond.notify_all()
        if lead:
            self._lead(self_obj)
        return fut.result()

    def _lead(self, self_obj):
        deadline = time.time() + self.timeout_s
        with self.lock:
            while len(self.pending) < self.max_batch_size:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self.cond.wait(timeout=remaining)
            batch = self.pending[: self.max_batch_size]
            self.pending = self.pending[self.max_batch_size :]
            self.leader_active = bool(self.pending)
        # Someone must lead any stragglers that arrived after our cut.
        if self.leader_active:
            threading.Thread(target=self._lead, args=(self_obj,), daemon=True).start()
        items = [it for it, _ in batch]
        try:
            results = self.fn(self_obj, items) if self_obj is not None else self.fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results for {len(items)} inputs"
                )
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


# Queue state lives here (keyed by bound instance + function), NOT in the
# decorator's closure: decorated classes are cloudpickled into replicas, and
# closure cells (or captured globals) holding locks would make them
# unpicklable. The wrapper reaches this registry via a runtime import so the
# pickled function carries no lock-bearing state.
_QUEUES: dict[tuple, _BatchQueue] = {}
_QUEUES_LOCK = threading.Lock()


def _get_queue(key: tuple, fn: Callable, max_batch_size: int, timeout_s: float) -> _BatchQueue:
    with _QUEUES_LOCK:
        q = _QUEUES.get(key)
        if q is None:
            q = _QUEUES[key] = _BatchQueue(fn, max_batch_size, timeout_s)
        return q


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01):
    """Decorator: single-item calls are executed as batched list calls."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args):
            from ray_tpu_torch.serve import batching as _b

            if len(args) == 2:
                self_obj, item = args
            elif len(args) == 1:
                self_obj, item = None, args[0]
            else:
                raise TypeError("@serve.batch methods take exactly one request argument")
            key = (id(self_obj), fn.__qualname__)
            q = _b._get_queue(key, fn, max_batch_size, batch_wait_timeout_s)
            return q.submit(self_obj, item)

        inner._batch_queue_factory = True
        return inner

    if _fn is not None:
        return wrap(_fn)
    return wrap
