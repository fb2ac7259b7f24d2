"""Host->device infeed: batches copied to the GPU ahead of the step.

Counterpart of ``ray_tpu/data/infeed.py`` (the reference's per-worker
prefetching iterator: the train loop overlaps the H2D copy of batch k+1 with
the step on batch k; SURVEY §7.7 "double-buffered device_put"). The
reference relies on ``jax.device_put`` being asynchronous; here the copy is
made asynchronous by hand: each batch is staged in pinned host memory, then
copied with ``non_blocking=True`` on a side CUDA stream, ``size`` copies in
flight. A batch is handed over only after the consumer's current stream
waits on its copy's event, and each of its tensors is marked used on that
stream (``record_stream``), so the caching allocator does not give its
memory back to the side stream while the consumer's kernels still read it.

The reference's ``sharding`` (mesh placement) becomes ``device``: one card.
Placement over a mesh waits for the port's parallelism (ROADMAP Queue 1
item 6).
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional


def prefetch_to_device(batches: Iterator, *, size: int = 2, device=None,
                       transform: Optional[Callable] = None) -> Iterator:
    """Yield device-resident batches, keeping `size` transfers in flight.

    - batches: host-side batch iterator (dicts, lists or tuples of ndarrays,
      torch tensors or scalars).
    - device: None is the GPU (raising when none is visible); pass
      ``device="cpu"`` for the CPU, where each leaf becomes a torch tensor
      with no copy in flight.
    - transform: optional host-side fn applied before the transfer
      (e.g. dtype casts, reshapes).
    """
    import torch

    from ray_tpu_torch.models.transformer import resolve_device

    dev = torch.device(resolve_device(device, "prefetch_to_device"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    queue: collections.deque = collections.deque()

    def put(batch):
        if transform is not None:
            batch = transform(batch)
        if side is None:
            return _tree_map(lambda x: _as_tensor(x).to(dev), batch), None, None
        # Stage on the host first (pageable -> pinned), then enqueue the H2D
        # copies on the side stream; the event marks their end.
        staged = _tree_map(_pinned, batch)
        with torch.cuda.stream(side):
            out = _tree_map(lambda h: h.to(dev, non_blocking=True), staged)
            done = torch.cuda.Event()
            done.record(side)
        return out, done, staged  # the pinned staging lives until hand-over

    def hand_over(item):
        out, done, _staged = item
        if done is None:
            return out
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        _tree_map(lambda t: t.record_stream(consumer), out)
        return out

    for batch in batches:
        queue.append(put(batch))
        if len(queue) >= size:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())


def _as_tensor(x):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # zero-copy reads hand out read-only arrays
    return torch.as_tensor(x)


def _pinned(x):
    """One copy of a host leaf into pinned memory (a CUDA leaf stays)."""
    import torch

    t = _as_tensor(x)
    if t.device.type != "cpu" or t.is_pinned():
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
