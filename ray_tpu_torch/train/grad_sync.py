"""Bucketed gradient sync with compute/collective overlap + sharded update.

T3-style overlap (arxiv 2401.16677) on the host collective plane: instead of
one big allreduce after the full backward, the grad pytree packs into
``Config.collective_bucket_bytes`` buckets and each bucket's ring collective
launches the moment the bucket fills — ``push()`` leaves as backward
produces them and the ring transfer of bucket *i* overlaps the packing (and
producing) of bucket *i+1*. The collectives run on the worker IO loop; the
caller thread keeps computing.

Sharded update (arxiv 2004.13336 / ZeRO-1): each bucket is reduce-scattered
instead of allreduced, every rank applies the (elementwise) optimizer only
to its own 1/W shard — so no host ever materializes full optimizer state —
and the updated parameter shards allgather back. Optimizer state per rank
is ``ceil(n/W)`` elements per slot; ``state_bytes()`` exposes the exact
allocation so tests (and operators) can assert the bound.

Determinism contract: the reduction order of an element depends on its ring
chunk (which rank the pipelined partial sum starts at), so re-bucketing can
re-associate floating-point sums at the last-ulp level. With exactly-
representable addends (the integer-valued grads of the byte-identity test)
every bucketing produces bit-identical results; with arbitrary floats the
difference is bounded by normal fp reassociation noise. The optimizer
itself is elementwise, so sharding NEVER changes the update math — only the
grad-sum association can differ.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.util import dtypes as _dt
from ray_tpu_torch.util import metrics as _metrics

_bucket_hist = _metrics.Histogram(
    "collective.bucket.bytes",
    "gradient bucket sizes shipped by the bucketed overlap path",
    boundaries=[2 ** k for k in range(12, 28, 2)],  # 4 KiB .. 64 MiB
    tag_keys=("mode",),
)


def _bucket_bytes_default() -> int:
    """The ADOPTED cluster config's bucket size (bucket cuts must agree
    across ranks; spawned workers only see head-pushed knobs through
    core.config — the PR-8 qos lesson)."""
    from ray_tpu_torch.core import api as _api

    return _api._require_worker().config.collective_bucket_bytes


def _cut_before(cur_bytes: int, cur_dtype, leaf,
                bucket_bytes: int) -> bool:
    """THE bucket-cut rule: close the open bucket before ``leaf`` when it
    would overflow ``bucket_bytes`` or change dtype. This is a wire-level
    contract — every rank must produce identical cuts for the same model
    structure, and BucketedGradSync.push and ShardedOptimizerStep._buckets
    must never drift apart — so both route through this one predicate."""
    return (cur_bytes + _dt.nbytes(leaf) > bucket_bytes
            or _dt.dtype_name(leaf.dtype) != _dt.dtype_name(cur_dtype))


def _tree_flatten(tree):
    """torch's pytree: dicts, lists, tuples and namedtuples are nodes;
    tensors and numpy arrays are leaves (dict leaves in insertion order)."""
    from torch.utils import _pytree

    return _pytree.tree_flatten(tree)


def _tree_unflatten(treedef, leaves):
    from torch.utils import _pytree

    return _pytree.tree_unflatten(leaves, treedef)


def _cast_to(a, name: str):
    """A host array in dtype ``name`` (no copy when it already is)."""
    if _dt.dtype_name(a.dtype) == name:
        return a
    if name == "bfloat16" or _dt.is_tensor(a):
        return _dt.from_float32(_dt.to_float32(a), name)
    return a.astype(name)


def _result_dtype(names: list) -> str:
    """np.concatenate's promotion over a bucket's leaves, by name
    (bfloat16 mixed with anything else promotes to float32)."""
    if len(set(names)) == 1:
        return names[0]
    if "bfloat16" in names:
        return "float32"
    return np.result_type(*names).name


class BucketedGradSync:
    """Streaming bucketed allreduce of a grad pytree.

    Either call :meth:`allreduce` on a whole pytree, or — for real
    backward/collective overlap — :meth:`push` each grad as it is produced
    and :meth:`finish` once backward ends. Buckets are cut on size
    (``bucket_bytes``) and dtype boundaries; each launches its ring
    allreduce immediately. ``quantization="int8"`` ships hops block-
    quantized (fp32 accumulation; results keep the input dtype)."""

    def __init__(self, group_name: str = "default", *,
                 bucket_bytes: Optional[int] = None,
                 quantization: Optional[str] = None,
                 average: bool = True,
                 timeout: float = 120.0):
        self.group_name = group_name
        self.bucket_bytes = (_bucket_bytes_default()
                             if bucket_bytes is None else int(bucket_bytes))
        self.quantization = quantization
        self.average = average
        self.timeout = timeout
        self._pending: list = []          # leaves of the open bucket
        self._pending_bytes = 0
        self._works: list = []            # launched buckets, in order
        self._backs: list = []            # per pushed leaf: back to its kind/device

    # -- streaming API ----------------------------------------------------
    def push(self, grad) -> None:
        """Add one grad leaf; launches the open bucket's collective the
        moment it fills (call DURING backward for compute overlap)."""
        from ray_tpu_torch.collective.collective import _host

        a = _host(grad) if _dt.is_tensor(grad) else np.asarray(grad)
        if self._pending and _cut_before(
                self._pending_bytes, self._pending[0].dtype, a,
                self.bucket_bytes):
            self._flush()
        self._pending.append(a if _dt.is_tensor(a) else np.ascontiguousarray(a))
        self._backs.append(_dt.backer(grad))
        self._pending_bytes += _dt.nbytes(a)
        if self._pending_bytes >= self.bucket_bytes:
            self._flush()

    def _flush(self) -> None:
        from ray_tpu_torch import collective as col

        if not self._pending:
            return
        leaves, self._pending = self._pending, []
        self._pending_bytes = 0
        flat = leaves[0].reshape(-1) if len(leaves) == 1 else _dt.concat(leaves)
        _bucket_hist.observe(float(flat.nbytes), tags={"mode": "allreduce"})
        work = col.allreduce_async(
            flat, "sum", self.group_name,
            quantization=self.quantization, timeout=self.timeout)
        self._works.append((leaves, work))

    def finish(self) -> list:
        """Flush the tail bucket and block for every in-flight collective;
        returns the reduced leaves in push order. Resets the instance even
        on failure: a CollectiveError from one bucket must not leave stale
        works queued to poison the next step's finish() (the ring itself
        recovers; a retried step pushes fresh grads)."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.util.dtypes import is_float_dtype as _is_float_dtype

        self._flush()
        world = col.get_collective_group_size(self.group_name)
        out: list = []
        backs, self._backs = self._backs, []
        try:
            for leaves, work in self._works:
                flat = work.result(self.timeout)
                if self.average and _is_float_dtype(flat.dtype):
                    flat = flat / world
                off = 0
                for l in leaves:
                    n = _dt.numel(l)
                    piece = flat[off:off + n].reshape(l.shape)
                    piece = (piece.to(l.dtype) if _dt.is_tensor(piece)
                             else piece.astype(l.dtype, copy=False))
                    out.append(backs[len(out)](piece))
                    off += n
        finally:
            self._works = []
        return out

    # -- whole-pytree API -------------------------------------------------
    def allreduce(self, grads):
        """Bucket + allreduce a whole grad pytree; returns the same
        structure with (optionally averaged) reduced leaves."""
        leaves, treedef = _tree_flatten(grads)
        for l in leaves:
            self.push(l)
        return _tree_unflatten(treedef, self.finish())


class ShardedOptimizerStep:
    """Data-parallel step with per-rank sharded optimizer state.

    ``step(params, grads)`` reduce-scatters each grad bucket (every rank
    gets the sum of its own 1/W slice), applies the optimizer to that slice
    only — optimizer slots are allocated shard-sized, never full-model
    sized — and allgathers the updated parameter shards back into the full
    pytree. Supported optimizers: ``"sgd"`` (momentum optional) and
    ``"adam"``; both are elementwise, so the sharded math is bit-equal to
    an unsharded update given equal grad sums."""

    def __init__(self, optimizer: str = "adam", *, lr: float = 1e-3,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.0,
                 group_name: str = "default",
                 bucket_bytes: Optional[int] = None,
                 quantization: Optional[str] = None,
                 timeout: float = 120.0):
        if optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer!r} (adam | sgd)")
        self.optimizer = optimizer
        self.lr, self.betas, self.eps, self.momentum = lr, betas, eps, momentum
        self.group_name = group_name
        self.bucket_bytes = (_bucket_bytes_default()
                             if bucket_bytes is None else int(bucket_bytes))
        self.quantization = quantization
        self.timeout = timeout
        self._state: dict = {}   # bucket index -> {slot: shard array}
        self._bucket_n: dict = {}  # bucket index -> true (unpadded) flat size
        self._t = 0              # adam step count
        self.peak_state_bytes = 0

    def state_bytes(self) -> int:
        """Bytes of optimizer state currently allocated on THIS rank (the
        sharded-update invariant: ~slots * ceil(n/W) * 4, never slots * n * 4)."""
        return sum(a.nbytes for slots in self._state.values()
                   for a in slots.values())

    # -- elastic plane: window export / adopt ------------------------------
    # The per-rank slot arrays are windows [r*shard, (r+1)*shard) of a
    # logical length-n flat per bucket (n tracked unpadded; pad elements are
    # exactly zero — a zero grad keeps m=v=mom=0 — so they never ship).
    # A live N->M reshard moves these windows through the SAME rectangle
    # intersection the ckpt plane uses, then adopt_shards() re-pads.

    def live_shards(self) -> dict:
        """{path: (window_1d, lo, n_total)} for train.keep_live(sharded=...):
        this rank's optimizer windows, clipped to each bucket's true size."""
        from ray_tpu_torch import collective as col

        rank = col.get_rank(self.group_name)
        out: dict = {}
        for bi, slots in self._state.items():
            n = self._bucket_n.get(bi)
            if n is None:
                continue  # never stepped: nothing to ship
            for slot, arr in slots.items():
                shard = arr.size
                lo = rank * shard
                keep = max(0, min(shard, n - lo))
                out[f"opt.{bi}.{slot}"] = (arr[:keep], lo, n)
        return out

    def adopt_shards(self, sharded: dict, *, t: int) -> None:
        """Rebuild this rank's slot windows from a live reshard's payload
        ({path: (window_1d, lo, n_total)} — the keys live_shards() emitted,
        windows already resharded to THIS rank's [lo, hi) under the new
        world size). Re-pads each window to its ceil(n/W) allocation and
        restores the adam step count."""
        from ray_tpu_torch import collective as col

        self._t = int(t)
        world = col.get_collective_group_size(self.group_name)
        for path, (arr, lo, n) in sharded.items():
            parts = path.split(".")
            if len(parts) != 3 or parts[0] != "opt":
                raise ValueError(f"unrecognized optimizer shard path {path!r}")
            bi, slot = int(parts[1]), parts[2]
            n = int(n)
            self._bucket_n[bi] = n
            slots = self._state.setdefault(bi, {})
            # Uniform ceil(n/W) allocation under the NEW world size (adopt
            # runs after the resized session re-joined its gang); tail/empty
            # windows re-pad with exact zeros.
            shard = -(-n // world) if world > 0 else n
            padded = np.zeros(shard, dtype=arr.dtype)
            padded[:arr.size] = arr
            slots[slot] = padded
        self.peak_state_bytes = max(self.peak_state_bytes, self.state_bytes())

    def full_state(self) -> dict:
        """{path: full length-n 1-D array} — every bucket slot allgathered
        across the gang (the checkpoint-control path: a rank that persists
        full optimizer state must first collect the other ranks' windows)."""
        from ray_tpu_torch import collective as col

        out: dict = {}
        for bi, slots in sorted(self._state.items()):
            n = self._bucket_n.get(bi)
            if n is None:
                continue
            for slot, arr in sorted(slots.items()):
                full = np.concatenate(col.allgather(
                    arr, self.group_name, timeout=self.timeout))[:n]
                out[f"opt.{bi}.{slot}"] = full
        return out

    def _buckets(self, leaves: list) -> list:
        """Deterministic bucketing by size+dtype boundary (same cuts on
        every rank for the same model structure)."""
        buckets, cur, cur_bytes = [], [], 0
        for i, a in enumerate(leaves):
            if cur and _cut_before(cur_bytes, leaves[cur[0]].dtype, a,
                                   self.bucket_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += a.nbytes
        if cur:
            buckets.append(cur)
        return buckets

    def _update_shard(self, bi: int, p: np.ndarray, g: np.ndarray) -> np.ndarray:
        """Elementwise optimizer on one bucket's shard; state lazily
        allocated SHARD-sized."""
        slots = self._state.get(bi)
        if slots is None:
            slots = self._state[bi] = {}
            if self.optimizer == "adam":
                slots["m"] = np.zeros_like(g)
                slots["v"] = np.zeros_like(g)
            elif self.momentum:
                slots["mom"] = np.zeros_like(g)
            self.peak_state_bytes = max(self.peak_state_bytes, self.state_bytes())
        if self.optimizer == "adam":
            b1, b2 = self.betas
            m, v = slots["m"], slots["v"]
            m *= b1
            m += (1 - b1) * g
            v *= b2
            v += (1 - b2) * np.square(g)
            mhat = m / (1 - b1 ** self._t)
            vhat = v / (1 - b2 ** self._t)
            return p - self.lr * mhat / (np.sqrt(vhat) + self.eps)
        if self.momentum:
            mom = slots["mom"]
            mom *= self.momentum
            mom += g
            g = mom
        return p - self.lr * g

    def step(self, params, grads):
        """One sharded data-parallel update; returns the new params pytree
        (same structure/dtypes as ``params``)."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.collective import _host

        g_leaves, g_def = _tree_flatten(grads)
        p_leaves, p_def = _tree_flatten(params)
        if len(g_leaves) != len(p_leaves):
            raise ValueError("params and grads pytrees differ in structure")
        g_arrs = [_host(l) for l in g_leaves]
        p_arrs = [_host(l) for l in p_leaves]
        p_backs = [_dt.backer(l) for l in p_leaves]
        world = col.get_collective_group_size(self.group_name)
        rank = col.get_rank(self.group_name)
        self._t += 1
        buckets = self._buckets(g_arrs)
        t0 = time.perf_counter()

        # Phase 1: launch every bucket's reduce-scatter back to back (the
        # packing of bucket i+1 overlaps the wire time of bucket i).
        rs_works = []
        for bi, idxs in enumerate(buckets):
            flat = _dt.concat([g_arrs[i] for i in idxs])
            _bucket_hist.observe(float(flat.nbytes), tags={"mode": "sharded"})
            n = _dt.numel(flat)
            self._bucket_n[bi] = n  # true size (elastic window export/adopt)
            shard = -(-n // world)  # ceil
            if shard * world != n:
                flat = _dt.concat([flat, _dt.zeros(shard * world - n, _dt.dtype_name(flat.dtype))])
            if self.quantization:
                # Quantized grad sync: allreduce (the quantized lane), then
                # slice this rank's shard locally — reduce-scatter keeps the
                # fp path, allreduce carries the int8 codec.
                work = col.allreduce_async(
                    flat, "sum", self.group_name,
                    quantization=self.quantization, timeout=self.timeout)
            else:
                work = col.reducescatter_async(
                    flat.reshape(world, shard), "sum", self.group_name,
                    timeout=self.timeout)
            rs_works.append((bi, idxs, n, shard, work))

        # Phase 2: as each bucket's shard arrives, apply the optimizer to
        # this rank's slice and launch the params allgather immediately —
        # bucket i's allgather overlaps bucket i+1's optimizer math.
        ag_works = []
        for bi, idxs, n, shard, work in rs_works:
            got = work.result(self.timeout)
            if self.quantization:
                # flat was padded to shard*world before the allreduce, so
                # the slice is always full-length (pad zeros survive the
                # int8 codec exactly: they quantize to code 0 and sum to 0).
                g_shard = got[rank * shard:(rank + 1) * shard]
            else:
                g_shard = got
            g_shard = g_shard / world  # data-parallel mean
            # Copy ONLY this rank's [lo, lo+shard) window of the bucket's
            # virtual param concatenation — materializing the whole bucket
            # to keep 1/W of it put an N-byte memcpy per rank per step on
            # the exact path whose point is shard-sized per-rank work.
            # pdtype mirrors np.concatenate's promotion over the bucket's
            # leaves so the shipped (and allgathered) dtype is unchanged.
            pdtype = _result_dtype([_dt.dtype_name(p_arrs[i].dtype) for i in idxs])
            lo = rank * shard
            parts, off = [], 0
            for i in idxs:
                a = p_arrs[i].reshape(-1)
                size = _dt.numel(a)
                s, e = max(lo, off), min(lo + shard, off + size)
                if s < e:
                    parts.append(a[s - off:e - off])
                off += size
            got_elems = sum(_dt.numel(p) for p in parts)
            if got_elems < shard:  # trailing rank past the bucket's end
                parts.append(_dt.zeros(shard - got_elems, pdtype))
            # The optimizer math runs on fp32 numpy (bfloat16 widens
            # exactly), then the shard narrows back to the bucket's dtype.
            p_shard = np.concatenate([_dt.to_float32(p).reshape(-1) for p in parts])
            new_shard = self._update_shard(bi, p_shard, _dt.to_float32(g_shard))
            new_shard = _dt.from_float32(new_shard, pdtype)
            ag_works.append((idxs, n, col.allgather_async(
                new_shard, self.group_name, timeout=self.timeout)))

        # Phase 3: reassemble updated params.
        new_leaves: list = [None] * len(p_arrs)
        for idxs, n, work in ag_works:
            flat = _dt.concat(work.result(self.timeout))[:n]
            off = 0
            for i in idxs:
                # Cast back per leaf: concatenating a bucket's param leaves
                # promotes mixed dtypes, and the contract is same-dtype-out.
                size = _dt.numel(p_arrs[i])
                leaf = flat[off:off + size].reshape(p_arrs[i].shape)
                new_leaves[i] = p_backs[i](_cast_to(leaf, _dt.dtype_name(p_arrs[i].dtype)))
                off += size
        self.last_step_s = time.perf_counter() - t0
        return _tree_unflatten(p_def, new_leaves)


__all__ = ["BucketedGradSync", "ShardedOptimizerStep"]
