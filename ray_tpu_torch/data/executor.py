"""Streaming executor: pulls blocks through fused operator segments.

Role-equivalent to the reference's StreamingExecutor
(python/ray/data/_internal/execution/streaming_executor.py:71
— "routes blocks through operators maximizing throughput under resource
constraints"). Same core ideas, sized to this runtime:

- blocks are ObjectRefs to Arrow tables; the driver never holds data, only
  refs (data stays in the shared-memory store);
- one-to-one op chains are FUSED into a single remote task per block
  (reference: fusion rules in logical/ruleset.py);
- bounded in-flight task budget = backpressure (reference:
  backpressure_policy/);
- all-to-all ops (repartition, shuffle, sort, groupby) are barrier stages
  (reference: hash_shuffle.py) built from the same task primitives.

Counterpart of ``ray_tpu/data/executor.py`` on the port's runtime (``import
ray_tpu_torch as rt``). An actor-pool stage's ``ray_remote_args`` reach its
actors as given: ``{"num_gpus": f}`` is each pool actor's ``GPU`` demand.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.logical import LogicalOp

DEFAULT_MAX_IN_FLIGHT = 8


# ---------------------------------------------------------------------------
# Fused segment application (runs inside worker tasks)
# ---------------------------------------------------------------------------

def _apply_segment(blk, ops: list[tuple[str, Callable, dict]]):
    for kind, fn, params in ops:
        if blk.num_rows == 0 and kind != "map_batches":
            continue
        if kind == "map_batches":
            fmt = params.get("batch_format", "numpy")
            out = fn(B.block_to_batch(blk, fmt))
            blk = B.block_from_batch(out)
        elif kind == "map":
            blk = B.block_from_rows([fn(r) for r in B.block_rows(blk)])
        elif kind == "filter":
            blk = B.block_from_rows([r for r in B.block_rows(blk) if fn(r)])
        elif kind == "flat_map":
            out = []
            for r in B.block_rows(blk):
                out.extend(fn(r))
            blk = B.block_from_rows(out)
        else:
            raise ValueError(f"not a one-to-one op: {kind}")
    return blk


def _read_fn_task(read_fn: Callable):
    return read_fn()


def _wait_done(rt, refs: list):
    """Block until every ref is terminal (done OR failed). A bare rt.wait
    timeout is indistinguishable from completion — treating it as done and
    then killing the pool would turn a merely-slow task into ActorDiedError
    for a ref already handed to the consumer."""
    remaining = list(refs)
    while remaining:
        done, remaining = rt.wait(remaining, num_returns=len(remaining), timeout=60)
        remaining = list(remaining)


class _MapWorker:
    """Actor-pool map_batches executor (reference: _MapWorker inside
    ActorPoolMapOperator, actor_pool_map_operator.py:546): constructs the UDF
    ONCE (class UDFs pay their model load here, not per block), then applies
    it to streamed blocks."""

    def __init__(self, fn, ctor_args, ctor_kwargs, batch_format):
        self.batch_format = batch_format
        self.fn = fn(*ctor_args, **ctor_kwargs) if isinstance(fn, type) else fn

    def apply(self, blk):
        out = self.fn(B.block_to_batch(blk, self.batch_format))
        return B.block_from_batch(out)


class StreamingExecutor:
    def __init__(self, max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                 budgets: Optional[dict] = None):
        self.max_in_flight = max_in_flight
        # Per-op-kind in-flight budgets (reference: per-operator resource
        # budgets in _internal/execution/resource_manager.py): an op kind in
        # `budgets` caps ITS stage's concurrent tasks independently of the
        # global default — e.g. {"map_batches": 2} throttles a memory-hungry
        # UDF stage without starving reads.
        self.budgets = dict(budgets or {})

    def _budget(self, kinds) -> int:
        vals = [self.budgets[k] for k in kinds if k in self.budgets]
        return min(vals) if vals else self.max_in_flight

    # -- public ------------------------------------------------------------
    def execute(self, plan_leaf: LogicalOp) -> Iterator:
        """Yields ObjectRefs of output blocks, streaming."""
        chain = plan_leaf.chain_from_source()
        return self._run_chain(chain)

    # -- internals ---------------------------------------------------------
    def _run_chain(self, chain: list[LogicalOp]) -> Iterator:
        src, rest = chain[0], chain[1:]
        stream = self._source_stream(src)
        seg: list[LogicalOp] = []
        for op in rest:
            if op.kind == "map_batches" and op.params.get("compute") == "actors":
                # Stateful stage: runs on an actor pool (its own boundary —
                # it cannot fuse into stateless task segments).
                stream = self._mapped_stream(stream, seg)
                seg = []
                stream = self._actor_pool_stream(stream, op)
                continue
            if op.is_one_to_one:
                seg.append(op)
                continue
            stream = self._mapped_stream(stream, seg)
            seg = []
            if op.kind == "union":
                # inputs[0] is the upstream chain already in `stream`; the
                # remaining inputs stream after it.
                stream = itertools.chain(
                    stream,
                    *(self._run_chain(p.chain_from_source())
                      for p in op.inputs[1:]),
                )
            elif op.kind == "zip":
                stream = self._zip(stream, op)
            elif op.kind == "join":
                stream = self._join(stream, op)
            else:
                stream = self._all_to_all(stream, op)
        return self._mapped_stream(stream, seg)

    def _source_stream(self, src: LogicalOp) -> Iterator:
        import ray_tpu_torch as rt

        if src.kind == "source":
            if "block_refs" in src.params:
                yield from src.params["block_refs"]
                return
            read_task = rt.remote(_read_fn_task)
            pending = []
            for read_fn in src.params["read_fns"]:
                pending.append(read_task.remote(read_fn))
                while len(pending) >= self.max_in_flight:
                    yield pending.pop(0)
            yield from pending
        else:
            raise ValueError(f"unknown source kind {src.kind}")

    def _mapped_stream(self, stream: Iterator, seg: list[LogicalOp]) -> Iterator:
        if not seg:
            yield from stream
            return
        import ray_tpu_torch as rt

        ops = [(o.kind, o.fn, o.params) for o in seg]
        task = rt.remote(_apply_segment)
        remote_args = {}
        for o in seg:  # per-op ray_remote_args (resources etc) apply to the fused task
            remote_args.update(o.params.get("ray_remote_args") or {})
        if remote_args:
            task = task.options(**remote_args)
        budget = self._budget([o.kind for o in seg])
        # map_batches(concurrency=N) with tasks-compute caps THIS stage.
        caps = [int(o.params["concurrency"]) for o in seg
                if isinstance(o.params.get("concurrency"), int)]
        if caps:
            budget = min(budget, *caps)
        pending: list = []
        for ref in stream:
            pending.append(task.remote(ref, ops))
            while len(pending) >= budget:
                yield pending.pop(0)
        yield from pending

    # -- actor-pool stage --------------------------------------------------
    def _actor_pool_stream(self, stream: Iterator, op: LogicalOp) -> Iterator:
        """Stateful map_batches on a pool of long-lived actors (reference:
        ActorPoolMapOperator, _internal/execution/operators/
        actor_pool_map_operator.py:70 — how model-inference UDFs run: the
        class constructs ONCE per actor, blocks route to the least-loaded
        actor with bounded in-flight backpressure, the pool scales between
        min and max on backlog). Pool actors restart on failure and their
        in-flight calls retry on the replacement (max_restarts +
        max_task_retries — the core's actor FSM), so one dying actor costs
        retries, not the dataset."""
        import ray_tpu_torch as rt

        conc = op.params.get("concurrency") or 1
        mn, mx = (conc if isinstance(conc, (tuple, list)) else (conc, conc))
        mn, mx = max(1, int(mn)), max(1, int(mx))
        per_actor = int(op.params.get("max_tasks_in_flight_per_actor", 2))
        actor_cls = rt.remote(_MapWorker)
        opts = dict(op.params.get("ray_remote_args") or {})
        opts.setdefault("max_restarts", -1)
        opts.setdefault("max_task_retries", 3)
        ctor = (
            op.fn,
            op.params.get("fn_constructor_args") or (),
            op.params.get("fn_constructor_kwargs") or {},
            op.params.get("batch_format", "numpy"),
        )

        def spawn():
            return actor_cls.options(**opts).remote(*ctor)

        actors = [spawn() for _ in range(mn)]
        loads = [0] * len(actors)
        pending: list = []  # (out_ref, actor_idx), submission order
        completed = False
        try:
            for ref in stream:
                while pending and len(pending) >= len(actors) * per_actor:
                    if len(actors) < mx:
                        # Saturated below the ceiling: scale the pool up.
                        actors.append(spawn())
                        loads.append(0)
                        break
                    out, idx = pending.pop(0)
                    _wait_done(rt, [out])
                    loads[idx] -= 1
                    yield out
                idx = loads.index(min(loads))
                pending.append((actors[idx].apply.remote(ref), idx))
                loads[idx] += 1
            for out, _idx in pending:
                yield out
            completed = True
        finally:
            if completed and pending:
                # Tail refs were yielded before their tasks finished: let
                # them land in the object store before the pool dies.
                _wait_done(rt, [o for o, _ in pending])
            # Normal end OR consumer closed early: the pool is stage-owned,
            # tear it down (early close also abandons unfinished work).
            for a in actors:
                try:
                    rt.kill(a, no_restart=True)
                except Exception:
                    pass

    # -- all-to-all stages -------------------------------------------------
    def _all_to_all(self, stream: Iterator, op: LogicalOp) -> Iterator:
        import ray_tpu_torch as rt

        refs = list(stream)  # barrier
        if op.kind == "limit":
            yield from self._limit(refs, op.params["n"])
            return
        if not refs:
            return
        if op.kind == "repartition":
            yield from self._repartition(refs, op.params["num_blocks"])
        elif op.kind == "hash_repartition":
            parts = self._hash_shuffle(refs, op.params["key"], op.params["num_blocks"])
            concat = rt.remote(_concat_parts)
            for plist in parts:
                yield concat.remote(*plist)
        elif op.kind == "random_shuffle":
            yield from self._random_shuffle(refs, op.params.get("seed"))
        elif op.kind == "sort":
            yield from self._sort(refs, op.params["key"], op.params.get("descending", False))
        elif op.kind == "groupby_map":
            yield from self._groupby(refs, op.params["key"], op.fn)
        elif op.kind == "hash_groupby":
            key = op.params["key"]
            n_parts = op.params.get("num_partitions") or min(8, len(refs))
            parts = self._hash_shuffle(refs, key, n_parts)
            reduce_task = rt.remote(_grouped_reduce)
            for plist in parts:
                yield reduce_task.remote(key, op.fn, *plist)
        else:
            raise ValueError(f"unknown all-to-all op {op.kind}")

    def _partition_shuffle(self, refs: list, part_fn, part_args: tuple,
                           n_parts: int, budget_kind: str) -> list[list]:
        """Map side of any shuffle: one multi-return task per input block
        emits n_parts sub-blocks as SEPARATE objects (reference:
        hash_shuffle.py / sort_task_spec.py map tasks). Returns parts[p] =
        sub-block refs for partition p; data flows block -> pieces -> reduce
        through the object store, never the driver. Bounded in-flight
        partition tasks = backpressure."""
        import ray_tpu_torch as rt

        budget = self._budget([budget_kind])
        part_task = rt.remote(part_fn).options(num_returns=n_parts)
        parts: list[list] = [[] for _ in range(n_parts)]
        in_flight: list = []
        for ref in refs:
            out = part_task.remote(*part_args, ref)
            out = [out] if n_parts == 1 else out
            for p, r in enumerate(out):
                parts[p].append(r)
            in_flight.append(out[0])
            if len(in_flight) >= budget:
                rt.wait(in_flight, num_returns=1, timeout=300)
                in_flight = in_flight[1:]
        return parts

    def _hash_shuffle(self, refs: list, key: str, n_parts: int) -> list[list]:
        n_parts = max(1, n_parts)
        return self._partition_shuffle(
            refs, _hash_partition, (key, n_parts), n_parts, "hash_partition"
        )

    def _join(self, stream: Iterator, op: LogicalOp) -> Iterator:
        """Hash join (reference: _internal/execution/operators/join.py):
        both sides hash-partition on the key; one reduce task per partition
        joins its pair of partitions."""
        import ray_tpu_torch as rt

        on = op.params["on"]
        how = op.params.get("how", "inner")
        left = list(stream)
        right = list(self._run_chain(op.inputs[1].chain_from_source()))
        if not left or (not right and how == "inner"):
            return
        n_parts = op.params.get("num_partitions") or min(8, max(len(left), len(right), 1))
        lparts = self._hash_shuffle(left, on, n_parts)
        rparts = self._hash_shuffle(right, on, n_parts) if right else [[] for _ in range(n_parts)]
        join_task = rt.remote(_join_parts)
        for p in range(n_parts):
            yield join_task.remote(on, how, len(lparts[p]), *(lparts[p] + rparts[p]))

    def _limit(self, refs: list, n: int) -> Iterator:
        import ray_tpu_torch as rt

        remaining = n
        slice_task = rt.remote(lambda blk, k: B.block_slice(blk, 0, k))
        counts = rt.get([_num_rows_task().remote(r) for r in refs])
        for ref, cnt in zip(refs, counts):
            if remaining <= 0:
                return
            if cnt <= remaining:
                yield ref
                remaining -= cnt
            else:
                yield slice_task.remote(ref, remaining)
                remaining = 0

    def _repartition(self, refs: list, num_blocks: int) -> Iterator:
        import ray_tpu_torch as rt

        build = rt.remote(_build_partition)
        counts = rt.get([_num_rows_task().remote(r) for r in refs])
        total = sum(counts)
        per = max(1, total // max(1, num_blocks))
        bounds = [min(i * per, total) for i in range(num_blocks)] + [total]
        for i in range(num_blocks):
            yield build.remote(bounds[i], bounds[i + 1], counts, *refs)

    def _random_shuffle(self, refs: list, seed) -> Iterator:
        import ray_tpu_torch as rt

        counts = rt.get([_num_rows_task().remote(r) for r in refs])
        total = sum(counts)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(total)
        n_out = len(refs)
        per = max(1, (total + n_out - 1) // n_out)
        build = rt.remote(_take_global)
        for i in range(n_out):
            idxs = perm[i * per: (i + 1) * per]
            if len(idxs):
                yield build.remote(idxs, counts, *refs)

    def _sort(self, refs: list, key: str, descending: bool) -> Iterator:
        """Distributed sample-sort (reference: SortTaskSpec,
        _internal/planner/exchange/sort_task_spec.py:94,164 — sample key
        ranges, range-partition every block, per-range sort-merge). No task
        ever materializes more than one partition: samples flow to the
        driver (tiny), data flows block -> range pieces -> merge through the
        object store. Output refs stream in global key order."""
        import ray_tpu_torch as rt

        n_parts = min(8, len(refs))
        if n_parts <= 1:
            yield rt.remote(_sort_merge_part).remote(key, descending, *refs)
            return
        sample_task = rt.remote(_sample_keys)
        budget = self._budget(["sort"])
        sample_refs: list = []
        in_flight: list = []
        for ref in refs:  # bounded in-flight, same backpressure as the shuffles
            r = sample_task.remote(key, ref)
            sample_refs.append(r)
            in_flight.append(r)
            if len(in_flight) >= budget:
                rt.wait(in_flight, num_returns=1, timeout=300)
                in_flight = in_flight[1:]
        samples = rt.get(sample_refs)
        flat = sorted(v for s in samples for v in s)
        if not flat:
            yield rt.remote(_sort_merge_part).remote(key, descending, *refs)
            return
        # n_parts-1 boundary values at sample quantiles (reference:
        # SortTaskSpec.sample_boundaries).
        bounds = [flat[(len(flat) * i) // n_parts] for i in range(1, n_parts)]
        parts = self._partition_shuffle(
            refs, _range_partition, (key, bounds), n_parts, "sort"
        )
        merge = rt.remote(_sort_merge_part)
        order = range(n_parts - 1, -1, -1) if descending else range(n_parts)
        for p in order:
            yield merge.remote(key, descending, *parts[p])

    def _groupby(self, refs: list, key: str, agg_fn: Callable) -> Iterator:
        import ray_tpu_torch as rt

        yield rt.remote(_groupby_all).remote(key, agg_fn, *refs)

    def _zip(self, stream: Iterator, op: LogicalOp) -> Iterator:
        """Row-aligned column merge of two datasets of equal length
        (reference: Dataset.zip). Both sides barrier, then one task builds
        the merged blocks (column collision: right side wins with a _1
        suffix like the reference)."""
        import ray_tpu_torch as rt

        left = list(stream)
        right = list(self._run_chain(op.inputs[1].chain_from_source()))
        yield rt.remote(_zip_all).remote(len(left), *(left + right))


_num_rows_remote = None


def _num_rows_task():
    global _num_rows_remote
    if _num_rows_remote is None:
        import ray_tpu_torch as rt

        _num_rows_remote = rt.remote(B.block_num_rows)
    return _num_rows_remote


# -- remote helpers (top-level so they pickle by reference cheaply) ---------

def _build_partition(start: int, end: int, counts: list[int], *blocks):
    """Rows [start, end) of the concatenated stream."""
    out = []
    offset = 0
    for cnt, blk in zip(counts, blocks):
        lo, hi = max(start, offset), min(end, offset + cnt)
        if lo < hi:
            out.append(B.block_slice(blk, lo - offset, hi - offset))
        offset += cnt
    return B.concat_blocks(out)


def _take_global(indices: "np.ndarray", counts: list[int], *blocks):
    """Select global row indices across the block list."""
    offsets = np.cumsum([0] + list(counts))
    parts = []
    order = np.argsort(indices, kind="stable")
    sorted_idx = np.asarray(indices)[order]
    pos = 0
    for i, blk in enumerate(blocks):
        lo, hi = offsets[i], offsets[i + 1]
        sel = sorted_idx[(sorted_idx >= lo) & (sorted_idx < hi)] - lo
        if len(sel):
            parts.append(B.block_take(blk, sel))
        pos += len(sel)
    merged = B.concat_blocks(parts)
    # restore requested order
    inverse = np.empty(len(order), dtype=np.int64)
    inverse[order] = np.arange(len(order))
    return B.block_take(merged, inverse)


def _zip_all(n_left: int, *blocks):
    left = B.concat_blocks(list(blocks[:n_left]))
    right = B.concat_blocks(list(blocks[n_left:]))
    if left.num_rows != right.num_rows:
        raise ValueError(
            f"zip requires equal row counts, got {left.num_rows} vs {right.num_rows}"
        )
    out = left
    existing = set(left.column_names)
    for name in right.column_names:
        col = right.column(name)
        out = out.append_column(name + "_1" if name in existing else name, col)
    return out


def _sample_keys(key: str, blk, max_samples: int = 64):
    """Evenly-strided key sample of one block (sort boundary estimation)."""
    n = blk.num_rows
    if n == 0:
        return []
    vals = blk.column(key).to_pylist()
    stride = max(1, n // max_samples)
    return vals[::stride][:max_samples]


def _range_partition(key: str, bounds: list, blk):
    """Split one block into len(bounds)+1 range pieces (multi-return task):
    piece p holds rows with bounds[p-1] <= key < bounds[p]."""
    import bisect

    n_parts = len(bounds) + 1
    if blk.num_rows == 0:
        return tuple([blk] * n_parts)
    vals = blk.column(key).to_pylist()
    ids = np.fromiter((bisect.bisect_right(bounds, v) for v in vals), np.int64, len(vals))
    return tuple(B.block_take(blk, np.nonzero(ids == p)[0]) for p in range(n_parts))


def _sort_merge_part(key: str, descending: bool, *blocks):
    """Sort one range partition (every row of the range is here, so the
    per-partition sort is globally correct in partition order)."""
    merged = B.concat_blocks(list(blocks))
    if merged.num_rows == 0:
        return merged
    col = np.asarray(merged.column(key).to_pylist())
    order = np.argsort(col, kind="stable")
    if descending:
        order = order[::-1]
    return B.block_take(merged, order)


def _stable_partition_ids(values, n_parts: int) -> "np.ndarray":
    """Deterministic cross-process partition assignment (Python's str hash is
    per-process randomized; crc32 of repr is stable for the value types Arrow
    columns hold). Numeric keys are canonicalized so equal values agree on a
    partition across dtypes (an int64 1 and a float64 1.0 compare equal in
    the reduce's dict — they must land in the same partition)."""
    import zlib

    from ray_tpu_torch.util.dtypes import is_float_dtype

    arr = np.asarray(values)
    if arr.dtype.kind in "iu":  # integers partition directly
        return (arr % n_parts).astype(np.int64)
    if is_float_dtype(arr.dtype):
        as_int = arr.astype(np.int64, copy=False)
        # Integral floats route like ints (cross-dtype join consistency);
        # true fractional keys use the stable byte hash below.
        with np.errstate(invalid="ignore"):
            if np.all(np.isfinite(arr)) and np.all(as_int == arr):
                return (as_int % n_parts).astype(np.int64)
    def one(v):
        if isinstance(v, (int, np.integer)):
            return int(v) % n_parts
        if isinstance(v, np.generic) and is_float_dtype(v.dtype):
            # bf16/f32 scalars hash by repr ("-0", "np.float32(0.5)") unless
            # canonicalized through the builtin float the pylist path yields.
            v = float(v)
        if isinstance(v, float) and v.is_integer():
            return int(v) % n_parts  # same route as the int fast path
        return zlib.crc32(repr(v).encode()) % n_parts

    return np.array([one(v) for v in values], np.int64)


def _hash_partition(key: str, n_parts: int, blk):
    """Map side of the shuffle: split one block into n_parts sub-blocks by
    key hash (multi-return task: each sub-block is its own object)."""
    if blk.num_rows == 0:
        parts = [blk] * n_parts
    else:
        ids = _stable_partition_ids(blk.column(key).to_pylist(), n_parts)
        parts = [B.block_take(blk, np.nonzero(ids == p)[0]) for p in range(n_parts)]
    return parts[0] if n_parts == 1 else tuple(parts)


def _concat_parts(*parts):
    return B.concat_blocks([p for p in parts if p.num_rows] or list(parts[:1]))


def _grouped_reduce(key: str, agg_fn, *parts):
    """Reduce side of a hash groupby: every row of a key lives in exactly one
    partition, so per-partition grouping is globally correct."""
    return _groupby_all(key, agg_fn, *parts)


def _join_parts(on: str, how: str, n_left: int, *parts):
    """Per-partition hash join. Right-side non-key columns keep their names;
    collisions with left get a _1 suffix (same convention as zip)."""
    left = B.concat_blocks(list(parts[:n_left])) if n_left else B.block_from_rows([])
    right = B.concat_blocks(list(parts[n_left:])) if len(parts) > n_left else B.block_from_rows([])
    lrows = B.block_rows(left) if left.num_rows else []
    rrows = B.block_rows(right) if right.num_rows else []
    by_key: dict = {}
    for r in rrows:
        by_key.setdefault(r[on], []).append(r)
    lcols = set(left.column_names) if left.num_rows else set()
    # Uniform output schema: every row carries every joined column (an
    # unmatched left row gets None for right columns) — blocks are columnar,
    # so ragged row dicts would silently drop late-appearing columns.
    rcols = [c for c in (right.column_names if right.num_rows else []) if c != on]
    out_name = {c: (c + "_1" if c in lcols else c) for c in rcols}
    out = []
    for lr in lrows:
        matches = by_key.get(lr[on])
        if matches:
            for rr in matches:
                row = dict(lr)
                for c in rcols:
                    row[out_name[c]] = rr[c]
                out.append(row)
        elif how == "left":
            row = dict(lr)
            for c in rcols:
                row[out_name[c]] = None
            out.append(row)
    return B.block_from_rows(out)


def _groupby_all(key: str, agg_fn, *blocks):
    merged = B.concat_blocks(list(blocks))
    rows = B.block_rows(merged)
    groups: dict = {}
    for r in rows:
        groups.setdefault(r[key], []).append(r)
    out: list = []
    for k, v in groups.items():
        res = agg_fn(k, v)
        # map_groups UDFs may emit one row or several per group.
        if isinstance(res, list):
            out.extend(res)
        else:
            out.append(res)
    return B.block_from_rows(out)
