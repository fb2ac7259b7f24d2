"""Dataset: the user-facing lazy, streaming data API.

Role-equivalent to the reference's ray.data.Dataset
(python/ray/data/dataset.py — lazy logical plan, streamed
execution, Arrow blocks in the object store) and its read_api.py
constructors. Transforms build a LogicalOp chain (data/logical.py); any
consumption point streams blocks through the StreamingExecutor
(data/executor.py). Nothing materializes on the driver unless asked
(take/count/materialize).

The split-for-training path (streaming_split) mirrors the reference's
StreamSplitDataIterator (_internal/iterator/stream_split_iterator.py:30): one
coordinator actor executes the stream once and deals blocks to n consumers on
demand (dynamic load balancing between train workers).

Counterpart of ``ray_tpu/data/dataset.py`` on the port's runtime
(``import ray_tpu_torch as rt``): the same operators, splits and
constructors; ``iter_torch_batches`` keeps its ``dtypes`` and ``device``.
"""
from __future__ import annotations

import builtins
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import datasource as DS
from ray_tpu_torch.data.executor import StreamingExecutor
from ray_tpu_torch.data.logical import LogicalOp


class Dataset:
    """Lazy distributed dataset of rows, stored as Arrow blocks."""

    def __init__(self, leaf: LogicalOp, max_in_flight: int = 8):
        self._leaf = leaf
        self._max_in_flight = max_in_flight

    # -- transforms (lazy) --------------------------------------------------
    def _chain(self, kind: str, fn=None, **params) -> "Dataset":
        return Dataset(
            LogicalOp(kind, fn=fn, params=params, inputs=[self._leaf]),
            self._max_in_flight,
        )

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._chain("map", fn)

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    batch_size: Optional[int] = None,
                    compute: Optional[str] = None,
                    concurrency=None,
                    fn_constructor_args: Optional[tuple] = None,
                    fn_constructor_kwargs: Optional[dict] = None,
                    ray_remote_args: Optional[dict] = None,
                    max_tasks_in_flight_per_actor: int = 2) -> "Dataset":
        """Apply fn per block. With a CLASS fn (or compute="actors"), the
        stage runs on a pool of stateful actors: the class constructs once
        per actor (model loads happen there), blocks route to the
        least-loaded actor, and the pool scales within `concurrency`
        (int = fixed size, (min, max) = autoscaling) — reference:
        ActorPoolMapOperator + Dataset.map_batches(concurrency=...).
        Execution is at-least-once (as in the reference): a block may be
        re-applied after a worker failure or connection drop, so UDFs must
        be idempotent per block — pure transforms are; UDFs accumulating
        cross-block state should key their state by block content.
        With tasks-compute, an int concurrency caps the stage's concurrent
        tasks and ray_remote_args (resources/labels) pin the tasks.
        batch_size is advisory: blocks are the batching unit (the reference
        re-batches too; we keep block==batch for zero re-slicing)."""
        if isinstance(fn, type) and compute is None:
            compute = "actors"
        if compute not in (None, "tasks", "actors"):
            raise ValueError(f"compute must be 'tasks'|'actors', got {compute!r}")
        if compute != "actors":
            if isinstance(fn, type):
                raise ValueError(
                    "a class UDF is stateful and must run on the actor pool; "
                    "drop compute='tasks' (class fns imply compute='actors')"
                )
            if fn_constructor_args or fn_constructor_kwargs:
                raise ValueError("fn_constructor_* requires a class fn / compute='actors'")
            if concurrency is not None and not isinstance(concurrency, int):
                raise ValueError(
                    "tuple concurrency (min, max) is an actor-pool size; with "
                    "tasks-compute pass an int task cap"
                )
            return self._chain(
                "map_batches", fn, batch_format=batch_format,
                batch_size=batch_size, concurrency=concurrency,
                ray_remote_args=ray_remote_args,
            )
        return self._chain(
            "map_batches", fn, batch_format=batch_format, batch_size=batch_size,
            compute="actors", concurrency=concurrency,
            fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs,
            ray_remote_args=ray_remote_args,
            max_tasks_in_flight_per_actor=max_tasks_in_flight_per_actor,
        )

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._chain("filter", fn)

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._chain("flat_map", fn)

    def add_column(self, name: str, fn: Callable[[dict], Any]) -> "Dataset":
        def add(row, _name=name, _fn=fn):
            row = dict(row)
            row[_name] = _fn(row)
            return row
        return self.map(add)

    def drop_columns(self, cols: list[str]) -> "Dataset":
        def drop(batch, _cols=tuple(cols)):
            return batch.drop_columns(list(_cols))
        return self.map_batches(drop, batch_format="pyarrow")

    def select_columns(self, cols: list[str]) -> "Dataset":
        def select(batch, _cols=list(cols)):
            return batch.select(_cols)
        return self.map_batches(select, batch_format="pyarrow")

    def join(self, other: "Dataset", on: str, *, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Hash join on a key column (reference:
        _internal/execution/operators/join.py): both sides hash-partition on
        `on`; one reduce task joins each partition pair. how: "inner"|"left".
        Right-side column-name collisions get a ``_1`` suffix (zip's rule)."""
        if how not in ("inner", "left"):
            raise ValueError(f"unsupported join type {how!r} (inner|left)")
        return Dataset(
            LogicalOp("join", params={"on": on, "how": how,
                                      "num_partitions": num_partitions},
                      inputs=[self._leaf, other._leaf]),
            self._max_in_flight,
        )

    def repartition(self, num_blocks: int, *, hash_key: Optional[str] = None) -> "Dataset":
        if hash_key is not None:
            # Hash-partitioned layout: all rows of a key land in ONE output
            # block (the shuffle primitive under groupby/join, exposed).
            return self._chain("hash_repartition", key=hash_key, num_blocks=num_blocks)
        return self._chain("repartition", num_blocks=num_blocks)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._chain("random_shuffle", seed=seed)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._chain("sort", key=key, descending=descending)

    def limit(self, n: int) -> "Dataset":
        return self._chain("limit", n=n)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned column merge with an equal-length dataset (reference:
        Dataset.zip); colliding column names from the right side get a _1
        suffix."""
        return Dataset(
            LogicalOp("zip", inputs=[self._leaf, other._leaf]),
            self._max_in_flight,
        )

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample).

        Seeded sampling derives each batch's stream from (seed, batch
        content): deterministic for a given dataset, but NOT the same mask
        replayed per batch (reseeding identically every batch would keep the
        same row positions everywhere — periodic, biased sampling)."""
        import zlib

        import numpy as _np

        def sample(batch, _frac=float(fraction), _seed=seed):
            n = len(next(iter(batch.values()))) if batch else 0
            if _seed is None:
                rng = _np.random.default_rng()
            else:
                first = _np.ascontiguousarray(next(iter(batch.values()))) if batch else _np.empty(0)
                if first.dtype == object:
                    # Ragged columns: tobytes() would hash PyObject POINTERS
                    # (different every run) and repr() truncates long
                    # elements ('...'); pickle serializes full contents
                    # deterministically for plain data.
                    import pickle as _pkl

                    ent = zlib.crc32(_pkl.dumps(first.tolist(), protocol=4))
                else:
                    ent = zlib.crc32(first.tobytes())
                rng = _np.random.default_rng([_seed, ent])
            keep = rng.random(n) < _frac
            return {k: _np.asarray(v)[keep] for k, v in batch.items()}

        return self.map_batches(sample)

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(
            LogicalOp("union", inputs=[self._leaf] + [o._leaf for o in others]),
            self._max_in_flight,
        )

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- execution ----------------------------------------------------------
    def iter_block_refs(self) -> Iterator:
        """Stream ObjectRefs of output blocks (the zero-copy path)."""
        return StreamingExecutor(self._max_in_flight).execute(self._leaf)

    def iter_blocks(self) -> Iterator:
        import ray_tpu_torch as rt

        for ref in self.iter_block_refs():
            yield rt.get(ref)

    def iter_rows(self) -> Iterator[dict]:
        for blk in self.iter_blocks():
            yield from B.block_rows(blk)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator:
        yield from batches_from_blocks(
            self.iter_blocks(), batch_size, batch_format, drop_last
        )

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           dtypes=None, device=None) -> Iterator:
        """Batches as dicts of torch tensors (reference:
        Dataset.iter_torch_batches). ``dtypes``: one torch dtype or a dict
        of them by column; ``device``: where each tensor goes (a synchronous
        ``.to``; ``prefetch_to_device`` overlaps the copy with the step)."""
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                # Zero-copy reads hand out read-only arrays; torch tensors
                # must be writable, so copy those (cheap relative to the
                # host->accelerator step that follows in real training).
                if hasattr(v, "flags") and not v.flags.writeable:
                    v = v.copy()
                t = torch.as_tensor(v)
                if dtypes is not None:
                    t = t.to(dtypes[k] if isinstance(dtypes, dict) else dtypes)
                if device is not None:
                    t = t.to(device)
                out[k] = t
            yield out

    def to_pandas(self, limit: Optional[int] = None):
        """Collect into one pandas DataFrame (reference: Dataset.to_pandas)."""
        import pandas as pd

        ds = self.limit(limit) if limit is not None else self
        blocks = list(ds.iter_blocks())
        if not blocks:
            return pd.DataFrame()
        return B.concat_blocks(blocks).to_pandas()

    # -- consumption --------------------------------------------------------
    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        for blk in self.limit(n).iter_blocks():
            out.extend(B.block_rows(blk))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list[dict]:
        return [r for r in self.iter_rows()]

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        for batch in self.limit(batch_size).iter_batches(
            batch_size=batch_size, batch_format=batch_format
        ):
            return batch
        return B.block_to_batch(B.concat_blocks([]), batch_format)

    def count(self) -> int:
        import ray_tpu_torch as rt

        from ray_tpu_torch.data.executor import _num_rows_task

        refs = [_num_rows_task().remote(r) for r in self.iter_block_refs()]
        return int(sum(rt.get(refs))) if refs else 0

    def schema(self):
        for blk in self.iter_blocks():
            if blk.num_rows > 0 or blk.num_columns > 0:
                return blk.schema
        return None

    def columns(self) -> list[str]:
        sch = self.schema()
        return list(sch.names) if sch is not None else []

    def materialize(self) -> "Dataset":
        """Execute now; the result is a Dataset over in-store block refs."""
        refs = list(self.iter_block_refs())
        return Dataset(
            LogicalOp("source", params={"block_refs": refs}), self._max_in_flight
        )

    def stats(self) -> dict:
        import ray_tpu_torch as rt

        from ray_tpu_torch.data.executor import _num_rows_task

        refs = list(self.iter_block_refs())
        counts = rt.get([_num_rows_task().remote(r) for r in refs]) if refs else []
        return {"num_blocks": len(refs), "num_rows": int(sum(counts)),
                "rows_per_block": [int(c) for c in counts]}

    # -- writes -------------------------------------------------------------
    def _write(self, write_block_fn: Callable, dir_path: str) -> list[str]:
        import ray_tpu_torch as rt

        task = rt.remote(write_block_fn)
        refs = [task.remote(ref, dir_path, i)
                for i, ref in enumerate(self.iter_block_refs())]
        return rt.get(refs)

    def write_parquet(self, dir_path: str) -> list[str]:
        return self._write(DS.write_parquet_block, dir_path)

    def write_csv(self, dir_path: str) -> list[str]:
        return self._write(DS.write_csv_block, dir_path)

    def write_json(self, dir_path: str) -> list[str]:
        return self._write(DS.write_json_block, dir_path)

    # -- splitting ----------------------------------------------------------
    def split(self, n: int) -> list["Dataset"]:
        """Materialize and split into n datasets of near-equal row counts."""
        mat = self.materialize().repartition(n).materialize()
        refs = mat._leaf.params["block_refs"]
        out = []
        for i in builtins.range(n):
            chunk = refs[i: i + 1]
            out.append(Dataset(LogicalOp("source", params={"block_refs": chunk}),
                               self._max_in_flight))
        return out

    def streaming_split(self, n: int, *, locality_hints=None) -> list["DataIterator"]:
        """n coordinated iterators over ONE streaming execution (one per
        train worker; blocks dealt on demand). ``locality_hints``: optional
        list of n node ids — consumer i is preferentially dealt blocks
        already resident on its node (reference: StreamSplitDataIterator's
        locality_hints)."""
        import ray_tpu_torch as rt

        if locality_hints is not None and len(locality_hints) != n:
            raise ValueError(
                f"locality_hints must have one entry per split ({n}), got {len(locality_hints)}"
            )
        coord_cls = rt.remote(_SplitCoordinator)
        coord = coord_cls.options(max_concurrency=max(4, n + 1)).remote(
            self._leaf, self._max_in_flight, locality_hints
        )
        return [DataIterator(coord, i, n) for i in builtins.range(n)]

    def __repr__(self):
        return f"Dataset(op={self._leaf.kind})"


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def batches_from_blocks(blocks: Iterator, batch_size: int,
                        batch_format: str, drop_last: bool) -> Iterator:
    """Re-slice a block stream into fixed-size batches (Arrow-level: no row
    boxing; carries remainders across block boundaries)."""
    buf: list = []
    buffered = 0
    for blk in blocks:
        if blk.num_rows == 0:
            continue
        buf.append(blk)
        buffered += blk.num_rows
        while buffered >= batch_size:
            merged = B.concat_blocks(buf)
            out = B.block_slice(merged, 0, batch_size)
            rest = B.block_slice(merged, batch_size, merged.num_rows)
            buf = [rest] if rest.num_rows else []
            buffered = rest.num_rows
            yield B.block_to_batch(out, batch_format)
    if buffered and not drop_last:
        yield B.block_to_batch(B.concat_blocks(buf), batch_format)


# ---------------------------------------------------------------------------
# Grouped data
# ---------------------------------------------------------------------------

class GroupedData:
    """Result of Dataset.groupby(key) — reference: grouped_data.py. Executes
    as a HASH SHUFFLE (map-side partition tasks + per-partition reduce over
    the object store, _internal/execution/operators/hash_shuffle.py), not a
    driver-side sort+materialize: each reduce task holds only its partition,
    so group state never concentrates in one process."""

    def __init__(self, ds: Dataset, key: str, num_partitions: Optional[int] = None):
        self._ds = ds
        self._key = key
        self._num_partitions = num_partitions

    def map_groups(self, fn: Callable[[list], Any]) -> Dataset:
        """fn(rows) -> row-dict | list of row-dicts, per group."""
        return self._ds._chain("hash_groupby", _normalize_group_fn(fn),
                               key=self._key, num_partitions=self._num_partitions)

    def _agg(self, agg_name: str, col: Optional[str]) -> Dataset:
        key = self._key

        def agg(key_value, rows, _col=col, _how=agg_name):
            out = {key: key_value}
            if _how == "count":
                out["count()"] = len(rows)
                return out
            vals = [r[_col] for r in rows]
            if _how == "sum":
                out[f"sum({_col})"] = sum(vals)
            elif _how == "mean":
                out[f"mean({_col})"] = sum(vals) / len(vals)
            elif _how == "min":
                out[f"min({_col})"] = min(vals)
            elif _how == "max":
                out[f"max({_col})"] = max(vals)
            return out
        return self._ds._chain("hash_groupby", agg, key=self._key,
                               num_partitions=self._num_partitions)

    def count(self) -> Dataset:
        return self._agg("count", None)

    def sum(self, col: str) -> Dataset:
        return self._agg("sum", col)

    def mean(self, col: str) -> Dataset:
        return self._agg("mean", col)

    def min(self, col: str) -> Dataset:
        return self._agg("min", col)

    def max(self, col: str) -> Dataset:
        return self._agg("max", col)


def _normalize_group_fn(fn):
    def agg(key_value, rows, _fn=fn):
        return _fn(rows)
    return agg


# ---------------------------------------------------------------------------
# Streaming split (train ingest)
# ---------------------------------------------------------------------------

class _SplitCoordinator:
    """Actor: executes the plan once per epoch, deals block refs on demand.

    Reference: SplitCoordinator inside stream_split_iterator.py:30 — same
    contract: n consumers, each next_block() call returns the next available
    block (dynamic balancing), None at end of epoch.
    """

    def __init__(self, leaf: LogicalOp, max_in_flight: int, locality_hints=None):
        import threading

        self.leaf = leaf
        self.max_in_flight = max_in_flight
        self.locality_hints = list(locality_hints) if locality_hints else None
        self.epoch = 0
        self.stream: Optional[Iterator] = None
        # Small look-ahead buffer of undealt refs: locality matching picks
        # from here; bounded so the coordinator never races far ahead.
        self._ready: list = []
        # Dealt refs stay pinned here until the next epoch: the consumer
        # borrows them from this actor (the owner), so dropping our handle
        # the moment it's dealt would race the borrower registration.
        self._dealt: list = []
        # The actor runs with max_concurrency > 1 so consumers never queue
        # behind each other's calls, but the stream generator itself is not
        # reentrant.
        self._lock = threading.Lock()

    def _block_nodes(self, ref) -> set:
        """Node ids currently holding this block (controller object
        directory); empty for inline/small objects."""
        from ray_tpu_torch.core import api

        try:
            core = api._require_worker()
            locs = core._run(
                core.controller.call("lookup_object", {"oid": ref.id.binary()}),
                timeout=5,
            )
            return {l["node_id"] for l in (locs or [])}
        except Exception:
            return set()

    def next_block(self, split_idx: int, epoch: int):
        with self._lock:
            if epoch > self.epoch:
                self.epoch = epoch
                self._dealt.clear()
                self._ready.clear()
                self.stream = StreamingExecutor(self.max_in_flight).execute(self.leaf)
            if epoch < self.epoch:
                return None  # stale epoch: that consumer's epoch is over
            # Refill the look-ahead buffer; locations resolved ONCE per ref
            # at append time (re-querying the controller per deal under the
            # lock would serialize all consumers behind repeated RPCs).
            want = self.max_in_flight if self.locality_hints else 1
            while self.stream is not None and len(self._ready) < want:
                try:
                    ref = next(self.stream)
                except StopIteration:
                    self.stream = None
                    break
                nodes = self._block_nodes(ref) if self.locality_hints else set()
                self._ready.append((ref, nodes))
            if not self._ready:
                return None
            pick = 0
            hint = self.locality_hints[split_idx] if self.locality_hints else None
            if hint is not None:
                for i, (_ref, nodes) in enumerate(self._ready):
                    if hint in nodes:
                        pick = i
                        break
            ref, _ = self._ready.pop(pick)
            self._dealt.append(ref)
            return ref


class DataIterator:
    """Per-train-worker handle onto a streaming split. Picklable: send it to
    a worker actor and call iter_batches() there (reference: DataIterator /
    StreamSplitDataIterator)."""

    def __init__(self, coordinator, split_idx: int, n_splits: int):
        self._coord = coordinator
        self._split = split_idx
        self._n = n_splits
        self._epoch = 0

    def iter_block_refs(self) -> Iterator:
        import ray_tpu_torch as rt

        self._epoch += 1
        epoch = self._epoch
        while True:
            ref = rt.get(self._coord.next_block.remote(self._split, epoch),
                         timeout=300)
            if ref is None:
                return
            yield ref

    def iter_blocks(self) -> Iterator:
        import ray_tpu_torch as rt

        for ref in self.iter_block_refs():
            yield rt.get(ref)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator:
        yield from batches_from_blocks(
            self.iter_blocks(), batch_size, batch_format, drop_last
        )

    def materialize(self) -> Dataset:
        refs = list(self.iter_block_refs())
        return Dataset(LogicalOp("source", params={"block_refs": refs}))


# ---------------------------------------------------------------------------
# Constructors (module-level read API — reference: read_api.py)
# ---------------------------------------------------------------------------

def _source_from_read_fns(read_fns: list, max_in_flight: int = 8) -> Dataset:
    return Dataset(LogicalOp("source", params={"read_fns": read_fns}),
                   max_in_flight)


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n) if n else 1)
    per = (n + parallelism - 1) // parallelism

    def make(lo, hi):
        def read():
            return B.block_from_batch({"id": np.arange(lo, hi, dtype=np.int64)})
        return read

    fns = [make(i * per, min((i + 1) * per, n)) for i in builtins.range(parallelism)
           if i * per < n]
    return _source_from_read_fns(fns or [make(0, 0)])


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    base = range(n, parallelism=parallelism)

    def to_tensor(batch, _shape=tuple(shape)):
        ids = batch["id"]
        data = np.broadcast_to(
            ids.reshape((-1,) + (1,) * len(_shape)), (len(ids),) + _shape
        ).copy()
        return {"id": ids, "data": data}
    return base.map_batches(to_tensor)


def from_items(items: list, *, parallelism: int = 8) -> Dataset:
    items = list(items)
    parallelism = max(1, min(parallelism, len(items)) if items else 1)
    per = (len(items) + parallelism - 1) // parallelism

    def make(chunk):
        def read():
            return B.block_from_rows(chunk)
        return read

    fns = [make(items[i * per:(i + 1) * per])
           for i in builtins.range(parallelism) if items[i * per:(i + 1) * per]]
    return _source_from_read_fns(fns or [make([])])


def from_blocks(blocks: list) -> Dataset:
    import ray_tpu_torch as rt

    refs = [rt.put(b) for b in blocks]
    return Dataset(LogicalOp("source", params={"block_refs": refs}))


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks(tables)


def from_pandas(dfs) -> Dataset:
    import pyarrow as pa

    if not isinstance(dfs, list):
        dfs = [dfs]
    return from_blocks([pa.Table.from_pandas(df, preserve_index=False)
                        for df in dfs])


def from_numpy(arrays) -> Dataset:
    if not isinstance(arrays, list):
        arrays = [arrays]
    return from_blocks([B.block_from_batch({"data": a}) for a in arrays])


def read_parquet(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.parquet_read_fns(paths), max_in_flight)


def read_csv(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.csv_read_fns(paths), max_in_flight)


def read_json(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.json_read_fns(paths), max_in_flight)


def read_text(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.text_read_fns(paths), max_in_flight)


def read_binary_files(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.binary_read_fns(paths), max_in_flight)


def read_numpy(paths, *, max_in_flight: int = 8) -> Dataset:
    return _source_from_read_fns(DS.numpy_read_fns(paths), max_in_flight)
