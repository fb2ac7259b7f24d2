"""Hash-shuffle data operators: hash repartition, hash groupby, inner/left
join — map-side partition tasks + per-partition reduce over the object store
(reference: data/_internal/execution/operators/hash_shuffle.py, join.py) —
plus streaming_split locality hints and per-op in-flight budgets.

The port's copy of ``tests/test_data_shuffle.py``, case for case, on
``ray_tpu_torch``."""
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=8)
    yield
    rt.shutdown()


def test_hash_repartition_colocates_keys():
    ds = rd.from_items([{"k": i % 5, "v": i} for i in range(200)]).repartition(
        4, hash_key="k"
    )
    blocks = [b for b in ds.iter_blocks() if b.num_rows]
    assert len(blocks) == 4
    # Every key lives in exactly one block.
    seen = {}
    for bi, blk in enumerate(blocks):
        for k in set(blk.column("k").to_pylist()):
            assert k not in seen, f"key {k} split across blocks {seen[k]} and {bi}"
            seen[k] = bi
    assert sorted(seen) == [0, 1, 2, 3, 4]
    # No rows lost.
    assert sum(b.num_rows for b in blocks) == 200


def test_hash_groupby_agg_matches_naive():
    rows = [{"g": f"g{i % 7}", "x": float(i)} for i in range(211)]
    ds = rd.from_items(rows)
    got = {r["g"]: r["sum(x)"] for r in ds.groupby("g").sum("x").take_all()}
    want = {}
    for r in rows:
        want[r["g"]] = want.get(r["g"], 0.0) + r["x"]
    assert got == pytest.approx(want)
    counts = {r["g"]: r["count()"] for r in ds.groupby("g").count().take_all()}
    assert sum(counts.values()) == 211


def test_inner_join():
    users = rd.from_items([{"uid": i, "name": f"u{i}"} for i in range(30)])
    orders = rd.from_items(
        [{"uid": i % 40, "amount": float(i)} for i in range(100)]
    )
    joined = orders.join(users, on="uid").take_all()
    # Orders with uid >= 30 have no user: inner join drops them.
    expect_rows = sum(1 for i in range(100) if i % 40 < 30)
    assert len(joined) == expect_rows
    for r in joined:
        assert r["name"] == f"u{r['uid']}"


def test_left_join_keeps_unmatched():
    left = rd.from_items([{"k": i, "a": i} for i in range(10)])
    right = rd.from_items([{"k": i, "b": i * 10} for i in range(0, 10, 2)])
    out = left.join(right, on="k", how="left").take_all()
    assert len(out) == 10
    matched = [r for r in out if "b" in r and r.get("b") is not None]
    assert len(matched) == 5


def test_join_column_collision_suffix():
    left = rd.from_items([{"k": 1, "v": "L"}])
    right = rd.from_items([{"k": 1, "v": "R"}])
    (row,) = left.join(right, on="k").take_all()
    assert row["v"] == "L" and row["v_1"] == "R"


@pytest.mark.slow  # marked slow as in the reference suite (heavy battery)
def test_shuffle_beyond_memory_with_spill(tmp_path):
    """Groupby+join at > object-store scale: the 16MB store must spill to
    disk and the shuffle still completes exactly."""
    import os

    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    rt.shutdown()
    cfg = Config().apply_env()
    cfg.object_store_memory = 16 * 1024 * 1024
    cfg.object_spill_dir = str(tmp_path / "spill")
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=4)
    init(address=cluster.address, config=cfg)
    try:
        n_rows, payload = 6_000, 8_000  # ~48MB of payload through a 16MB store
        ds = rd.from_items(
            [{"g": i % 13, "i": i} for i in range(n_rows)], parallelism=24
        ).map(lambda r: {**r, "pad": "x" * payload})
        agg = {r["g"]: r["count()"] for r in ds.groupby("g").count().take_all()}
        assert sum(agg.values()) == n_rows
        assert os.path.isdir(cfg.object_spill_dir) and os.listdir(cfg.object_spill_dir), (
            "spill dir untouched: the test did not exceed memory"
        )
    finally:
        shutdown()
        cluster.shutdown()
        rt.init(num_cpus=8)  # restore module fixture session


def test_streaming_split_locality_hints():
    """Blocks are dealt preferentially to the consumer on the block's node;
    wrong-length hints rejected."""
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    rt.shutdown()
    cluster = Cluster(initialize_head=False)
    n1 = cluster.add_node(num_cpus=2)
    n2 = cluster.add_node(num_cpus=2)
    init(address=cluster.address)
    try:
        ds = rd.range(400).map_batches(lambda b: b)  # blocks land on both nodes
        with pytest.raises(ValueError, match="one entry per split"):
            ds.streaming_split(2, locality_hints=[n1.node_id])
        its = ds.streaming_split(2, locality_hints=[n1.node_id, n2.node_id])
        rows = []
        for it in its:
            for blk in it.iter_blocks():
                rows.extend(blk.column("id").to_pylist())
        assert sorted(rows) == list(range(400))
    finally:
        shutdown()
        cluster.shutdown()
        rt.init(num_cpus=8)


def test_per_op_budget_caps_inflight():
    """A budgets entry caps that stage's concurrency: with budget 1 the map
    stage never has 2 tasks in flight (observed via a shared marker dir)."""
    import os
    import tempfile
    import time

    from ray_tpu_torch.data.executor import StreamingExecutor

    marker = tempfile.mkdtemp()

    def slow_mark(batch):
        me = os.path.join(marker, f"{time.monotonic_ns()}")
        open(me, "w").close()
        live = len(os.listdir(marker))
        time.sleep(0.15)
        os.unlink(me)
        batch["live"] = np.full(len(next(iter(batch.values()))), live)
        return batch

    ds = rd.range(8).map_batches(slow_mark)
    ex = StreamingExecutor(max_in_flight=8, budgets={"map_batches": 1})
    out = [rt.get(r) for r in ex.execute(ds._leaf)]
    max_live = max(max(b.column("live").to_pylist()) for b in out if b.num_rows)
    assert max_live == 1, f"budget 1 but {max_live} tasks overlapped"


def test_join_across_numeric_dtypes():
    """int64 keys join float64 keys: equal values agree on a partition
    (dtype-canonicalized hashing), so matches are not silently dropped."""
    left = rd.from_items([{"k": i, "a": i} for i in range(12)])          # int keys
    right = rd.from_items([{"k": float(i), "b": i * 2} for i in range(12)])  # 1.0, 2.0...
    out = left.join(right, on="k").take_all()
    assert len(out) == 12, f"cross-dtype join dropped rows: {len(out)}"
    assert all(r["b"] == r["a"] * 2 for r in out)


def test_distributed_sort_multiblock_global_order():
    """Sample-sort (reference: SortTaskSpec sample->boundaries->partition->
    merge): many input blocks, output streams in GLOBAL key order as
    multiple range partitions — no task ever saw the whole dataset."""
    rng = np.random.default_rng(7)
    vals = rng.permutation(200).tolist()
    ds = rd.from_items([{"v": int(v), "tag": f"t{v}"} for v in vals], parallelism=10)
    out_blocks = [rt.get(r) for r in ds.sort("v").iter_block_refs()]
    # Multiple range partitions, each a separate merge task's output.
    nonempty = [b for b in out_blocks if b.num_rows]
    assert len(nonempty) > 1, "sort collapsed to a single task"
    assert max(b.num_rows for b in nonempty) < 200, \
        "one sort task materialized the whole dataset"
    rows = [r for b in nonempty for r in b.to_pylist()]
    assert [r["v"] for r in rows] == sorted(vals)
    assert all(r["tag"] == f"t{r['v']}" for r in rows)  # rows stay intact


def test_distributed_sort_descending_and_strings():
    words = ["pear", "apple", "fig", "kiwi", "lime", "date", "plum", "mango"] * 5
    ds = rd.from_items([{"w": w, "i": i} for i, w in enumerate(words)], parallelism=8)
    got = [r["w"] for r in ds.sort("w", descending=True).take_all()]
    assert got == sorted(words, reverse=True)


def test_distributed_sort_skewed_keys():
    """Heavy key skew (duplicate boundaries) must not lose or duplicate
    rows."""
    vals = [1] * 50 + [2] * 3 + [99] * 20
    ds = rd.from_items([{"v": v} for v in vals], parallelism=8)
    got = [r["v"] for r in ds.sort("v").take_all()]
    assert got == sorted(vals)
