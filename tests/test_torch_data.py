"""The port's Data layer (``ray_tpu_torch.data``) held to the reference's own
suite, ``tests/test_data.py``, case for case: the Dataset API, execution,
splits and ingest on the port's runtime.

One case differs where the reference reaches a part the port replaces:
``test_prefetch_to_device`` asks for ``device="cpu"`` and requires
``torch.Tensor`` leaves where the reference requires ``jax.Array``.
"""
import os

import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401


def test_range_count_take(shared_ray):
    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_from_items_map(shared_ray):
    ds = rd.from_items([{"x": i} for i in range(10)], parallelism=3)
    out = ds.map(lambda r: {"y": r["x"] * 2}).take_all()
    assert sorted(r["y"] for r in out) == [i * 2 for i in range(10)]


def test_map_batches_numpy(shared_ray):
    ds = rd.range(16, parallelism=2)

    def double(batch):
        assert isinstance(batch["id"], np.ndarray)
        assert batch["id"].dtype == np.int64
        return {"id": batch["id"], "sq": batch["id"].astype(np.float32) ** 2}

    out = ds.map_batches(double).take_all()
    assert {r["id"] for r in out} == set(range(16))
    assert all(abs(r["sq"] - r["id"] ** 2) < 1e-6 for r in out)


def test_filter_flat_map(shared_ray):
    ds = rd.range(10, parallelism=2).filter(lambda r: r["id"] % 2 == 0)
    assert sorted(r["id"] for r in ds.take_all()) == [0, 2, 4, 6, 8]
    ds2 = rd.from_items([{"n": 2}, {"n": 3}]).flat_map(
        lambda r: [{"v": r["n"]}] * r["n"]
    )
    assert sorted(r["v"] for r in ds2.take_all()) == [2, 2, 3, 3, 3]


def test_parquet_roundtrip(shared_ray, tmp_path):
    d = str(tmp_path / "pq")
    rd.range(50, parallelism=4).map(
        lambda r: {"id": r["id"], "val": float(r["id"]) * 0.5}
    ).write_parquet(d)
    assert len(os.listdir(d)) >= 1
    back = rd.read_parquet(d)
    assert back.count() == 50
    rows = back.sort("id").take_all()
    assert rows[10]["val"] == 5.0


def test_csv_roundtrip(shared_ray, tmp_path):
    d = str(tmp_path / "csv")
    rd.from_items([{"a": i, "b": f"s{i}"} for i in range(12)]).write_csv(d)
    back = rd.read_csv(d)
    rows = back.sort("a").take_all()
    assert len(rows) == 12 and rows[3]["b"] == "s3"


def test_json_roundtrip(shared_ray, tmp_path):
    d = str(tmp_path / "js")
    rd.from_items([{"k": i} for i in range(7)]).write_json(d)
    back = rd.read_json(d)
    assert sorted(r["k"] for r in back.take_all()) == list(range(7))


def test_read_text(shared_ray, tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    rows = rd.read_text(str(p)).take_all()
    assert [r["text"] for r in rows] == ["alpha", "beta", "gamma"]


def test_repartition_stats(shared_ray):
    ds = rd.range(40, parallelism=2).repartition(5)
    st = ds.stats()
    assert st["num_blocks"] == 5
    assert st["num_rows"] == 40


def test_random_shuffle(shared_ray):
    ds = rd.range(64, parallelism=4).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(64))
    assert vals != list(range(64))  # astronomically unlikely to be identity


def test_sort(shared_ray):
    ds = rd.from_items([{"v": x} for x in [5, 1, 4, 2, 3]]).sort("v")
    assert [r["v"] for r in ds.take_all()] == [1, 2, 3, 4, 5]
    dsd = rd.from_items([{"v": x} for x in [5, 1, 4]]).sort("v", descending=True)
    assert [r["v"] for r in dsd.take_all()] == [5, 4, 1]


def test_groupby(shared_ray):
    ds = rd.from_items([{"k": i % 3, "v": i} for i in range(12)], parallelism=3)
    counts = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 4, 1: 4, 2: 4}
    sums = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take_all()}
    assert sums == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    top = ds.groupby("k").map_groups(
        lambda rows: {"k": rows[0]["k"], "top": max(r["v"] for r in rows)}
    ).take_all()
    assert {r["k"]: r["top"] for r in top} == {0: 9, 1: 10, 2: 11}


def test_limit_union(shared_ray):
    a = rd.range(10, parallelism=2)
    b = rd.from_items([{"id": 100 + i} for i in range(5)])
    u = a.union(b)
    assert u.count() == 15
    assert len(a.limit(4).take_all()) == 4


def test_iter_batches(shared_ray):
    ds = rd.range(25, parallelism=3)
    batches = list(ds.iter_batches(batch_size=10))
    sizes = [len(b["id"]) for b in batches]
    assert sum(sizes) == 25
    assert all(s == 10 for s in sizes[:-1])
    dropped = list(ds.iter_batches(batch_size=10, drop_last=True))
    assert all(len(b["id"]) == 10 for b in dropped)
    assert sum(len(b["id"]) for b in dropped) == 20


def test_from_converters(shared_ray):
    import pandas as pd
    import pyarrow as pa

    dsp = rd.from_pandas(pd.DataFrame({"a": [1, 2, 3]}))
    assert dsp.count() == 3
    dsa = rd.from_arrow(pa.table({"b": [4, 5]}))
    assert sorted(r["b"] for r in dsa.take_all()) == [4, 5]
    dsn = rd.from_numpy(np.ones((4, 2), np.float32))
    batch = dsn.take_batch(4)
    assert batch["data"].shape == (4, 2)


def test_nd_tensor_columns(shared_ray):
    ds = rd.range_tensor(6, shape=(2, 3), parallelism=2)
    batch = ds.take_batch(6)
    assert batch["data"].shape == (6, 2, 3)
    assert batch["data"].dtype != object


def test_column_ops(shared_ray):
    ds = rd.from_items([{"a": i, "b": i * 2} for i in range(6)])
    added = ds.add_column("c", lambda r: r["a"] + r["b"]).take_all()
    assert all(r["c"] == r["a"] + r["b"] for r in added)
    only_a = ds.select_columns(["a"]).schema()
    assert only_a.names == ["a"]
    no_b = ds.drop_columns(["b"]).schema()
    assert "b" not in no_b.names


def test_streaming_split_disjoint_and_epochs(shared_ray):
    ds = rd.range(40, parallelism=8)
    it0, it1 = ds.streaming_split(2)
    # Interleave pulls so both consumers get a share of the stream.
    g0, g1 = it0.iter_block_refs(), it1.iter_block_refs()
    rows0, rows1 = [], []
    done0 = done1 = False
    while not (done0 and done1):
        if not done0:
            try:
                rows0.extend(rd.dataset.B.block_rows(rt.get(next(g0))))
            except StopIteration:
                done0 = True
        if not done1:
            try:
                rows1.extend(rd.dataset.B.block_rows(rt.get(next(g1))))
            except StopIteration:
                done1 = True
    ids0 = {r["id"] for r in rows0}
    ids1 = {r["id"] for r in rows1}
    assert ids0 | ids1 == set(range(40))
    assert not (ids0 & ids1)  # exactly-once across splits
    assert ids0 and ids1      # both actually consumed
    # Second epoch replays the whole dataset.
    total2 = sum(
        b.num_rows for it in (it0, it1) for b in it.iter_blocks()
    )
    assert total2 == 40


def test_train_ingest_end_to_end(shared_ray, tmp_path):
    """The full path: parquet on disk -> Dataset -> streaming_split across a
    2-worker gang -> get_dataset_shard().iter_batches() in the train fn."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    d = str(tmp_path / "ingest")
    rd.range(64, parallelism=8).map(
        lambda r: {"id": r["id"], "w": float(r["id"])}
    ).write_parquet(d)
    ds = rd.read_parquet(d)

    seen_dir = str(tmp_path / "seen")
    os.makedirs(seen_dir, exist_ok=True)

    def train_fn(config):
        import json

        shard = train.get_dataset_shard("train")
        ctx = train.get_context()
        seen = []
        for batch in shard.iter_batches(batch_size=8):
            seen.extend(int(x) for x in batch["id"])
        with open(os.path.join(config["seen_dir"],
                               f"rank{ctx.get_world_rank()}.json"), "w") as f:
            json.dump(seen, f)
        train.report({"n": len(seen)})

    trainer = DataParallelTrainer(
        train_fn,
        train_loop_config={"seen_dir": seen_dir},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path / "st")),
        datasets={"train": ds},
    )
    result = trainer.fit()
    assert result.error is None, result.error
    import json

    all_ids, per_rank = [], []
    for fname in sorted(os.listdir(seen_dir)):
        with open(os.path.join(seen_dir, fname)) as f:
            ids = json.load(f)
        per_rank.append(len(ids))
        all_ids.extend(ids)
    assert sorted(all_ids) == list(range(64))  # exactly-once across the gang
    assert len(per_rank) == 2


def test_prefetch_to_device(shared_ray):
    import torch

    from ray_tpu_torch.data.infeed import prefetch_to_device

    ds = rd.range(32, parallelism=2)
    batches = ds.iter_batches(batch_size=8)
    out = list(prefetch_to_device(batches, size=2, device="cpu"))
    assert len(out) == 4
    assert all(isinstance(b["id"], torch.Tensor) and b["id"].device.type == "cpu" for b in out)
    assert int(out[0]["id"].sum() + out[1]["id"].sum()
               + out[2]["id"].sum() + out[3]["id"].sum()) == sum(range(32))


def test_zip(shared_ray):
    import ray_tpu_torch.data as rd

    a = rd.range(20)
    b = rd.range(20).map(lambda r: {"sq": r["id"] ** 2})
    rows = a.zip(b).take_all()
    assert len(rows) == 20
    assert all(r["sq"] == r["id"] ** 2 for r in rows)


def test_zip_name_collision_and_length_mismatch(shared_ray):
    import pytest as _pytest

    import ray_tpu_torch.data as rd

    rows = rd.range(5).zip(rd.range(5)).take_all()
    assert set(rows[0]) == {"id", "id_1"}
    with _pytest.raises(Exception, match="equal row counts"):
        rd.range(4).zip(rd.range(5)).take_all()


def test_random_sample(shared_ray):
    import ray_tpu_torch.data as rd

    n = rd.range(2000).random_sample(0.25, seed=7).count()
    assert 350 < n < 650  # ~500 expected


def test_iter_torch_batches(shared_ray):
    import torch

    import ray_tpu_torch.data as rd

    batches = list(rd.range(100).iter_torch_batches(batch_size=40))
    assert all(isinstance(b["id"], torch.Tensor) for b in batches)
    assert sum(len(b["id"]) for b in batches) == 100


def test_to_pandas(shared_ray):
    import ray_tpu_torch.data as rd

    df = rd.range(10).map(lambda r: {"id": r["id"], "y": r["id"] * 2}).to_pandas()
    assert len(df) == 10 and list(df.columns) == ["id", "y"]
    assert (df["y"] == df["id"] * 2).all()


# ---------------------------------------------------------------------------
# The port's own seams (no counterpart in the reference's suite)
# ---------------------------------------------------------------------------

def test_torch_tensor_columns_land_on_the_host(shared_ray):
    """A map_batches UDF may return torch tensor columns: they land in the
    block as host values, bf16 carried as fp32 (exactly, then stored as a
    numpy UDF's fp32 column is); a tensor inside a row is refused before
    anything reaches the store."""
    import torch

    def as_torch(batch):
        ids = torch.as_tensor(batch["id"].copy())
        return {"id": ids, "half": (ids.float() / 2).bfloat16()[:, None].repeat(1, 3)}

    rows = rd.range(8, parallelism=2).map_batches(as_torch).take_all()
    assert [r["id"] for r in rows] == list(range(8))
    assert all(r["half"] == [r["id"] / 2] * 3 for r in rows)
    batch = rd.range(8, parallelism=2).map_batches(as_torch).take_batch(8)
    # The fp32 values, as a numpy UDF's fp32 column would store them.
    assert batch["half"].shape == (8, 3)
    assert np.array_equal(batch["half"], np.repeat((np.arange(8) / 2)[:, None], 3, 1))

    from ray_tpu_torch.data import block as B

    with pytest.raises(TypeError, match="inside a row"):
        B.block_from_rows([{"t": torch.ones(2, dtype=torch.bfloat16)}])
    with pytest.raises(Exception):
        rd.range(4).map(lambda r: {"t": torch.ones(2, dtype=torch.bfloat16)}).take_all()


def test_block_crosses_the_store_intact(shared_ray):
    """An Arrow block (fixed-width, string, nested list and null-bearing
    columns) comes back from the object store and from a task equal to the
    table that went in."""
    import pyarrow as pa

    rng = np.random.default_rng(3)
    n = 50_000  # large enough to leave the inline path for shared memory
    table = pa.table({
        "f": rng.standard_normal(n),
        "i": rng.integers(-9, 9, n, dtype=np.int32),
        "s": [f"s{i}" for i in range(n)],
        "l": pa.array([[i, i + 1] for i in range(n)]),
        "o": pa.array([None if i % 7 else i for i in range(n)]),
    })
    assert rt.get(rt.put(table), timeout=60).equals(table)

    @rt.remote
    def echo(t):
        return t

    assert rt.get(echo.remote(rt.put(table)), timeout=60).equals(table)


def test_prefetch_to_device_defaults_to_the_gpu(shared_ray):
    import torch

    from ray_tpu_torch.data.infeed import prefetch_to_device

    it = prefetch_to_device(iter([{"x": np.arange(3)}]))
    if torch.cuda.is_available():
        assert next(it)["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(it)


@pytest.mark.parametrize("case", ["float64", "int64", "bool", "bfloat16_ml", "torch_bf16", "torch_int32",
                                  "ml_dtypes_missing"])
def test_is_float_dtype(case, monkeypatch):
    """The port's copy of ``ray_tpu.util.dtypes.is_float_dtype``: numpy's
    and ml_dtypes' floats (bfloat16 is kind 'V' to numpy), torch's floating
    dtypes, and False, never an error, when ml_dtypes is missing."""
    import sys

    import torch

    from ray_tpu_torch.util.dtypes import is_float_dtype

    if case == "bfloat16_ml":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        assert is_float_dtype(ml_dtypes.bfloat16)
    elif case == "ml_dtypes_missing":
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import raises ImportError
        assert is_float_dtype(np.float32) and not is_float_dtype(np.dtype("V2"))
    elif case.startswith("torch_"):
        assert is_float_dtype(getattr(torch, case[6:].replace("bf16", "bfloat16"))) == (case == "torch_bf16")
    else:
        assert is_float_dtype(np.dtype(case)) == (case == "float64")
