"""``ray_tpu_torch.data`` against ``ray_tpu.data``: the same seeded pipelines
through both packages give the same rows, in the same order wherever the
operation fixes one (map, filter, a seeded shuffle, sort, zip, a join's
partitions, each consumer of a streaming split); the rows of a groupby are
compared as a set of rows.

One runtime at a time: the reference's session runs every pipeline and
shuts down, then the port's does the same (``outputs``), and each case
compares one pipeline's two results.
"""
import numpy as np
import pytest

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

SEED = 11
N = 96


def _items():
    rng = np.random.default_rng(SEED)
    return [{"id": i, "x": float(v), "g": int(k)}
            for i, (v, k) in enumerate(zip(rng.standard_normal(N), rng.integers(0, 5, N)))]


class Affine:
    """A class UDF (so an actor-pool stage): x * scale + id, per block."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, batch):
        return {"id": batch["id"], "y": batch["x"] * self.scale + batch["id"]}


def _map(rd, tmp):
    return rd.from_items(_items(), parallelism=4).map(lambda r: {"id": r["id"], "x2": r["x"] * 2}).take_all()


def _map_batches_tasks(rd, tmp):
    return rd.from_items(_items(), parallelism=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["x"] ** 2}).take_all()


def _map_batches_actors(rd, tmp):
    return rd.from_items(_items(), parallelism=6).map_batches(
        Affine, concurrency=2, fn_constructor_args=(0.5,)).take_all()


def _filter(rd, tmp):
    return rd.from_items(_items(), parallelism=4).filter(lambda r: r["x"] > 0).take_all()


def _random_shuffle(rd, tmp):
    return rd.from_items(_items(), parallelism=4).random_shuffle(seed=SEED).take_all()


def _sort(rd, tmp):
    return rd.from_items(_items(), parallelism=6).sort("x", descending=True).take_all()


def _groupby(rd, tmp):
    rows = rd.from_items(_items(), parallelism=4).groupby("g").sum("x").take_all()
    return sorted(rows, key=lambda r: r["g"])


def _join_float_key(rd, tmp):
    # Fractional float keys: _stable_partition_ids routes them by the crc32
    # of their repr (integral floats would take the integer route).
    left = rd.from_items([{"k": i + 0.25, "a": i} for i in range(40)], parallelism=3)
    right = rd.from_items([{"k": i + 0.25, "b": -i} for i in range(0, 40, 3)], parallelism=2)
    return left.join(right, on="k", num_partitions=4).take_all()


def _zip(rd, tmp):
    a = rd.from_items(_items(), parallelism=4)
    b = rd.range(N, parallelism=3).map(lambda r: {"sq": r["id"] ** 2})
    return a.zip(b).take_all()


def _streaming_split(rd, tmp):
    it0, it1 = rd.from_items(_items(), parallelism=8).streaming_split(2)
    gens = [it0.iter_blocks(), it1.iter_blocks()]
    out = [[], []]
    live = [True, True]
    while any(live):  # the consumers pull in turn
        for i, g in enumerate(gens):
            if live[i]:
                try:
                    out[i].extend(next(g).to_pylist())
                except StopIteration:
                    live[i] = False
    return out


def _parquet_roundtrip(rd, tmp):
    d = str(tmp / "pq")
    paths = rd.from_items(_items(), parallelism=4).write_parquet(d)
    return [len(paths), rd.read_parquet(d).sort("id").take_all()]


PIPELINES = {f.__name__.lstrip("_"): f for f in (
    _map, _map_batches_tasks, _map_batches_actors, _filter, _random_shuffle, _sort, _groupby,
    _join_float_key, _zip, _streaming_split, _parquet_roundtrip)}


def _run_all(pkg, rd, tmp):
    pkg.init(num_cpus=4)
    try:
        out = {}
        for name, fn in PIPELINES.items():
            d = tmp / name
            d.mkdir()
            out[name] = fn(rd, d)
        return out
    finally:
        pkg.shutdown()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    import ray_tpu
    import ray_tpu.data
    import ray_tpu_torch
    import ray_tpu_torch.data

    want = _run_all(ray_tpu, ray_tpu.data, tmp_path_factory.mktemp("reference"))
    got = _run_all(ray_tpu_torch, ray_tpu_torch.data, tmp_path_factory.mktemp("port"))
    return want, got


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_matches_ray_tpu_data(outputs, name):
    want, got = outputs
    assert got[name] == want[name]
    assert got[name], "the pipeline produced nothing"


def test_same_public_surface():
    import ray_tpu.data
    import ray_tpu_torch.data

    assert ray_tpu_torch.data.__all__ == ray_tpu.data.__all__
