"""Actor-pool map_batches (reference: ActorPoolMapOperator,
actor_pool_map_operator.py:70) + the LLM batch-inference stage built on it
(reference: vLLMEngineStage, vllm_engine_stage.py:794).

The port's copy of ``tests/test_data_actor_pool.py``, case for case, on
``ray_tpu_torch``. ``test_llm_batch_generate`` runs the reference's tiny
model on the CPU (``device="cpu"``), is not marked slow (it takes seconds),
and also holds the pool's tokens to ``_EngineUDF`` called in this process
on the same blocks."""
import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401


@pytest.fixture(scope="module")
def pool_ray():
    rt.init(num_cpus=8)
    yield rt
    rt.shutdown()


class StatefulUDF:
    """Counts per-actor constructions + calls via instance state."""

    def __init__(self, bias):
        self.bias = bias
        self.calls = 0
        self.ident = f"{os.getpid()}-{id(self)}"

    def __call__(self, batch):
        self.calls += 1
        return {
            "id": batch["id"] + self.bias,
            "actor": np.array([self.ident] * len(batch["id"])),
            "call_no": np.array([self.calls] * len(batch["id"])),
        }


def test_actor_pool_constructs_once_and_reuses(pool_ray):
    ds = data.range(48, parallelism=12).map_batches(
        StatefulUDF, concurrency=2, fn_constructor_args=(100,)
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(100, 148))
    actors = {r["actor"] for r in rows}
    # 12 blocks ran on a FIXED pool of 2 stateful actors (one construction
    # each), so each actor served multiple blocks (state reuse).
    assert len(actors) <= 2
    assert max(r["call_no"] for r in rows) >= 3


def test_actor_pool_plain_function(pool_ray):
    ds = data.range(16, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 2}, compute="actors", concurrency=1
    )
    assert sorted(r["id"] for r in ds.take_all()) == [2 * i for i in range(16)]


def test_actor_pool_autoscales_within_bounds(pool_ray):
    ds = data.range(40, parallelism=10).map_batches(
        StatefulUDF, concurrency=(1, 3), fn_constructor_args=(0,)
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(40))
    assert 1 <= len({r["actor"] for r in rows}) <= 3


def test_class_udf_requires_no_explicit_compute(pool_ray):
    # A class fn implies compute="actors" (reference: map_batches(ClassUDF,
    # concurrency=N)).
    ds = data.range(8, parallelism=2).map_batches(
        StatefulUDF, concurrency=1, fn_constructor_args=(1,)
    )
    assert sorted(r["id"] for r in ds.take_all()) == list(range(1, 9))


class DieOnceUDF:
    """Kills its own worker process the first time it sees the marker file
    absent — the restarted actor (max_restarts) must finish the job."""

    def __init__(self, marker):
        self.marker = marker

    def __call__(self, batch):
        if not os.path.exists(self.marker):
            open(self.marker, "w").write("died")
            os._exit(1)
        return {"id": batch["id"]}


def test_pool_actor_failure_restarts_and_completes(pool_ray, tmp_path):
    marker = str(tmp_path / "died_once")
    ds = data.range(24, parallelism=6).map_batches(
        DieOnceUDF, concurrency=1, fn_constructor_args=(marker,)
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(24))
    assert os.path.exists(marker), "the failure injection never fired"


def test_fn_constructor_args_rejected_for_tasks(pool_ray):
    with pytest.raises(ValueError):
        data.range(4).map_batches(lambda b: b, fn_constructor_args=(1,))


# ---------------------------------------------------------------------------
# LLM batch inference stage
# ---------------------------------------------------------------------------

def test_llm_batch_generate(pool_ray):
    from ray_tpu_torch.llm import batch_generate
    from ray_tpu_torch.llm.batch import _EngineUDF

    prompts = ["hello world", "the quick brown fox", "hello world", "tpu go brrr"]
    ds = data.from_items([{"prompt": p, "i": i} for i, p in enumerate(prompts)],
                         parallelism=2)
    model = dict(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, attention_impl="reference",
    )
    engine = {"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32)}
    sampling = {"max_tokens": 8}
    out = batch_generate(ds, model_config=model, engine_config=engine, sampling=sampling,
                         concurrency=1, device="cpu")
    rows = sorted(out.take_all(), key=lambda r: r["i"])
    assert len(rows) == 4
    by_prompt = {}
    for r in rows:
        assert isinstance(r["generated_text"], str)
        assert len(r["generated_text_tokens"]) == 8  # greedy, no eos in tiny vocab
        by_prompt.setdefault(r["prompt"], set()).add(tuple(r["generated_text_tokens"]))
    # Same prompt in DIFFERENT blocks decodes identically (greedy engine
    # state is clean across blocks on the same pool actor).
    assert all(len(v) == 1 for v in by_prompt.values()), by_prompt
    # The pool actor's engine and one built here agree token for token, the
    # UDF called on the same blocks in the same order.
    udf = _EngineUDF(model, engine, sampling, None, "prompt", "generated_text", device="cpu")
    want = [r for blk in ds.iter_blocks() for r in udf(blk.to_pylist())]
    assert rows == sorted(want, key=lambda r: r["i"])
