"""The port's copy of ``tests/test_llm_tp.py``: tensor-parallel serving.

The engine sharded over a ``tensor`` mesh (params Megatron-split, KV pools
split by kv_heads) must produce the same greedy output as the one-slot
engine, for both KV layouts, and a serve replica must gang-schedule onto a
node advertising the TP degree's GPUs (the reference's chips: fake ``GPU:
2`` here for its ``TPU: 2``). Runs on 8 CPU slots of one process
(``RAY_TPU_TORCH_DEVICE_SLOTS=8``, set before every ``rt.init`` so the
workers, which inherit the environment, see them too).
"""
import numpy as np
import pytest
import torch

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import TransformerConfig

CFG = TransformerConfig(
    vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq_len=128, dtype=torch.float32, attention_impl="reference",
)
MODEL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
             attention_impl="reference", dtype=torch.float32)
PROMPT = [5, 17, 42, 7, 23, 11, 2]


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_SLOTS", "8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread (torch's default of one per core
    oversubscribes the CPU when the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(tp: int, layout: str, **ec_kw) -> LLMEngine:
    kw = dict(max_slots=4, max_seq=128, prefill_buckets=(16, 32), kv_layout=layout, tensor_parallel=tp)
    if layout == "paged":
        kw["page_size"] = 32
    kw.update(ec_kw)
    return LLMEngine(CFG, engine_config=EngineConfig(**kw), device="cpu")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp_greedy_matches_single_device(layout):
    """mesh=tensor(2) must not change greedy output vs one slot."""
    ref = _engine(1, layout).generate(PROMPT, max_tokens=10)["tokens"]
    tp = _engine(2, layout).generate(PROMPT, max_tokens=10)["tokens"]
    assert tp == ref, f"{layout}: TP output diverged: {tp} vs {ref}"


def test_tp_actually_shards_params_and_kv():
    eng = _engine(2, "paged")
    wq = eng.params["layers"]["wq"]  # [L, D, H, Hd]: heads sharded
    assert wq.addressable_shards[0].data.shape[2] == CFG.n_heads // 2
    mlp = eng.params["layers"]["w_gate"]  # [L, D, F]: ffn hidden sharded
    assert mlp.addressable_shards[0].data.shape[2] == CFG.d_ff // 2
    # Paged KV pool [L, KV, pages*ps, Hd]: kv_heads sharded.
    assert eng.k_pages.addressable_shards[0].data.shape[1] == CFG.kv_heads // 2
    dense = _engine(2, "dense")
    # Dense cache [L, B, S, KV, Hd]: kv_heads sharded.
    assert dense.k_pages.addressable_shards[0].data.shape[3] == CFG.kv_heads // 2


def test_tp_weight_handoff_through_object_store():
    """train->serve handoff of a TP-sharded param tree through the object
    store: every leaf ships one out-of-band buffer per unique shard (no host
    gather; core/serialization.py), and an engine built from the fetched
    tree serves the same greedy output."""
    import ray_tpu_torch as rt

    src = _engine(2, "dense")
    ref_out = src.generate(PROMPT, max_tokens=10)["tokens"]
    wq = src.params["layers"]["wq"]
    assert len(wq.master_slots()) == 2  # really sharded going in

    rt.init(num_cpus=2)
    try:
        ref = rt.put(src.params)
        fetched = rt.get(ref, timeout=120)
    finally:
        rt.shutdown()
    # Shards survived the hop: same per-slot layout, no gather artifact.
    fq = fetched["layers"]["wq"]
    assert len(fq.master_slots()) == 2
    assert fq.addressable_shards[0].data.shape == wq.addressable_shards[0].data.shape
    served = LLMEngine(CFG, params=fetched, engine_config=EngineConfig(
        max_slots=4, max_seq=128, prefill_buckets=(16, 32), kv_layout="dense", tensor_parallel=2), device="cpu")
    assert served.generate(PROMPT, max_tokens=10)["tokens"] == ref_out


def test_tp_params_ref_served_through_deployment():
    """The wired train->serve path: build_llm_app(params=ObjectRef); the
    replica (another worker process) fetches the sharded tree from the
    object store and serves it, output matching the source engine."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app

    src = _engine(2, "dense")
    ref_out = src.generate(PROMPT, max_tokens=8)["tokens"]

    rt.init(num_cpus=8, resources={"GPU": 2.0})
    try:
        serve.start(proxy=False)
        ref = rt.put(src.params)
        app = build_llm_app(
            model_config=MODEL,
            engine_config={"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32), "kv_layout": "dense",
                           "tensor_parallel": 2},
            params=ref, device="cpu",
        )
        serve.run(app, name="tp-handoff", http=False)
        h = serve.get_deployment_handle("llm", "tp-handoff")
        out = h.generate.remote(PROMPT, 8).result(timeout=300)
        assert out["tokens"] == ref_out, (out["tokens"], ref_out)
        serve.delete("tp-handoff")
    finally:
        serve.shutdown()
        rt.shutdown()


def test_tp_rejects_indivisible_model():
    with pytest.raises(ValueError, match="not divisible"):
        _engine(4, "dense")  # kv_heads=2 % 4 != 0


def test_tp_mixed_batch_and_sampling():
    """Continuous batching under TP: concurrent requests with different
    per-request sampling params behave like the one-slot engine."""
    from ray_tpu_torch.llm.sampling import SamplingParams

    eng = _engine(2, "paged")
    eng.add_request("greedy", PROMPT, 8, sampling=SamplingParams(temperature=0.0, max_tokens=8))
    eng.add_request("hot", list(reversed(PROMPT)), 8,
                    sampling=SamplingParams(temperature=0.9, top_k=20, max_tokens=8))
    done = {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("finished"):
                done[rid] = ev["tokens"]
    ref = _engine(1, "paged").generate(PROMPT, 8, sampling=SamplingParams(temperature=0.0, max_tokens=8))["tokens"]
    assert done["greedy"] == ref
    assert len(done["hot"]) == 8


def test_tp_prefix_cache_hit_correct():
    """The prefix cache's page copy works on a kv_heads-sharded pool (the
    copy slices the token axis; the sharded axis rides along)."""
    eng = _engine(2, "paged", prefix_cache=True, temperature=0.0)
    cold = eng.generate(PROMPT, max_tokens=8)["tokens"]
    warm = eng.generate(PROMPT, max_tokens=8)["tokens"]
    assert eng.prefix_cache_stats["hits"] == 1
    assert warm == cold


def test_tp_serve_replica_gang():
    """A TP-2 deployment declares 2 GPUs; the replica lands on the node
    advertising them and serves correctly."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app

    rt.init(num_cpus=8, resources={"GPU": 2.0})
    serve.start(proxy=False)
    try:
        app = build_llm_app(
            model_config=MODEL,
            engine_config={"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32), "tensor_parallel": 2},
            device="cpu",
        )
        handle = serve.run(app, name="llm_tp_app", http=False)
        out = handle.remote({"tokens": PROMPT, "max_tokens": 8}).result(timeout=300)
        assert len(out["tokens"]) == 8
        # The gang reservation is real: the GPU capacity is now held, so a
        # second TP-2 replica cannot also fit on this 2-GPU node.
        from ray_tpu_torch.core import api

        state = api._cluster_state()
        gpu_avail = [n.get("available", {}).get("GPU", 0.0) for n in state["nodes"].values()
                     if n["state"] == "ALIVE"]
        assert max(gpu_avail, default=0.0) == 0.0, gpu_avail
        serve.delete("llm_tp_app")
    finally:
        serve.shutdown()
        rt.shutdown()


def test_tp_chunked_prefill_matches_single_device():
    """Chunked prefill under TP (a 79-token prompt in chunks of 32 over the
    kv_heads-sharded pool) gives the one-slot engine's greedy tokens."""
    prompt = list(range(1, 80))
    ref = _engine(1, "paged", chunked_prefill=32).generate(prompt, max_tokens=6)["tokens"]
    assert _engine(2, "paged", chunked_prefill=32).generate(prompt, max_tokens=6)["tokens"] == ref


def test_tp_greedy_tokens_are_numpy_comparable():
    """The TP engine's tokens are plain ints (the sampler's gathered logits
    are one full-vocabulary row per request)."""
    out = _engine(2, "paged").generate(np.asarray(PROMPT, np.int32), max_tokens=4)["tokens"]
    assert all(isinstance(t, int) and 0 <= t < CFG.vocab_size for t in out)
