"""The parallel paths on the card: K1 and K4 per head shard in the
tensor-parallel engine (its prefill and decode logits against the one-slot
engine's, K4 per slot against its plain version), K1 / K3 / K2 per slot in
a Ulysses training step, and every slot's shard its own contiguous, 16-byte
aligned allocation (the TMA descriptors of K1-K3 and K4's loads need it;
the wrappers raise, never fall back, on anything else).

Runs only where a CUDA device exists (``-m cuda``; on the chip machine run
it with ``--noconftest``, the repo conftest imports jax); elsewhere each
test skips with the reason. The slots are 2 slots of ``cuda:0``
(``RAY_TPU_TORCH_DEVICE_SLOTS=2``). ``python3 chip_smoke.py`` phases 6j and
7j run the same paths at the 250M model's full width.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MODEL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=512)


@pytest.fixture
def two_slots(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_SLOTS", "2")


def _tp_engine(tp):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig

    return LLMEngine(TransformerConfig(**MODEL), engine_config=EngineConfig(
        max_slots=4, max_seq=512, kv_layout="paged", page_size=64, prefill_buckets=(128,), tensor_parallel=tp))


def test_tp_engine_launches_k1_and_k4_per_head_shard(two_slots):
    """K1 once per slot per layer for each prefill group, K4 once per slot
    per layer for each decode step; the prefill logits within bf16 bounds
    of the one-slot engine's (max 0.25, mean 0.02: phase 6's)."""
    from ray_tpu_torch.ops import attention, paged_attention

    prompt = np.random.default_rng(0).integers(0, MODEL["vocab_size"], 128).astype(np.int32)
    eng = _tp_engine(2)
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    out = eng.generate(prompt, max_tokens=8)
    assert len(out["tokens"]) == 8
    L = MODEL["n_layers"]
    assert attention.LAUNCHES == 2 * L  # one prefill group
    assert paged_attention.LAUNCHES % (2 * L) == 0 and paged_attention.LAUNCHES > 0
    third = np.zeros((1, 2), np.int32)
    got = eng._prefill_logits(prompt[None], np.array([128], np.int32), third)
    want = _tp_engine(1)._prefill_logits(prompt[None], np.array([128], np.int32), third)
    diff = (got - want).abs()
    assert float(diff.max()) <= 0.25 and float(diff.mean()) <= 0.02


def _sampled(eng, prompt, forced=None):
    """eng.generate(prompt) with its sampler recorded: every call's fp32
    logits and tokens; with ``forced`` (an earlier recording) the sampler
    returns that run's tokens, so this engine decodes the same stream."""
    calls = []
    sample = eng._sample

    def recorded(logits, *a):
        toks = sample(logits, *a) if forced is None else forced[len(calls)][1]
        calls.append((logits.float(), toks))
        return toks

    eng._sample = recorded
    eng.generate(prompt, max_tokens=16)
    del eng._sample
    return calls


def test_tp_decode_logits_on_the_one_slot_stream(two_slots):
    """The one-slot engine's greedy tokens forced into the TP-2 engine:
    the prefill's and every decode step's logits of the request (slot 0)
    within phase 6's bf16 bounds of the one-slot engine's (max 0.25, mean
    0.02)."""
    prompt = np.random.default_rng(1).integers(0, MODEL["vocab_size"], 128).astype(np.int32)
    ref = _sampled(_tp_engine(1), prompt)
    got = _sampled(_tp_engine(2), prompt, forced=ref)
    assert len(got) == len(ref) >= 2  # the prefill's call, then the decode steps'
    for (g, _), (w, _) in zip(got, ref):
        diff = (g[0] - w[0]).abs()
        assert bool(torch.isfinite(g[0]).all())
        assert float(diff.max()) <= 0.25 and float(diff.mean()) <= 0.02


def test_k4_per_head_shard_matches_plain_version(two_slots):
    """paged_attention's mesh branch at TP 2 (2 heads and 1 KV head a slot):
    each slot's K4 output against paged_attention_reference on the same q
    and pool shards, within 2e-2 (bf16 inputs, as chip_smoke's K4 phase)."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.parallel import MeshSpec, devices
    from ray_tpu_torch.parallel.sharding import NamedSharding, device_put
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = MeshSpec(tensor=2).build(devices())
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(3, 4, 64, generator=g, device="cuda").bfloat16()
    kp = torch.randn(2, 9, 64, 64, generator=g, device="cuda").bfloat16()
    vp = torch.randn(2, 9, 64, 64, generator=g, device="cuda").bfloat16()
    lens = torch.tensor([0, 70, 256], dtype=torch.int32, device="cuda")
    table = torch.tensor([[0, 0, 0, 0], [3, 7, 0, 0], [1, 2, 5, 8]], dtype=torch.int32, device="cuda")
    pool = NamedSharding(mesh, P("tensor", None, None, None))
    qs, kps, vps = device_put(q, NamedSharding(mesh, P(None, "tensor", None))), device_put(kp, pool), device_put(vp, pool)
    pa.LAUNCHES = 0
    o = pa.paged_attention(qs, kps, vps, lens, table, mesh=mesh)
    assert pa.LAUNCHES == 2
    for so, sq, sk, sv in zip(o.addressable_shards, qs.addressable_shards, kps.addressable_shards,
                              vps.addressable_shards):
        assert so.data.shape == (3, 2, 64) and sk.data.shape[0] == 1
        want = pa.paged_attention_reference(sq.data.float(), sk.data.float(), sv.data.float(), lens, table)
        assert float((so.data.float() - want).abs().max()) <= 2e-2


def test_every_slot_shard_is_contiguous_and_aligned(two_slots):
    eng = _tp_engine(2)
    leaves = [eng.params["embed"], eng.params["final_norm"], eng.params["lm_head"], eng.k_pages, eng.v_pages,
              *eng.params["layers"].values()]
    for leaf in leaves:
        for s in leaf.addressable_shards:
            assert s.data.is_cuda and s.data.is_contiguous() and s.data.data_ptr() % 16 == 0, (leaf, s.index)
    assert eng.params["layers"]["wq"].addressable_shards[1].data.shape[2] == MODEL["n_heads"] // 2


def test_ulysses_step_launches_k1_k3_k2_per_slot(two_slots):
    """A Ulysses training step over seq 2 (2 heads and 1 KV head per slot):
    K1 once per slot per layer (remat off), K3 and K2 once per slot per
    layer; its loss within 5e-3 relative of the one-slot flash step."""
    from ray_tpu_torch.models import TransformerConfig, make_train_step, state_logical_axes
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import MeshSpec, ShardingStrategy, device_put, devices, shard_pytree, use_strategy

    def fresh(impl):
        cfg = TransformerConfig(**MODEL, attention_impl=impl)
        init_state, step = make_train_step(cfg)
        g = torch.Generator(device="cuda").manual_seed(0)
        st = init_state(g, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=g, device="cuda")
        return cfg, st, step, toks

    _, st, step, toks = fresh("flash")
    ref = step(st, {"tokens": toks})["loss"].item()
    cfg, st, step, toks = fresh("ulysses")
    mesh = MeshSpec(seq=2).build(devices())
    strat = ShardingStrategy.named("dp+sp")
    with use_strategy(strat), mesh:
        sh = shard_pytree(st, state_logical_axes(st, cfg), mesh, strat)
        attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
        loss = step(sh, {"tokens": device_put(toks, strat.sharding(mesh, ("batch", None)))})["loss"].item()
    L = MODEL["n_layers"]
    assert (attention.LAUNCHES, attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES) == (2 * L, 2 * L, 2 * L)
    assert abs(loss - ref) <= 5e-3 * abs(ref)
