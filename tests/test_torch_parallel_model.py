"""The port's copy of ``tests/test_parallel_model.py``: mesh, sharding
strategies and the flagship transformer on 8 CPU slots of one process (the
port's single-controller mesh; ``RAY_TPU_TORCH_DEVICE_SLOTS=8`` is the
counterpart of the reference's 8-device virtual CPU mesh). Case for case,
with the reference's tolerances; inputs drawn from numpy seeds. Not copied:
``test_graft_entry_contract`` (marked slow there, and about the JAX entry
point ``__graft_entry__.py``).

The reference compiles each sharded step under ``in_shardings``; here the
state placed by ``shard_pytree`` trains through the same ``train_step``,
which computes per slot (``ray_tpu_torch/models/sharded.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import TransformerConfig, cross_entropy_loss, make_train_step, state_logical_axes
from ray_tpu_torch.models.transformer import forward, init_params, param_logical_axes
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.parallel import (
    MeshSpec,
    NamedSharding,
    PartitionSpec as P,
    ShardingStrategy,
    device_put,
    devices,
    shard_pytree,
)
from ray_tpu_torch.parallel.sharding import use_strategy

CFG = TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
    max_seq_len=64, dtype=torch.float32, attention_impl="reference",
)


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


def _cpu():
    return devices("cpu")


def _tokens(seed, shape, vocab=128):
    return torch.tensor(np.random.default_rng(seed).integers(0, vocab, shape))


def _normal(seed, shape):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=torch.float32)


def _state(cfg, seed=0):
    init_state, train_step = make_train_step(cfg)
    return init_state(torch.Generator().manual_seed(seed), device="cpu"), train_step


def test_mesh_spec_infers_axis():
    spec = MeshSpec(data=-1, tensor=2)
    sizes = spec.resolved_sizes(8)
    assert sizes["data"] == 4 and sizes["tensor"] == 2


def test_mesh_spec_rejects_bad_product():
    with pytest.raises(ValueError):
        MeshSpec(data=3, tensor=2).resolved_sizes(8)


def test_mesh_build_8_devices():
    mesh = MeshSpec(data=-1, tensor=2).build(_cpu())
    assert mesh.shape["tensor"] == 2
    assert np.prod(list(mesh.shape.values())) == 8


def test_strategy_specs():
    tp = ShardingStrategy.tp()
    assert tp.spec(("embed", "mlp")) == P(None, "tensor")
    fsdp_tp = ShardingStrategy.fsdp() | ShardingStrategy.tp()
    assert fsdp_tp.spec(("embed", "heads", "head_dim")) == P("fsdp", "tensor", None)
    # duplicate mesh axis within one spec is dropped (used once)
    assert fsdp_tp.spec(("mlp", "heads")) == P("tensor", None)
    # batch over combined axes
    assert fsdp_tp.spec(("batch", "seq")) == P(("replica", "data", "fsdp"), None)


def test_strategy_named_composition():
    s = ShardingStrategy.named("fsdp+tp+sp")
    assert s.rules["seq"] == "seq"
    assert s.rules["mlp"] == "tensor"


def test_forward_shapes_and_loss():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    tokens = _tokens(1, (2, 16))
    logits = forward(params, tokens, CFG)
    assert logits.shape == (2, 16, CFG.vocab_size)
    loss = cross_entropy_loss(params, {"tokens": tokens}, CFG)
    assert torch.isfinite(loss)
    # random init ~ uniform over vocab
    assert abs(float(loss) - np.log(CFG.vocab_size)) < 1.5


def test_train_step_reduces_loss():
    state, train_step = _state(CFG)
    tokens = _tokens(1, (4, 33))
    losses = [float(train_step(state, {"tokens": tokens})["loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_sharded_train_step_matches_single_device():
    """DP+TP sharded step must match unsharded numerics."""
    mesh = MeshSpec(data=2, tensor=4).build(_cpu())
    strategy = ShardingStrategy.dp() | ShardingStrategy.tp()
    state, train_step = _state(CFG)
    state_sh, _ = _state(CFG)
    tokens = _tokens(1, (4, 33))
    m_ref = train_step(state, {"tokens": tokens})
    with use_strategy(strategy), mesh:
        st = shard_pytree(state_sh, state_logical_axes(state_sh, CFG), mesh, strategy)
        data = {"tokens": device_put(tokens, strategy.sharding(mesh, ("batch", "seq")))}
        m_sharded = train_step(st, data)
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_sharded["loss"]), rtol=2e-4)


def test_fsdp_actually_shards_params():
    mesh = MeshSpec(fsdp=8).build(_cpu())
    strategy = ShardingStrategy.fsdp()
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    sharded = shard_pytree(params, param_logical_axes(CFG), mesh, strategy)
    # wq [L, D(embed), H, hd] sharded on dim 1 across 8 slots
    shards = sharded["layers"]["wq"].addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape[1] == CFG.d_model // 8


def _moe_cfg(**kw):
    return TransformerConfig(**dict(dict(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        n_experts=4, expert_top_k=2, max_seq_len=64, dtype=torch.float32,
        attention_impl="reference"), **kw))


def test_moe_forward():
    cfg = _moe_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    from ray_tpu_torch.models.transformer import forward_hidden

    tokens = _tokens(1, (2, 16))
    logits = forward(params, tokens, cfg)
    _, aux = forward_hidden(params, tokens, cfg)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert torch.isfinite(aux) and float(aux) > 0


def test_ep_shards_experts_and_matches_unsharded():
    """Expert parallelism end to end on the 8-slot mesh: ep()|fsdp()
    partitions the expert dim of every expert weight, top-k routed dispatch
    runs sharded, and a sharded train step's loss equals the unsharded twin
    (same init seed, same batch)."""
    cfg = _moe_cfg()
    tokens = _tokens(7, (8, 33))
    mesh = MeshSpec(data=-1, fsdp=2, expert=2).build(_cpu())
    strategy = ShardingStrategy.ep() | ShardingStrategy.fsdp()
    with use_strategy(strategy), mesh:
        st, train_step = _state(cfg)
        st = shard_pytree(st, state_logical_axes(st, cfg), mesh, strategy)
        # Expert weights [L, E, D, F] really partitioned: E over expert (2),
        # D over fsdp (2).
        for name in ("w_gate", "w_up", "w_down"):
            shard = st["params"]["layers"][name].addressable_shards[0].data
            full = st["params"]["layers"][name].shape
            assert shard.shape[1] == cfg.n_experts // 2, (name, shard.shape, full)
        assert st["params"]["layers"]["w_gate"].addressable_shards[0].data.shape[2] \
            == cfg.d_model // 2  # fsdp composes on embed
        batch = {"tokens": device_put(tokens, strategy.sharding(mesh, ("batch", "seq")))}
        sharded_loss = float(train_step(st, batch)["loss"])

    ref_mesh = MeshSpec(data=-1).build(_cpu()[:1])
    ref = ShardingStrategy.dp()
    with use_strategy(ref), ref_mesh:
        st, train_step = _state(cfg)
        st = shard_pytree(st, state_logical_axes(st, cfg), ref_mesh, ref)
        batch = {"tokens": device_put(tokens, ref.sharding(ref_mesh, ("batch", "seq")))}
        ref_loss = float(train_step(st, batch)["loss"])
    np.testing.assert_allclose(sharded_loss, ref_loss, rtol=2e-3)


def test_moe_topk_routing_actually_routes():
    """moe_ffn's dispatch really routes token s to expert s (hand-crafted
    router): zeroing ONE expert's down-projection changes exactly the tokens
    routed to it and no others."""
    from ray_tpu_torch.models.transformer import moe_ffn

    cfg = TransformerConfig(
        vocab_size=128, d_model=8, n_layers=1, n_heads=2, d_ff=16,
        n_experts=4, expert_top_k=1, max_seq_len=64, dtype=torch.float32,
        attention_impl="reference",
    )
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    lp = {
        # Router: dim d votes for expert d (d < E) with a huge margin, so
        # one-hot input e_s routes deterministically to expert s.
        "router": torch.eye(D, E) * 50.0,
        "w_gate": _normal(0, (E, D, F)) * 0.5,
        "w_up": _normal(1, (E, D, F)) * 0.5,
        "w_down": _normal(2, (E, F, D)) * 0.5,
    }
    x = torch.eye(4, D)[None]  # [1, 4, D]: token s = e_s -> expert s
    out, aux = moe_ffn(x, lp, cfg)
    assert torch.isfinite(aux)
    w_down = lp["w_down"].clone()
    w_down[2] = 0.0
    out_cut, _ = moe_ffn(x, dict(lp, w_down=w_down), cfg)
    changed = ((out - out_cut).abs().sum(-1)[0] > 1e-6).tolist()  # per token
    assert changed == [False, False, True, False], changed
    # And expert 2's tokens now produce exactly zero (top_k=1: sole expert).
    np.testing.assert_allclose(out_cut[0, 2].numpy(), 0.0, atol=1e-6)


def test_attention_reference_causal():
    q, k, v = (_normal(s, (1, 8, 2, 16)) for s in range(3))
    o = mha_reference(q, k, v, causal=True)
    # first position attends only to itself
    o0 = mha_reference(q[:, :1], k[:, :1], v[:, :1], causal=True)
    np.testing.assert_allclose(o[:, 0].numpy(), o0[:, 0].numpy(), rtol=1e-5)


def test_ring_train_step_composes_with_sp():
    """The full train step (forward + backward through the ppermute ring,
    with remat) using attention_impl='ring' on a seq-sharded mesh: loss and
    updated params match the unsharded reference-attention step."""
    cfg_ring = dataclasses.replace(CFG, attention_impl="ring", remat=True, n_kv_heads=2)  # GQA: KV expand path
    cfg_ref = dataclasses.replace(CFG, attention_impl="reference", n_kv_heads=2)

    tokens = _tokens(1, (4, 33))
    ref_state, step_ref = _state(cfg_ref)
    m_ref = step_ref(ref_state, {"tokens": tokens})

    st, step_ring = _state(cfg_ring)
    mesh = MeshSpec(data=2, seq=4).build(_cpu())
    strategy = ShardingStrategy.dp() | ShardingStrategy.sp()
    with use_strategy(strategy), mesh:
        st = shard_pytree(st, state_logical_axes(st, cfg_ring), mesh, strategy)
        # Tokens shard on batch only (S+1 isn't seq-divisible); the model's
        # layout constraints reshard activations onto the seq axis inside.
        data = {"tokens": device_put(tokens, strategy.sharding(mesh, ("batch", None)))}
        m_ring = step_ring(st, data)
        wq1 = st["params"]["layers"]["wq"].full().detach().clone()  # the step updates in place
        # Two consecutive steps: the backward-through-ppermute gradients feed
        # a real optimizer update that the next forward consumes.
        m_ring2 = step_ring(st, data)
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_ring["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(m_ref["grad_norm"]), float(m_ring["grad_norm"]), rtol=2e-3)
    # Updated params match leaf for leaf (gradient parity, not just loss).
    np.testing.assert_allclose(wq1.numpy(), ref_state["params"]["layers"]["wq"].detach().numpy(),
                               atol=2e-5, rtol=2e-4)
    assert float(m_ring2["loss"]) < float(m_ring["loss"])  # learning continues


def _seq_sharded(mesh, *xs):
    sh = NamedSharding(mesh, P(None, "seq", None, None))
    return [device_put(x, sh) for x in xs]


def test_ring_attention_matches_reference():
    from ray_tpu_torch.ops.ring_attention import ring_attention

    mesh = MeshSpec(seq=4, data=2).build(_cpu())
    q, k, v = (_normal(s, (2, 32, 2, 16)) for s in range(3))
    ref = mha_reference(q, k, v, causal=True)
    with mesh:
        out = ring_attention(*_seq_sharded(mesh, q, k, v), axis_name="seq")
    np.testing.assert_allclose(out.full().numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_ring_attention_noncausal():
    from ray_tpu_torch.ops.ring_attention import ring_attention

    mesh = MeshSpec(seq=8).build(_cpu())
    q, k, v = (_normal(10 + s, (1, 64, 2, 8)) for s in range(3))
    ref = mha_reference(q, k, v, causal=False)
    with mesh:
        out = ring_attention(*_seq_sharded(mesh, q, k, v), causal=False)
    np.testing.assert_allclose(out.full().numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_pipeline_train_step_matches_sequential():
    """PP (4 stages) x DP (2): pipelined loss and updated params match the
    sequential step (the GPipe schedule is math-identical)."""
    from ray_tpu_torch.models import make_pipeline_train_step

    cfg = TransformerConfig(
        vocab_size=128, d_model=64, n_layers=4, n_heads=4, d_ff=128,
        max_seq_len=64, dtype=torch.float32, attention_impl="reference",
    )
    mesh = MeshSpec(data=2, stage=4).build(_cpu())
    ref_state, seq_step = _state(cfg)
    state, _ = _state(cfg)
    tokens = _tokens(1, (8, 33))
    m_ref = seq_step(ref_state, {"tokens": tokens})

    _, pp_step = make_pipeline_train_step(cfg, mesh, n_micro=4)
    strategy = ShardingStrategy.dp() | ShardingStrategy.pp()
    with mesh:
        st = shard_pytree(state, state_logical_axes(state, cfg), mesh, strategy)
        data = {"tokens": device_put(tokens, strategy.sharding(mesh, ("batch", "seq")))}
        m_pp = pp_step(st, data)
    np.testing.assert_allclose(float(m_ref["loss"]), float(m_pp["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(m_ref["grad_norm"]), float(m_pp["grad_norm"]), rtol=2e-3)
    # Parameter updates identical too (whole-state check, not just metrics).
    np.testing.assert_allclose(ref_state["params"]["layers"]["wq"].detach().numpy(),
                               st["params"]["layers"]["wq"].full().detach().numpy(), rtol=5e-3, atol=1e-5)


def test_pipeline_single_stage_fallback():
    """stage=1 mesh: the pipeline path degrades to the plain layer loop."""
    from ray_tpu_torch.models import make_pipeline_train_step

    cfg = TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=64, dtype=torch.float32, attention_impl="reference",
    )
    mesh = MeshSpec(data=-1).build(_cpu())
    init_state, pp_step = make_pipeline_train_step(cfg, mesh, n_micro=2)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    with mesh:
        m = pp_step(state, {"tokens": _tokens(1, (4, 33))})
    assert torch.isfinite(m["loss"])


def test_ulysses_attention_matches_reference():
    """Ulysses all-to-all resharding: exact vs the dense oracle, causal."""
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    mesh = MeshSpec(seq=4, data=2).build(_cpu())
    q, k, v = (_normal(20 + s, (2, 32, 4, 16)) for s in range(3))
    ref = mha_reference(q, k, v, causal=True)
    with mesh:
        out = ulysses_attention(*_seq_sharded(mesh, q, k, v))
    np.testing.assert_allclose(out.full().numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_ulysses_attention_gqa_and_segments():
    """Grouped KV heads stay grouped through the all_to_all; the packed-
    sequence segment mask composes (segment ids all-gathered)."""
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    mesh = MeshSpec(seq=4).build(_cpu()[:4])
    B, S, H, KV, D = 2, 32, 8, 4, 8
    q = _normal(30, (B, S, H, D))
    k = _normal(31, (B, S, KV, D))
    v = _normal(32, (B, S, KV, D))
    seg = torch.cat([torch.zeros(B, S // 2, dtype=torch.int32), torch.ones(B, S - S // 2, dtype=torch.int32)], 1)
    kr, vr = k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2)
    ref = mha_reference(q, kr, vr, causal=True, segment_ids=seg)
    with mesh:
        qs, ks, vs = _seq_sharded(mesh, q, k, v)
        segs = device_put(seg, NamedSharding(mesh, P(None, "seq")))
        out = ulysses_attention(qs, ks, vs, segment_ids=segs)
    np.testing.assert_allclose(out.full().numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_ulysses_attention_head_indivisible_falls_back_to_ring():
    """H < axis size: Ulysses cannot shard heads; it must still be exact (ring)."""
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    mesh = MeshSpec(seq=8).build(_cpu())
    q, k, v = (_normal(40 + s, (1, 64, 2, 8)) for s in range(3))
    ref = mha_reference(q, k, v, causal=True)
    with mesh:
        out = ulysses_attention(*_seq_sharded(mesh, q, k, v))
    np.testing.assert_allclose(out.full().numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_chunked_ce_matches_unchunked():
    """ce_chunk computes the same loss and gradients as the materialised
    path (it exists so [B,S,V] logits never sit in device memory)."""
    cfg = TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=64, dtype=torch.float32, attention_impl="reference",
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for t in [params["embed"], params["lm_head"]]:
        t.requires_grad_(True)
    tokens = _tokens(1, (3, 33))
    mask = torch.tensor(np.random.default_rng(2).uniform(size=(3, 33)) > 0.3, dtype=torch.float32)
    cfgc = dataclasses.replace(cfg, ce_chunk=8)
    for batch in ({"tokens": tokens}, {"tokens": tokens, "mask": mask}):
        l0 = cross_entropy_loss(params, batch, cfg)
        l1 = cross_entropy_loss(params, batch, cfgc)
        np.testing.assert_allclose(l0.item(), l1.item(), rtol=1e-5)
        g0 = torch.autograd.grad(l0, [params["lm_head"], params["embed"]])
        g1 = torch.autograd.grad(l1, [params["lm_head"], params["embed"]])
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_ce_chunk_falls_back_when_not_divisible():
    """A seq length the chunk does not divide uses the materialised path
    (same value, with a warning) instead of failing."""
    cfg = TransformerConfig(
        vocab_size=128, d_model=64, n_layers=1, n_heads=4, d_ff=128,
        max_seq_len=64, dtype=torch.float32, attention_impl="reference",
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = _tokens(1, (2, 30))  # S=29, not % 8
    l0 = float(cross_entropy_loss(params, {"tokens": tokens}, cfg))
    with pytest.warns(UserWarning, match="ce_chunk"):
        l1 = float(cross_entropy_loss(params, {"tokens": tokens}, dataclasses.replace(cfg, ce_chunk=8)))
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
