"""The port's training pieces against ray_tpu.models.transformer on the same
numpy batch and converted weights: the cross-entropy loss (materialised and
chunked, with padding masks and packed segments), the MoE dense dispatch and
its aux loss, remat, and a few AdamW steps of ``make_train_step``.

Small model (as ``test_torch_model.py``), fp32, attention_impl="reference"
on both sides. Tolerances: the same arithmetic up to summation order, so
losses and outputs to 1e-5 (relative) and gradients to 1e-5 (relative, atol
1e-6). After AdamW steps, parameters are held to atol 2 * lr = 6e-4: Adam's
first update is about lr * sign(g), so an element whose gradient is ~1e-8
(at the summation noise) can move by up to lr the other way in one framework;
the loss and grad_norm, which average over every element, stay at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from ray_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=256)
B, S = 2, 32  # tokens are [B, S + 1]
TOL = dict(atol=1e-6, rtol=1e-5)


def _cfgs(**kw):
    return (jt.TransformerConfig(**SMALL, dtype=jnp.float32, attention_impl="reference", **kw),
            tt.TransformerConfig(**SMALL, dtype=torch.float32, attention_impl="reference", **kw))


def _params(jc, tc, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(kind, seed=0):
    """numpy batch: plain tokens, + a padding mask, or packed segments with
    positions restarting at each segment."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, SMALL["vocab_size"], (B, S + 1)).astype(np.int32)}
    if kind in ("mask", "packed"):
        b["mask"] = (np.arange(S + 1)[None, :] < np.array([S + 1, S - 9])[:, None]).astype(np.float32)
    if kind == "packed":
        seg = (np.arange(S + 1)[None, :] >= np.array([12, 20])[:, None]).astype(np.int32)
        starts = np.where(seg == 0, 0, np.array([12, 20])[:, None])
        b["segment_ids"] = seg
        b["positions"] = (np.arange(S + 1)[None, :] - starts).astype(np.int32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("kind", ["plain", "mask", "packed"])
def test_loss_matches_jax(kind, ce_chunk):
    jc, tc = _cfgs(ce_chunk=ce_chunk)
    jp, tp = _params(jc, tc)
    b = _batch(kind)
    want = jt.cross_entropy_loss(jp, _jb(b), jc)
    got = tt.cross_entropy_loss(tp, _tb(b), tc)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_loss_with_non_dividing_chunk_warns_and_matches_jax():
    jc, tc = _cfgs(ce_chunk=5)  # 5 does not divide S = 32: materialised logits
    jp, tp = _params(jc, tc)
    b = _batch("mask")
    with pytest.warns(UserWarning, match="ce_chunk"):
        want = jt.cross_entropy_loss(jp, _jb(b), jc)
    with pytest.warns(UserWarning, match="ce_chunk"):
        got = tt.cross_entropy_loss(tp, _tb(b), tc)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def _grads(tp, tc, b):
    for t in tt.leaves(tp):
        t.requires_grad_(True)
        t.grad = None
    loss = tt.cross_entropy_loss(tp, _tb(b), tc)
    loss.backward()
    return loss.item(), [t.grad.clone() for t in tt.leaves(tp)]


def _assert_tree_close(got, want, **tol):
    """Each leaf of the JAX tree ``want`` against the same path of ``got``."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), err_msg=jax.tree_util.keystr(path), **tol)


def _assert_same_grads(ga, gb):
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_chunked_loss_has_the_materialised_gradients(kind):
    jc, tc = _cfgs()
    _, tp = _params(jc, tc, seed=1)
    b = _batch(kind, seed=1)
    loss, grads = _grads(tp, tc, b)
    loss_c, grads_c = _grads(tp, dataclasses.replace(tc, ce_chunk=8), b)
    np.testing.assert_allclose(loss_c, loss, **TOL)
    _assert_same_grads(grads_c, grads)


def _moe_cfgs():
    return _cfgs(n_experts=4, expert_top_k=2)


def test_moe_ffn_and_aux_match_jax():
    """Top-2 of 4 experts. The routing assumes no exact ties among a token's
    router probabilities (lax.top_k and torch.topk may break ties in another
    order); with random fp32 routers there are none."""
    jc, tc = _moe_cfgs()
    jp, tp = _params(jc, tc, seed=2)
    x = np.random.default_rng(2).normal(size=(B, S, SMALL["d_model"])).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    want, want_aux = jt._moe_ffn(jnp.asarray(x), jl, jc)
    got, got_aux = tt.moe_ffn(torch.from_numpy(x), tt.layer_params(tp, 0), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **TOL)


def test_moe_loss_and_gradients_match_jax():
    jc, tc = _moe_cfgs()
    jp, tp = _params(jc, tc, seed=3)
    b = _batch("packed", seed=3)
    want, want_g = jax.value_and_grad(jt.cross_entropy_loss)(jp, _jb(b), jc)
    loss, _ = _grads(tp, tc, b)
    np.testing.assert_allclose(loss, float(want), **TOL)
    got_g = to_numpy_tree({k: (v.grad if k != "layers" else {n: t.grad for n, t in v.items()})
                           for k, v in tp.items()})
    _assert_tree_close(got_g, want_g, atol=1e-5, rtol=1e-4)


def _head_dim_grads_match_jax(head_dim, kind, seed):
    """An MQA model at ``head_dim`` (2 heads, one KV head): the loss and every
    leaf's gradient against jax.grad on one converted tree."""
    kw = dict(SMALL, d_model=2 * head_dim, n_heads=2, n_kv_heads=1)
    jc = jt.TransformerConfig(**kw, dtype=jnp.float32, attention_impl="reference")
    tc = tt.TransformerConfig(**kw, dtype=torch.float32, attention_impl="reference")
    assert tc.head_dim == head_dim
    jp, tp = _params(jc, tc, seed=seed)
    b = _batch(kind, seed=seed)
    want, want_g = jax.value_and_grad(jt.cross_entropy_loss)(jp, _jb(b), jc)
    loss, _ = _grads(tp, tc, b)
    np.testing.assert_allclose(loss, float(want), **TOL)
    got_g = to_numpy_tree({k: (v.grad if k != "layers" else {n: t.grad for n, t in v.items()})
                           for k, v in tp.items()})
    _assert_tree_close(got_g, want_g, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_gradients_at_head_dim_128_match_jax(kind):
    """head_dim 128 (d_model 256), the second head dim the flash kernels
    are built for."""
    _head_dim_grads_match_jax(128, kind, seed=7)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_gradients_at_head_dim_256_match_jax(kind):
    """head_dim 256 (d_model 512, Gemma's MQA), the third."""
    _head_dim_grads_match_jax(256, kind, seed=8)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("moe", [False, True])
def test_remat_keeps_the_gradients(policy, moe):
    jc, tc = _moe_cfgs() if moe else _cfgs()
    _, tp = _params(jc, tc, seed=4)
    b = _batch("packed", seed=4)
    loss, grads = _grads(tp, tc, b)
    loss_r, grads_r = _grads(tp, dataclasses.replace(tc, remat=True, remat_policy=policy), b)
    np.testing.assert_allclose(loss_r, loss, **TOL)
    _assert_same_grads(grads_r, grads)


def test_unknown_remat_policy_and_unported_attention_raise():
    """An unknown remat policy raises; attention_impl="ring" (ported) runs
    off a mesh as the dense reference, as the JAX ring falls back."""
    _, tc = _cfgs()
    toks = torch.tensor(np.random.default_rng(0).integers(0, tc.vocab_size, (2, 8)))
    params = tt.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tt.forward_hidden(params, toks, dataclasses.replace(tc, remat=True, remat_policy="offload"))
    ring, _ = tt.forward(params, toks, dataclasses.replace(tc, attention_impl="ring"))
    ref, _ = tt.forward(params, toks, dataclasses.replace(tc, attention_impl="reference"))
    torch.testing.assert_close(ring, ref, rtol=0, atol=0)


def test_train_steps_match_jax_adamw():
    jc, tc = _cfgs()
    j_init, j_step, _ = jt.make_train_step(jc)
    jstate = j_init(jax.random.PRNGKey(5))
    t_init, t_step = tt.make_train_step(tc)
    tstate = t_init(torch.Generator().manual_seed(0), device="cpu")
    start = from_numpy_tree(jax.tree.map(np.asarray, jstate["params"]), tc, device="cpu")
    with torch.no_grad():
        for dst, src in zip(tt.leaves(tstate["params"]), tt.leaves(start)):
            dst.copy_(src)
    for i in range(3):
        b = _batch("packed" if i % 2 else "plain", seed=10 + i)
        jstate, jm = j_step(jstate, _jb(b))
        tm = t_step(tstate, _tb(b))
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), **TOL)
    _assert_tree_close(to_numpy_tree(tstate["params"]), jstate["params"], atol=2 * 3e-4, rtol=0)


def test_convert_round_trips_a_moe_tree():
    jc, tc = _moe_cfgs()
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(6), jc))
    back = to_numpy_tree(from_numpy_tree(tree, tc, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="n_experts"):
        from_numpy_tree(tree, _cfgs()[1], device="cpu")


def test_init_state_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    _, tc = _cfgs()
    init_state, _ = tt.make_train_step(tc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(torch.Generator().manual_seed(0))
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    assert all(t.requires_grad and t.dtype == torch.float32 for t in tt.leaves(state["params"]))
    assert state["step"] == 0 and isinstance(state["opt"], torch.optim.AdamW)
