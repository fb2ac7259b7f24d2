"""The port's transformer pieces against ray_tpu.models.transformer on
converted weights: rms_norm, rope, dense_ffn and the full forward logits.

fp32: the same arithmetic up to summation order, atol/rtol 1e-5.
bf16: both sides round to an 8-bit mantissa, but at different places (XLA's
CPU fusions keep fp32 inside a fusion, eager PyTorch rounds after every op),
so logits of magnitude <= 4 differ by a few bf16 ulps (0.0156 each): max
|diff| <= 0.1, mean |diff| <= 0.01.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=256)


def _cfgs(jdt, tdt):
    return (jt.TransformerConfig(**SMALL, dtype=jdt, attention_impl="reference"),
            tt.TransformerConfig(**SMALL, dtype=tdt))


def _params(jc, tc, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), tc, device="cpu")


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jt._rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = tt.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rope_rotates_halves_like_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 7)).astype(np.int32)
    want = jt._rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dense_ffn_matches():
    jc, tc = _cfgs(jnp.float32, torch.float32)
    jp, tp = _params(jc, tc)
    x = np.random.default_rng(2).normal(size=(2, 5, 64)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = tt.layer_params(tp, 0)
    want = jt._dense_ffn(jnp.asarray(x), jl)
    got = tt.dense_ffn(torch.from_numpy(x), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _logits(jdt, tdt, seed):
    jc, tc = _cfgs(jdt, tdt)
    jp, tp = _params(jc, tc, seed)
    toks = np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (2, 48)).astype(np.int32)
    want, _ = jt.forward(jp, jnp.asarray(toks), jc)
    got = tt.forward(tp, torch.from_numpy(toks).long(), tc)
    return got.float().numpy(), np.asarray(want).astype(np.float32)


def test_forward_logits_fp32():
    got, want = _logits(jnp.float32, torch.float32, seed=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_logits_bf16(seed):
    got, want = _logits(jnp.bfloat16, torch.bfloat16, seed)
    diff = np.abs(got - want)
    assert diff.max() <= 0.1, diff.max()
    assert diff.mean() <= 0.01, diff.mean()


def test_module_and_init_shapes():
    """init_params draws the JAX tree's names and shapes; the module's
    forward is the functional forward on the same tensors."""
    _, tc = _cfgs(jnp.float32, torch.float32)
    model = tt.Transformer(tc, tt.init_params(tc, torch.Generator().manual_seed(0), device="cpu"))
    shapes = jax.tree.map(lambda t: tuple(t.shape), model.params())
    assert shapes == tt.param_shapes(tc)
    toks = torch.arange(10)[None] % tc.vocab_size
    with torch.no_grad():
        np.testing.assert_array_equal(model(toks).numpy(), tt.forward(model.params(), toks, tc).numpy())


def test_convert_rejects_wrong_shapes():
    jc, tc = _cfgs(jnp.float32, torch.float32)
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jc))
    tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="layers.wq"):
        from_numpy_tree(tree, tc, device="cpu")


@pytest.mark.parametrize("entry", ["init_params", "from_numpy_tree"])
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(entry, monkeypatch):
    """Like LLMEngine and make_train_step's init_state, both put a model on
    the GPU unless the caller asks for the CPU: with no device given and no
    GPU visible they raise, before drawing or copying anything."""
    jc, tc = _cfgs(jnp.float32, torch.float32)
    if entry == "init_params":
        def call(**kw):
            return tt.init_params(tc, torch.Generator().manual_seed(0), **kw)
    else:
        tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jc))

        def call(**kw):
            return from_numpy_tree(tree, tc, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{entry} runs on the GPU by default.*device='cpu'"):
        call()
    assert all(t.device.type == "cpu" for t in tt.leaves(call(device="cpu")))
