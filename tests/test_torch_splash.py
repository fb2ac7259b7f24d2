"""The port's splash attention (``ray_tpu_torch/ops/splash.py``) against
ray_tpu's splash contract, on the same numpy inputs.

jax's splash kernel (``ray_tpu/ops/splash.py``) is a TPU-only Pallas kernel
with no interpret path on the CPU, so the JAX side here is what that wrapper
computes, written out: q folded with the softmax scale in fp32 and cast back
(``ray_tpu/ops/splash.py:44-52``), then ``ray_tpu.ops.attention.mha_reference``
with scale 1.0, causal, GQA and segment ids. On the CPU the port's wrapper
takes the plain version (``mha_reference``); on the card it runs K1 forward
and K3 + K2 backward (``chip_smoke.py`` phase 7, ``test_torch_cuda_kernels``).

Tolerances: fp32 is the same arithmetic in another summation order, 1e-5
for outputs and logits, 1e-4 for gradients (autograd and jax.grad take the
softmax backward in different orders). bf16 inputs: the fold rounds q
identically on both sides, then each framework rounds P and the output to
bf16 at its own places: 2e-2 (a few bf16 ulps of outputs of magnitude <= 3).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu.ops import attention as jatt
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops.splash import splash_attention

D = 64


def _case(B, S, H, KV, seed, segs):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    seg = None
    if segs:  # three packed segments per row, boundaries in other places
        pos = np.arange(S)[None, :]
        seg = ((pos >= np.array([[S // 4], [S // 3]])[:B]).astype(np.int32)
               + (pos >= np.array([[S // 2], [2 * S // 3]])[:B]).astype(np.int32))
    return q, k, v, seg


def _jax_splash(q, k, v, seg, dtype=jnp.float32):
    """What ray_tpu/ops/splash.py computes: q * scale in fp32, cast back to
    q's dtype, then causal attention with scale 1.0."""
    q = jnp.asarray(q, dtype)
    qs = (q.astype(jnp.float32) * (1.0 / math.sqrt(D))).astype(q.dtype)
    return jatt.mha_reference(qs, jnp.asarray(k, dtype), jnp.asarray(v, dtype), causal=True, scale=1.0,
                              segment_ids=None if seg is None else jnp.asarray(seg))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("segs", [False, True])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])
def test_splash_matches_the_jax_contract(H, KV, segs):
    q, k, v, seg = _case(2, 96, H, KV, seed=H * 10 + KV + segs, segs=segs)
    before = (tatt.LAUNCHES, tatt.BWD_DQ_LAUNCHES, tatt.BWD_DKV_LAUNCHES)
    got = splash_attention(_t(q), _t(k), _t(v), causal=True,
                           segment_ids=None if seg is None else torch.from_numpy(seg))
    want = _jax_splash(q, k, v, seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # On the CPU the plain version runs: no kernel was launched.
    assert (tatt.LAUNCHES, tatt.BWD_DQ_LAUNCHES, tatt.BWD_DKV_LAUNCHES) == before


def test_splash_bf16_folds_the_scale_like_jax():
    q, k, v, seg = _case(2, 80, 8, 2, seed=3, segs=True)
    got = splash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), causal=True,
                           segment_ids=torch.from_numpy(seg))
    want = _jax_splash(q, k, v, seg, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_splash_gradients_match_jax():
    q, k, v, seg = _case(2, 72, 8, 2, seed=4, segs=True)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(_jax_splash(q, k, v, seg)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    torch.sin(splash_attention(*leaves, segment_ids=torch.from_numpy(seg))).sum().backward()
    for t, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_splash_is_causal_only():
    q, k, v, _ = _case(1, 16, 4, 2, seed=0, segs=False)
    with pytest.raises(NotImplementedError, match="causal-only"):
        splash_attention(_t(q), _t(k), _t(v), causal=False)


SMALL = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=256)


@pytest.mark.parametrize("packed", [False, True])
def test_two_layer_forward_splash_matches_flash(packed):
    """A 2-layer model (head_dim 32) with attention_impl="splash" against
    "flash" (both the plain version on the CPU) and against the JAX forward
    on the same converted weights."""
    jc = jt.TransformerConfig(**SMALL, dtype=jnp.float32, attention_impl="reference")
    tc = tt.TransformerConfig(**SMALL, dtype=torch.float32)
    jp = jt.init_params(jax.random.PRNGKey(7), jc)
    params = from_numpy_tree(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, SMALL["vocab_size"], (2, 48)).astype(np.int32)
    seg = (np.arange(48)[None, :] >= np.array([[20], [31]])).astype(np.int32) if packed else None
    tseg = None if seg is None else torch.from_numpy(seg)
    splash = tt.forward(params, torch.from_numpy(toks).long(), dataclasses.replace(tc, attention_impl="splash"),
                        segment_ids=tseg)
    flash = tt.forward(params, torch.from_numpy(toks).long(), dataclasses.replace(tc, attention_impl="flash"),
                       segment_ids=tseg)
    want, _ = jt.forward(jp, jnp.asarray(toks), jc, segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(splash.numpy(), flash.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(splash.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
