"""Flash-attention backward of the PyTorch port against ray_tpu's: the same
numpy inputs through both.

``flash_bwd_reference`` (the plain version of kernels K2 and K3) against
the Pallas ``_bwd_pallas`` in interpret mode, fed the same q, k, v, O, LSE
and dO; the port's autograd gradients of ``flash_attention`` (on the CPU,
autograd through ``mha_reference``) against ``jax.grad`` of the JAX
``flash_attention`` in interpret mode; a ragged S against ``jax.grad`` of
the JAX reference. The kernels themselves run only on the GPU, where
``chip_smoke.py`` and ``test_torch_cuda_kernels.py`` hold them against
``flash_bwd_reference``.

Tolerances, fp32 throughout: the recompute form against the Pallas kernels
is the same arithmetic in another summation order (blockwise vs whole-row
einsums), gradients of magnitude <= ~20: atol/rtol 1e-4. Autograd through
the softmax against the recompute-form custom VJP differ by more (the
softmax backward is taken another way): 5e-4, as ``tests/test_attention.py``
holds the JAX kernel against the JAX reference. Each test runs at head dim
64, 128 and 256, the head dims the kernels are built for (at 256 with
Gemma's MQA, 8 heads over one KV head, and GQA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
# (H, KV, D): the D-64 cases keep their ids.
HEADS = [pytest.param(4, 4, 64, id="4-4"), pytest.param(4, 2, 64, id="4-2"), pytest.param(8, 2, 64, id="8-2"),
         pytest.param(4, 4, 128, id="4-4-d128"), pytest.param(4, 2, 128, id="4-2-d128"),
         pytest.param(8, 2, 128, id="8-2-d128"), pytest.param(8, 1, 256, id="8-1-d256"),
         pytest.param(4, 2, 256, id="4-2-d256")]


def _case(B, S, H, KV, seed, D=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    # Two segments per row (packed examples), the boundary at a different
    # place in each row.
    seg = (np.arange(S)[None, :] >= np.array([S - 37, S // 3])[:B, None]).astype(np.int32)
    return q, k, v, do, seg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,D", HEADS)
def test_bwd_reference_matches_jax_kernels(causal, H, KV, D):
    B, S = 2, 256
    q, k, v, do, seg = _case(B, S, H, KV, seed=H * 10 + KV + causal, D=D)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, S, D)  # noqa: E731
    unfold = lambda x, h: np.asarray(x).reshape(B, h, S, D).transpose(0, 2, 1, 3)  # noqa: E731
    seg8 = jnp.broadcast_to(jnp.asarray(seg)[:, None, :], (B, 8, S))
    scale = 1.0 / np.sqrt(D)
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128, group=H // KV, H=H, interpret=True)
    o, lse = jatt._fwd_pallas(fold(q), fold(k), fold(v), seg8, **kw)
    dq, dk, dv = jatt._bwd_pallas((fold(q), fold(k), fold(v), o, lse, seg8), fold(do), KV=KV, **kw)
    got = tatt.flash_bwd_reference(_t(q), _t(k), _t(v), _t(unfold(o, H)), _t(np.asarray(lse)[:, 0, :]),
                                   _t(do), segment_ids=_t(seg), causal=causal)
    for g, want, h, name in zip(got, (dq, dk, dv), (H, KV, KV), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), unfold(want, h), err_msg=name, **TOL)


def _sin_loss_grads_torch(q, k, v, seg, causal):
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = tatt.flash_attention(qt, kt, vt, causal=causal, segment_ids=None if seg is None else _t(seg))
    torch.sin(o).sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("H,KV,D", HEADS)
def test_autograd_matches_jax_grad_of_flash_kernel(H, KV, D, with_seg):
    q, k, v, _, seg = _case(2, 256, H, KV, seed=H + KV, D=D)
    seg = seg if with_seg else None

    def loss(q, k, v):
        o = jatt.flash_attention(q, k, v, causal=True, segment_ids=None if seg is None else jnp.asarray(seg),
                                 block_q=128, block_k=128, interpret=True)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _sin_loss_grads_torch(q, k, v, seg, causal=True)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_ragged_length_autograd_matches_jax_reference(D):
    """S = 200, not a multiple of the JAX kernel's 128: the JAX wrapper takes
    its reference there; the port's kernels mask the ragged tail."""
    q, k, v, _, seg = _case(2, 200, 8, 2, seed=5, D=D)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jatt.mha_reference(q, k, v, causal=True, segment_ids=jnp.asarray(seg))))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _sin_loss_grads_torch(q, k, v, seg, causal=True)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_bwd_reference_is_the_autograd_gradient_at_a_ragged_length(D):
    """The recompute form at S = 200 (the shape the kernels mask) equals
    autograd through the plain forward on the same inputs and LSE."""
    q, k, v, do, seg = _case(2, 200, 8, 2, seed=9, D=D)
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tatt.mha_reference(qt, kt, vt, causal=True, segment_ids=_t(seg), return_lse=True)
    o.backward(_t(do))
    got = tatt.flash_bwd_reference(_t(q), _t(k), _t(v), o.detach(), lse.detach().reshape(-1, 200), _t(do),
                                   segment_ids=_t(seg), causal=True)
    for g, t, name in zip(got, (qt, kt, vt), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name, **GRAD_TOL)


def test_bwd_kernel_entries_refuse_cpu_tensors():
    """The kernels' entry points take CUDA tensors only; on the CPU the
    gradient goes through autograd of the plain version, never a kernel."""
    q, k, v, do, _ = _case(1, 64, 4, 2, seed=0)
    bf = lambda a: _t(a).bfloat16()  # noqa: E731
    lse = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_bwd(bf(q), bf(k), bf(v), bf(do), lse, bf(do))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_bwd_dkv(bf(q), bf(k), bf(v), bf(do), lse, lse)
