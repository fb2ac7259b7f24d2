"""Flash-attention forward of the PyTorch port against ray_tpu's Pallas
kernel (interpret mode on the CPU): the same numpy inputs through both.

On the CPU the port's ``flash_attention`` runs its plain version
(``mha_reference``); kernel K1 itself runs only on the GPU, where
``chip_smoke.py`` and ``test_torch_cuda_kernels.py`` hold it against this
plain version. Tolerance: fp32 on both sides, only the summation order
differs (blockwise online softmax vs one softmax), so 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

D = 64
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(B, S, H, KV, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    # Prompt-padding segments as the engine builds them: pads (pos >= len)
    # are their own segment; a different length per row.
    lens = np.array([S - 37, S // 3][:B])
    seg = (np.arange(S)[None, :] >= lens[:, None]).astype(np.int32)
    return q, k, v, seg


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 2)])
def test_flash_matches_jax_kernel(causal, H, KV):
    q, k, v, seg = _case(1, 256, H, KV, seed=H * 10 + KV)
    want = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jnp.asarray(seg), block_q=128, block_k=128, interpret=True,
    )
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_lse_matches_jax_kernel():
    """The per-row log-sum-exp the kernel writes (for the later backward)."""
    H, KV, S = 4, 2, 256
    q, k, v, seg = _case(2, S, H, KV, seed=7)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, S, D)  # noqa: E731
    seg8 = jnp.broadcast_to(jnp.asarray(seg)[:, None, :], (2, 8, S))
    _, want = jatt._fwd_pallas(
        fold(q), fold(k), fold(v), seg8, causal=True, scale=1.0 / np.sqrt(D),
        block_q=128, block_k=128, group=H // KV, H=H, interpret=True,
    )
    _, got = tatt.mha_reference(_t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg), return_lse=True)
    np.testing.assert_allclose(got.reshape(2 * H, S).numpy(), np.asarray(want)[:, 0, :], **TOL)


def test_flash_ragged_length_matches_reference():
    """S not a multiple of 128: the JAX wrapper falls back to its reference;
    the port's kernel masks the ragged tail itself (same function)."""
    q, k, v, seg = _case(2, 200, 8, 2, seed=3)
    want = jatt.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              segment_ids=jnp.asarray(seg))
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_entry_refuses_cpu_tensors():
    """The kernel's entry point takes CUDA tensors only: a CPU tensor reaches
    the plain version through ``flash_attention``, never the kernel."""
    q, k, v, _ = _case(1, 64, 4, 2, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_fwd(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16())
