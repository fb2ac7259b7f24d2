"""Paged decode attention of the PyTorch port against ray_tpu's Pallas
kernel (interpret mode on the CPU): GQA, ragged lengths, partial pages, dead
table entries pointing at page 0, and a length-0 row, which must give 0 (the
TPU kernel's answer; its jnp reference gives the mean of V there).

On the CPU the port's ``paged_attention`` runs its plain version; kernel K4
runs only on the GPU. Tolerance: fp32 on both sides, 2e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import paged_attention as jax_paged
from ray_tpu_torch.ops.paged_attention import paged_attention, paged_decode

TOL = dict(atol=2e-5, rtol=2e-5)


def _make_case(B, H, KV, D, ps, ppseq, lengths, seed=0):
    """Random paged pool where each sequence owns shuffled pages; entries
    past a sequence's length stay 0 (the dead page, full of data)."""
    rng = np.random.default_rng(seed)
    P_total = B * ppseq + 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k_pages = rng.normal(size=(KV, P_total, ps, D)).astype(np.float32)
    v_pages = rng.normal(size=(KV, P_total, ps, D)).astype(np.float32)
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n_used = math.ceil(lengths[b] / ps)
        table[b, :n_used] = rng.permutation(np.arange(1, P_total))[:n_used]
    return q, k_pages, v_pages, np.asarray(lengths, np.int32), table


def _both(case):
    q, kp, vp, lens, table = case
    want = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
                     jnp.asarray(table), interpret=True)
    got = paged_attention(*(torch.from_numpy(a) for a in case))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2), (16, 4)])
def test_matches_jax_kernel_gqa_ragged(H, KV):
    # Partial last pages, a single token, an exactly full table.
    got, want = _both(_make_case(B=4, H=H, KV=KV, D=64, ps=32, ppseq=4,
                                 lengths=[5, 16, 61, 128], seed=H + KV))
    np.testing.assert_allclose(got, want, **TOL)


def test_dead_entries_and_zero_length():
    """Dead entries (page 0, full of data) contribute nothing; a length-0
    row writes zeros in both the TPU kernel and the port."""
    got, want = _both(_make_case(B=3, H=4, KV=2, D=64, ps=16, ppseq=8,
                                 lengths=[16, 0, 40], seed=3))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()


def test_kernel_entry_refuses_cpu_tensors():
    q, kp, vp, lens, table = _make_case(B=1, H=4, KV=2, D=64, ps=16, ppseq=2, lengths=[3])
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
                     torch.from_numpy(vp).bfloat16(), torch.from_numpy(lens), torch.from_numpy(table))
