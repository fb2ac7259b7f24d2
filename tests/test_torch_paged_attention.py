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


# The split-page algebra of kernel K4 (per-run partials merged in page
# order), in plain PyTorch: the plan, the merge and the split version
# against the TPU kernel and the plain version. The main path never calls
# the split version.

def test_pages_per_block_plan():
    from ray_tpu_torch.ops.paged_attention import pages_per_block

    assert pages_per_block(32, 4, 16, 128, 132) == 1  # the engine's decode shape
    assert pages_per_block(1, 4, 24, 128, 132) == 1  # one long sequence: every page its own block
    assert pages_per_block(1, 4, 24, 16, 132) == 8  # small pages: >= 128 tokens per run
    assert pages_per_block(32, 2, 6, 16, 132) == 6  # never more than the table
    # A grid too large for the card: runs double until it fits 16 blocks per SM.
    ppb = pages_per_block(256, 8, 256, 128, 132)
    assert 256 * 8 * -(-256 // ppb) <= 16 * 132 < 256 * 8 * -(-256 // (ppb // 2))
    assert pages_per_block(256, 8, 256, 128, 132) == ppb  # a pure function of the shape


def test_empty_partial_merges_without_nan():
    from ray_tpu_torch.ops.paged_attention import merge_partials

    acc = torch.tensor([[[0.0, 0.0], [2.0, 4.0], [0.0, 0.0]]])  # [1, R=3, D=2]
    m = torch.tensor([[float("-inf"), 1.5, float("-inf")]])
    l = torch.tensor([[0.0, 2.0, 0.0]])
    out = merge_partials(m, l, acc)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, torch.tensor([[1.0, 2.0]]))
    # Every run empty (a length-0 sequence): 0, not NaN.
    none = merge_partials(torch.full((1, 3), float("-inf")), torch.zeros(1, 3), torch.zeros(1, 3, 2))
    assert torch.equal(none, torch.zeros(1, 2))


@pytest.mark.parametrize("H,KV", [(8, 8), (16, 4)])  # group 1 and 4
@pytest.mark.parametrize("pages_per_run", [1, 2, 3])
def test_split_reference_matches_jax_kernel_and_plain(H, KV, pages_per_run):
    from ray_tpu_torch.ops.paged_attention import paged_attention_reference, paged_attention_split_reference

    # Ragged lengths: 0, 1, an exact multiple of the page, the full table.
    case = _make_case(B=6, H=H, KV=KV, D=64, ps=16, ppseq=5, lengths=[0, 1, 32, 80, 47, 17],
                      seed=H + pages_per_run)
    q, kp, vp, lens, table = case
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
                                jnp.asarray(table), interpret=True))
    t = [torch.from_numpy(a) for a in case]
    got = paged_attention_split_reference(*t, pages_per_run=pages_per_run)
    assert torch.isfinite(got).all() and not got[0].any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), paged_attention_reference(*t).numpy(), **TOL)


def test_outgrown_ticket_counters_are_never_freed():
    """A CUDA graph that captured K4 replays it against the ticket counters'
    address and holds no reference to them: a buffer that a larger batch
    outgrows stays alive and zero, and later launches get the larger one."""
    import gc
    import weakref

    from ray_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cpu")
    old = pa._counters(dev, 1)
    n, ref = old.numel(), weakref.ref(old)
    del old
    big = pa._counters(dev, n + 1)
    gc.collect()
    assert ref() is not None and ref() is not big and not ref().any()
    assert big.numel() > n and pa._counters(dev, 1) is big
