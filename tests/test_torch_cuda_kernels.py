"""Kernels K1-K4 against their plain versions on the GPU.

Runs only where a CUDA device and nvcc exist (``-m cuda``); elsewhere each
test skips with the reason. ``python3 chip_smoke.py`` runs the same checks
at the serving and training shapes, plus the engine and the training step
end to end. Tolerances: bf16 output against an fp32 plain version on the
same bf16 inputs, 2e-2 (bf16 ulp is 2^-8 relative); LSE in fp32, 1e-3. K1
and K3/K2 run over GQA, MHA and MQA, pad and packed segments, ragged S and
S under one tile, causal and not, at head dims 64, 128 and 256 (the three
instances of each kernel, behind one wrapper; D 256 at Gemma's heads, 8
and 1, and GQA 8 and 2); K4 over page sizes, groups 1-8, head dims,
B 1 (one sequence split over many blocks) and ragged batches with lengths 0,
1, a page multiple and the full table. Each kernel gives the same bits on
a second launch; K4's ticket counters are back at 0 after every call. The
backward (K3 dQ, K2 dK/dV) rounds P and dS to bf16 before its products, as
the TPU kernels do, and sums up to S * group such terms: gradients are held
to 2e-2 of their largest magnitude plus 2e-2 absolute.
"""
import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the GPU")
    from ray_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except _build.KernelBuildError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(dev, B, S, H, KV, seed, segs="pad", D=64):
    """Inputs of the backward. segs "pad": a pad segment at the end of each
    row (7 more tokens per row); "packed": three packed segments per row,
    boundaries at other places in each row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
    k = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
    do = torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
    pos = torch.arange(S, device=dev)[None]
    if segs == "packed":
        cuts = torch.tensor([[S // 3 + 5 * i, 2 * S // 3 - 11 * i] for i in range(B)], device=dev)
        seg = ((pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int())
    else:
        lens = torch.tensor([S - 7 * i for i in range(B)], device=dev)
        seg = (pos >= lens[:, None]).int()
    return q, k, v, do, seg


def _close(got, want):
    err = (got.float() - want).abs().max().item()
    return err <= 2e-2 * want.abs().max().item() + 2e-2, err


# (B, S, H, KV, segments, D) of K1: GQA, MHA and MQA (H 8, KV 1); a pad
# segment or three packed segments per row; S a multiple of the 128-row
# block, ragged (333, 700, 1000), exactly one tile (64) and under one (33);
# head dim 64, at Mistral-7B's heads (32, 8) among others 128, and at
# Gemma's (8, 1) and GQA (8, 2) 256.
FWD_CASES = [(1, 128, 4, 4, "pad", 64), (2, 1000, 16, 4, "pad", 64), (3, 333, 8, 2, "pad", 64),
             (2, 512, 8, 1, "pad", 64), (2, 700, 16, 4, "packed", 64), (1, 64, 4, 2, "pad", 64),
             (2, 33, 8, 2, "pad", 64),
             (1, 128, 4, 4, "pad", 128), (2, 1000, 32, 8, "pad", 128), (3, 333, 8, 2, "pad", 128),
             (2, 512, 8, 1, "pad", 128), (2, 700, 32, 8, "packed", 128), (1, 64, 4, 2, "pad", 128),
             (2, 33, 8, 2, "pad", 128),
             (1, 128, 4, 4, "pad", 256), (2, 1000, 8, 1, "pad", 256), (3, 333, 8, 2, "pad", 256),
             (2, 700, 8, 1, "packed", 256), (2, 1000, 8, 2, "packed", 256), (1, 64, 8, 1, "pad", 256),
             (2, 33, 8, 2, "pad", 256)]


@pytest.mark.parametrize("B,S,H,KV,segs,D", FWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(dev, B, S, H, KV, segs, D, causal):
    from ray_tpu_torch.ops import attention as att

    q, k, v, _, seg = _qkv(dev, B, S, H, KV, seed=B * S, segs=segs, D=D)
    before = att.LAUNCHES
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    assert att.LAUNCHES == before + 1
    o_ref, lse_ref = att.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                                       segment_ids=seg, return_lse=True)
    assert bool(torch.isfinite(o).all())
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref.reshape(B * H, S)).abs().max().item() <= 1e-3


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_is_deterministic(dev, causal, D):
    """K1 has no atomics: two launches on the same inputs give the same bits."""
    from ray_tpu_torch.ops import attention as att

    q, k, v, _, seg = _qkv(dev, 2, 1000, 16, 4, seed=5, segs="packed", D=D)
    (o1, l1), (o2, l2) = (att.flash_fwd(q, k, v, segment_ids=seg, causal=causal) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


# (B, S, H, KV, segments, D): GQA, MHA and MQA (H 8, KV 1); a pad segment
# or three packed segments per row; S a multiple of the 64-row tile, ragged
# (333, 1000, 33 < one tile) and exactly one tile (64); head dim 64, 128 and
# 256 (at Gemma's heads, 8 and 1, and GQA 8 and 2).
BWD_CASES = [(1, 128, 4, 4, "pad", 64), (2, 1000, 16, 4, "pad", 64), (3, 333, 8, 2, "pad", 64),
             (2, 512, 8, 1, "pad", 64), (2, 700, 16, 4, "packed", 64), (1, 64, 4, 2, "pad", 64),
             (2, 33, 8, 2, "pad", 64),
             (1, 128, 4, 4, "pad", 128), (2, 1000, 32, 8, "pad", 128), (3, 333, 8, 2, "pad", 128),
             (2, 512, 8, 1, "pad", 128), (2, 700, 32, 8, "packed", 128), (1, 64, 4, 2, "pad", 128),
             (2, 33, 8, 2, "pad", 128),
             (1, 128, 4, 4, "pad", 256), (2, 1000, 8, 1, "pad", 256), (3, 333, 8, 2, "pad", 256),
             (2, 700, 8, 1, "packed", 256), (2, 1000, 8, 2, "packed", 256), (1, 64, 8, 1, "pad", 256),
             (2, 33, 8, 2, "pad", 256)]


@pytest.mark.parametrize("B,S,H,KV,segs,D", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(dev, B, S, H, KV, segs, D, causal):
    from ray_tpu_torch.ops import attention as att

    q, k, v, do, seg = _qkv(dev, B, S, H, KV, seed=B * S + causal, segs=segs, D=D)
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    before = (att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES)
    grads = att.flash_bwd(q, k, v, o, lse, do, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    assert (att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = att.flash_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                   segment_ids=seg, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), name
        ok, err = _close(g, w)
        assert ok, (name, err)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("segs", ["pad", "packed"])
def test_flash_bwd_kernels_are_deterministic(dev, segs, D):
    """K3 and K2 sum in a fixed order (no atomics): two launches on the same
    inputs give the same bits."""
    from ray_tpu_torch.ops import attention as att

    q, k, v, do, seg = _qkv(dev, 2, 1000, 16, 4, seed=11, segs=segs, D=D)
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(-1, 1000)
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, seg), *att.flash_bwd_dkv(q, k, v, do, lse, delta, seg))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_autograd_runs_the_three_kernels(dev, D):
    from ray_tpu_torch.ops import attention as att

    q, k, v, do, seg = _qkv(dev, 2, 300, 8, 2, seed=3, D=D)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (att.LAUNCHES, att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES)
    # dO reaches the backward strided (the same values, heads-major in
    # memory), as the model's output projection can hand it back.
    do_strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    (att.flash_attention(*leaves, causal=True, segment_ids=seg) * do_strided).sum().backward()
    torch.cuda.synchronize()
    assert (att.LAUNCHES, att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES) == tuple(n + 1 for n in before)
    ref = [t.float().detach().requires_grad_(True) for t in (q, k, v)]
    (att.mha_reference(*ref, causal=True, segment_ids=seg) * do.float()).sum().backward()
    for name, got, want in zip(("dq", "dk", "dv"), leaves, ref):
        ok, err = _close(got.grad, want.grad)
        assert ok, (name, err)


def test_one_wrapper_dispatches_both_head_dims(dev):
    """The same wrappers take D 64, 128 and 256 (each launches its own
    template instance and agrees with the plain version) and refuse other
    head dims before any launch."""
    from ray_tpu_torch.ops import attention as att

    for D in (64, 128, 256, 64):
        q, k, v, do, seg = _qkv(dev, 1, 200, 8, 2, seed=D, D=D)
        before = (att.LAUNCHES, att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES)
        o, lse = att.flash_fwd(q, k, v, segment_ids=seg)
        grads = att.flash_bwd(q, k, v, o, lse, do, segment_ids=seg)
        torch.cuda.synchronize()
        assert (att.LAUNCHES, att.BWD_DQ_LAUNCHES, att.BWD_DKV_LAUNCHES) == tuple(n + 1 for n in before)
        assert (o.float() - att.mha_reference(q.float(), k.float(), v.float(), segment_ids=seg)).abs().max() <= 2e-2
        want = att.flash_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), segment_ids=seg)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            ok, err = _close(g, w)
            assert ok, (D, name, err)
    for D in (32, 512):
        q, k, v, _, _ = _qkv(dev, 1, 64, 4, 2, seed=0, D=D)
        before = att.LAUNCHES
        with pytest.raises(ValueError, match="head_dim"):
            att.flash_fwd(q, k, v)
        assert att.LAUNCHES == before


def _paged_inputs(dev, lengths, H, KV, D, ps, ppseq, seed):
    """A pool where each sequence owns shuffled pages; dead entries page 0."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P_total = B * ppseq + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn(KV, P_total, ps, D, device=dev, generator=g).bfloat16()
    vp = torch.randn(KV, P_total, ps, D, device=dev, generator=g).bfloat16()
    q = torch.randn(B, H, D, device=dev, generator=g).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(np.asarray(lengths), dtype=torch.int32, device=dev)
    return q, kp, vp, lens, torch.from_numpy(table).to(dev)


def _paged_lengths(B, ps, ppseq, seed):
    """B 1: one sequence over most of its table (the split's case); else
    ragged lengths with 0, 1, an exact multiple of the page and the full
    table."""
    if B == 1:
        return [ppseq * ps - 3]
    lengths = np.random.default_rng(seed).integers(1, ppseq * ps + 1, B)
    lengths[:4] = [0, 1, 2 * ps, ppseq * ps]
    return lengths


def _check_paged(dev, lengths, H, KV, D, ps, ppseq, seed):
    from ray_tpu_torch.ops import paged_attention as pa

    q, kp, vp, lens, table = _paged_inputs(dev, lengths, H, KV, D, ps, ppseq, seed)
    before = pa.LAUNCHES
    o = pa.paged_attention(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    assert bool(torch.isfinite(o).all())
    assert (o.float() - ref).abs().max().item() <= 2e-2
    for b, n in enumerate(lengths):
        if n == 0:
            assert not o[b].any()
    return o, (q, kp, vp, lens, table)


@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("ps", [16, 64, 128])
def test_paged_kernel_matches_plain(dev, B, group, ps):
    ppseq = 24 if B == 1 else 6
    _check_paged(dev, _paged_lengths(B, ps, ppseq, seed=ps + group), 2 * group, 2, 64, ps, ppseq, seed=B + ps)


@pytest.mark.parametrize("D,ps", [(128, 32), (40, 16), (256, 128)])
def test_paged_kernel_other_head_dims(dev, D, ps):
    """D % 8 == 0 up to 256; pages of more than 8192 elements load in tiles."""
    _check_paged(dev, _paged_lengths(9, ps, 5, seed=D), 16, 4, D, ps, 5, seed=D)


def test_paged_kernel_at_gemma_decode_shape(dev):
    """D 256, group 8 (Gemma-2B's 8 heads over one KV head), page 128: the
    serving cell's decode shape (32 sequences of 2049..2176 tokens), one
    sequence split over most of its table, and two launches bitwise equal."""
    from ray_tpu_torch.ops import paged_attention as pa

    lengths = np.random.default_rng(7).integers(2049, 2177, 32)
    o1, inputs = _check_paged(dev, lengths, 8, 1, 256, 128, 18, seed=7)
    _check_paged(dev, _paged_lengths(1, 128, 18, seed=8), 8, 1, 256, 128, 18, seed=8)
    o2 = pa.paged_attention(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


def test_paged_kernel_is_deterministic_and_resets_its_counters(dev):
    """The runs merge in page order: two launches give the same bits. A call
    with another batch size in between sees counters at 0."""
    from ray_tpu_torch.ops import paged_attention as pa

    lengths = _paged_lengths(32, 128, 16, seed=1)
    o1, inputs = _check_paged(dev, lengths, 16, 4, 64, 128, 16, seed=1)
    _check_paged(dev, _paged_lengths(5, 128, 16, seed=2), 16, 4, 64, 128, 16, seed=2)
    o2 = pa.paged_attention(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    assert not pa._COUNTERS[o1.device].any()


def test_flash_kernels_launch_first_from_a_fresh_thread(dev):
    """K1, K3 and K2 launched first from a thread that has done no CUDA work
    of its own (the inputs made on this thread, the outputs' memory served
    from the allocator's cache), as a compiled DAG's stage method runs on
    its actor's pool thread after the edge restored its tensors on the IO
    thread: they run and give the bits of the same launches on this thread
    (the kernels are deterministic). Before ops.attention._stream bound the
    device's context for the thread, K1 failed there with
    cudaErrorInvalidValue."""
    import threading

    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, 256, 4, 64, device=dev, generator=g).bfloat16()
    k, v = (torch.randn(2, 256, 2, 64, device=dev, generator=g).bfloat16() for _ in range(2))
    do = torch.randn(2, 256, 4, 64, device=dev, generator=g).bfloat16()
    want_o, want_lse = att.flash_fwd(q, k, v)
    want = att.flash_bwd(q, k, v, want_o, want_lse, do)
    # Free blocks of the outputs' sizes, so the thread's allocations come
    # from the cache and need no runtime call of their own.
    spare = [torch.empty_like(t) for t in (q, want_lse, q, k, v)]
    del spare
    torch.cuda.synchronize()
    got, errors = {}, []

    def run():
        try:
            got["fwd"] = att.flash_fwd(q, k, v)
            got["bwd"] = att.flash_bwd(q, k, v, *got["fwd"], do)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (asserted below)
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got["fwd"] + got["bwd"], (want_o, want_lse) + want))
