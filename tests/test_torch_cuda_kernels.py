"""Kernels K1 and K4 against their plain versions on the GPU.

Runs only where a CUDA device and nvcc exist (``-m cuda``); elsewhere each
test skips with the reason. ``python3 chip_smoke.py`` runs the same checks
at the serving shapes, plus the engine end to end. Tolerances: bf16 output
against an fp32 plain version on the same bf16 inputs, 2e-2 (bf16 ulp is
2^-8 relative); LSE in fp32, 1e-3.
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


@pytest.mark.parametrize("B,S,H,KV", [(1, 128, 4, 4), (2, 1000, 16, 4), (3, 333, 8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(dev, B, S, H, KV, causal):
    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device=dev).manual_seed(B * S)
    q = torch.randn(B, S, H, 64, device=dev, generator=g).bfloat16()
    k = torch.randn(B, S, KV, 64, device=dev, generator=g).bfloat16()
    v = torch.randn(B, S, KV, 64, device=dev, generator=g).bfloat16()
    lens = torch.tensor([S - 7 * i for i in range(B)], device=dev)
    seg = (torch.arange(S, device=dev)[None] >= lens[:, None]).int()
    before = att.LAUNCHES
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    assert att.LAUNCHES == before + 1
    o_ref, lse_ref = att.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                                       segment_ids=seg, return_lse=True)
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref.reshape(B * H, S)).abs().max().item() <= 1e-3


def test_flash_wrapper_refuses_gradients(dev):
    from ray_tpu_torch.ops.attention import flash_attention

    q = torch.randn(1, 64, 4, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="later slice"):
        flash_attention(q, k, k)


@pytest.mark.parametrize("H,KV,ps", [(16, 4, 128), (8, 8, 16), (8, 1, 64)])
def test_paged_kernel_matches_plain(dev, H, KV, ps):
    from ray_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(H + KV + ps)
    B, ppseq = 9, 6
    lengths = rng.integers(1, ppseq * ps + 1, B)
    lengths[:2] = [0, ppseq * ps]
    P_total = B * ppseq + 1
    g = torch.Generator(device=dev).manual_seed(ps)
    kp = torch.randn(KV, P_total, ps, 64, device=dev, generator=g).bfloat16()
    vp = torch.randn(KV, P_total, ps, 64, device=dev, generator=g).bfloat16()
    q = torch.randn(B, H, 64, device=dev, generator=g).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = torch.from_numpy(table).to(dev)
    o = pa.paged_attention(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    assert (o.float() - ref).abs().max().item() <= 2e-2
    assert not o[0].any()
