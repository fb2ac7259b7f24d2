"""Mellum2's kernels on the card: K1's and K4's sliding-window instances
against their plain versions, K6 (the routed experts) against its plain
version at the serving cell's decode and prefill shapes, and a paged engine
with experts and windows whose decode graphs hand over the tokens an eager
engine computes.

Tolerances as in ``test_torch_cuda_kernels``: bf16 outputs against fp32
plain versions on the same bf16 inputs, 2e-2 (the bf16 ulp is 2^-8). K6
rounds the SwiGLU intermediate to bf16 as its plain version does, and sums
2304 or 896 products in fp32 in another order: 2e-2 of the output's
largest magnitude. Greedy tokens of graph and eager engines are equal
bitwise (the replay launches the eager body's kernels in its order).

Runs only where a CUDA device exists (``-m cuda``; on the chip machine run
it with ``--noconftest``); elsewhere each test skips with the reason.
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


@pytest.mark.parametrize("S,window", [(2048, 1024), (1000, 1024), (1100, 100), (64, 1), (333, 64)])
def test_k1_window_against_the_plain_version(dev, S, window):
    from ray_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(S + window)
    B, H, KV, D = 2, 32, 4, 128
    q = torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
    k = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
    seg = (torch.arange(S, device=dev)[None] >= torch.tensor([[S], [S - 37]], device=dev)).int()
    before = attention.LAUNCHES
    o, lse = attention.flash_fwd(q, k, v, segment_ids=seg, window=window)
    assert attention.LAUNCHES == before + 1
    want, want_lse = attention.mha_reference(q.float(), k.float(), v.float(), segment_ids=seg, window=window,
                                             return_lse=True)
    torch.testing.assert_close(o.float(), want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse.view(B, H, S), want_lse, rtol=1e-3, atol=1e-3)
    o2, _ = attention.flash_fwd(q, k, v, segment_ids=seg, window=window)
    assert torch.equal(o, o2)


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("window", [1024, 200])
def test_k4_window_against_the_plain_version(dev, ps, window):
    from ray_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(ps + window)
    B, H, KV, D, ppseq = 64, 32, 4, 128, 8832 // ps
    P_total = B * ppseq + 1
    q = torch.randn(B, H, D, device=dev, generator=g).bfloat16()
    kp = torch.randn(KV, P_total, ps, D, device=dev, generator=g).bfloat16()
    vp = torch.randn(KV, P_total, ps, D, device=dev, generator=g).bfloat16()
    table = (torch.randperm(P_total - 1, device=dev, generator=g)[:B * ppseq] + 1).int().view(B, ppseq)
    lengths = torch.randint(1, 8832, (B,), device=dev, generator=g).int()
    lengths[:6] = torch.tensor([0, 1, window, window + 1, ps * 9, 8832], device=dev, dtype=torch.int32)
    o = pa.paged_attention(q, kp, vp, lengths, table, window=window)
    want = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lengths, table, window=window)
    torch.testing.assert_close(o.float(), want, rtol=2e-2, atol=2e-2)
    assert torch.equal(o, pa.paged_attention(q, kp, vp, lengths, table, window=window))
    assert int(pa._COUNTERS[dev].abs().sum()) == 0


@pytest.mark.parametrize("T", [64, 4096, 3])
def test_k6_against_the_plain_version(dev, T):
    """The serving cell's decode (64 slots) and prefill (one 4096-token
    prompt) shapes, and 3 tokens, which leave most experts without a row."""
    from ray_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(T)
    D, F, E, k = 2304, 896, 64, 8
    x = torch.randn(T, D, device=dev, generator=g).bfloat16()
    router = (torch.randn(D, E, device=dev, generator=g) / math.sqrt(D)).bfloat16()
    wg = (torch.randn(E, D, F, device=dev, generator=g) / math.sqrt(D)).bfloat16()
    wu = (torch.randn(E, D, F, device=dev, generator=g) / math.sqrt(D)).bfloat16()
    wd = (torch.randn(E, F, D, device=dev, generator=g) / math.sqrt(F)).bfloat16()
    w, ids = moe.route(x, router, k)
    before = moe.LAUNCHES
    y, counts = moe.moe_experts(x, w, ids, wg, wu, wd)
    assert moe.LAUNCHES == before + moe.GEMM_LAUNCHES_PER_CALL
    want, want_counts = moe.moe_experts_reference(x, w, ids, wg, wu, wd)
    assert torch.equal(counts.long(), want_counts)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2, atol=2e-2 * scale)
    assert torch.equal(y, moe.moe_experts(x, w, ids, wg, wu, wd)[0])


MODEL = dict(vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=1, head_dim=128, d_ff=128,
             max_seq_len=512, n_experts=8, expert_top_k=2, layer_types=("sliding", "sliding", "sliding", "full"),
             sliding_window=64, rope_scaling={"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings":
                                              128, "beta_fast": 32, "beta_slow": 1, "attention_factor": 1.1386})
ENGINE = dict(max_slots=4, max_seq=512, kv_layout="paged", page_size=16, prefill_buckets=(64, 128),
              decode_block=8, seed=3)


def _engine(params=None):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig

    eng = LLMEngine(TransformerConfig(**MODEL), params=params, engine_config=EngineConfig(**ENGINE), device="cuda")
    eng.warmup()
    return eng


def _run(eng, prompts):
    for i, p in enumerate(prompts):
        eng.add_request(str(i), p, max_tokens=150)
    out = {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("finished"):
                out[rid] = ev["tokens"]
    return out


def test_moe_window_decode_graphs_match_eager(dev):
    from ray_tpu_torch.ops import moe

    prompts = [np.random.default_rng(i).integers(1, 512, n).astype(np.int32) for i, n in enumerate((100, 30, 70))]
    graphed = _engine()
    eager = _engine(params=graphed.params)
    eager._graphs_on = False
    c0 = graphed.counters()
    launches = moe.LAUNCHES
    got = _run(graphed, prompts)
    c1 = graphed.counters()
    blocks = c1["decode_blocks"] - c0["decode_blocks"]
    assert blocks > 0 and c1["decode_graph_blocks"] - c0["decode_graph_blocks"] == blocks
    per_step = MODEL["n_layers"] * moe.GEMM_LAUNCHES_PER_CALL
    steps = c1["decode_token_steps"] - c0["decode_token_steps"]
    prefill_calls = (c1["prefill_groups"] - c0["prefill_groups"]) * MODEL["n_layers"] * moe.GEMM_LAUNCHES_PER_CALL
    assert moe.LAUNCHES - launches == steps * per_step + prefill_calls
    assert c1["moe_launches"] - c0["moe_launches"] == moe.LAUNCHES - launches
    assert got == _run(eager, prompts)
    assert all(len(t) == 150 for t in got.values())  # decoded far past the 64-key window
    load = graphed.expert_load()
    assert int(load.sum()) > 0 and load.shape == (4, 8)
