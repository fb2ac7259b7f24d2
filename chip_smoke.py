#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build: compiles the CUDA kernels from ray_tpu_torch/ops/csrc (one nvcc
     per source, in parallel) into ray_tpu_torch/ops/_build_out.
  3. K1 (flash forward) against its plain version, mha_reference in fp32
     on the same bf16 inputs, at B in {1, 8}, S in {512, 1000, 2048}, H 16,
     KV 4, D 64, with a pad segment: max |o - o_ref| <= 2e-2 (bf16 output,
     ulp 2^-8 relative) and max |lse - lse_ref| <= 1e-3. Timed at the
     engine's prefill shape (one group of 8 prompts of 512 tokens).
  4. K4 (paged decode) against paged_attention_reference in fp32 on the same
     bf16 inputs: B 32, ragged lengths in 1..2048 plus one length-0 row,
     ps 128, 16 pages per sequence: max |o - o_ref| <= 2e-2. Timed at the
     engine's decode shape (32 sequences of 513..576 tokens).
  5. the engine end to end: the 250M-parameter GQA model (vocab 32000,
     d_model 1024, 12 layers, 16 heads, 4 KV heads, d_ff 4096, max_seq 2048)
     with seeded random weights, paged KV (page 128, 32 slots); warmup, then
     32 greedy requests of 512 prompt tokens and 64 new tokens. Both kernel
     launch counts are read across this run and must be > 0. The engine's
     prefill logits for all 32 prompts are held against the plain forward on
     the card: max |diff| <= 0.25 and mean |diff| <= 0.02 (bf16 logits of
     magnitude up to ~6, ulp 0.03, after 12 layers), and every request's
     first token must be within that tolerance of the plain top-1 logit.
     Then a short dense-layout run (4 requests), which runs K1 and not K4.
  6. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

``--profile DIR`` also traces the paged engine with torch.profiler (the
admission step with its prefills, then two decode steps) and writes the
kernel tables and traces to DIR.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
H, KV, D = 16, 4, 64
MODEL = dict(vocab_size=32_000, d_model=1024, n_layers=12, n_heads=H, n_kv_heads=KV,
             d_ff=4096, max_seq_len=2048)
N_REQ, PROMPT_LEN, MAX_TOKENS, SLOTS, PAGE = 32, 512, 64, 32, 128
K1_CHECK = ((1, 512), (1, 1000), (1, 2048), (8, 512), (8, 1000), (8, 2048))  # (B, S)
K4_B, K4_PPSEQ = 32, 16  # sequences; pages per sequence (max length 2048)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        path = _build.log_path(name)
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")


def _seg(B, S, rng):
    """Prompt padding as the engine builds it: pads are their own segment."""
    lens = rng.integers(S // 2, S + 1, B)
    return (np.arange(S)[None, :] >= lens[:, None]).astype(np.int32)


def k1_cost(seg, nbytes_io):
    """FLOPs this input needs (valid causal same-segment pairs only) and bytes."""
    pairs = 0
    for row in seg:
        for s_id in np.unique(row):
            n = int((row == s_id).sum())
            pairs += n * (n + 1) // 2
    return 4 * D * H * pairs, nbytes_io


def phase_k1(dev, rng):
    import torch

    from ray_tpu_torch.ops import attention as att

    worst = 0.0
    for B, S in K1_CHECK:
        q = torch.randn(B, S, H, D, device=dev).bfloat16()
        k = torch.randn(B, S, KV, D, device=dev).bfloat16()
        v = torch.randn(B, S, KV, D, device=dev).bfloat16()
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = att.mha_reference(q.float(), k.float(), v.float(), causal=True,
                                           segment_ids=seg, return_lse=True)
        err = (o.float() - o_ref).abs().max().item()
        lse_err = (lse - lse_ref.reshape(B * H, S)).abs().max().item()
        finite = bool(torch.isfinite(o).all())
        log(f"K1 B={B} S={S}: max|o-ref| {err:.3e}  max|lse-ref| {lse_err:.3e}  finite {finite}")
        if not (finite and err <= 2e-2 and lse_err <= 1e-3):
            raise AssertionError(f"K1 disagrees with its plain version at B={B} S={S}")
        worst = max(worst, err)
        del o_ref, lse_ref
    # Timing at the engine's prefill shape: one group of 8 prompts of 512
    # tokens in the 512 bucket (no padding, so one segment per row).
    B, S = 8, PROMPT_LEN
    q = torch.randn(B, S, H, D, device=dev).bfloat16()
    k = torch.randn(B, S, KV, D, device=dev).bfloat16()
    v = torch.randn(B, S, KV, D, device=dev).bfloat16()
    seg_np = np.zeros((B, S), np.int32)
    seg = torch.from_numpy(seg_np).to(dev)
    ms = time_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    plain_ms = time_ms(lambda: att.mha_reference(q, k, v, causal=True, segment_ids=seg))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S + 4 * B * S
    bound_ms, bound_by = bound(*k1_cost(seg_np, nbytes))
    log(f"K1 at engine shape B={B} S={S}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa {library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _paged_case(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ):
    import torch

    B = len(lengths)
    P_total = B * ppseq + 1
    kp = torch.randn(KV, P_total, ps, D, device=dev).bfloat16()
    vp = torch.randn(KV, P_total, ps, D, device=dev).bfloat16()
    q = torch.randn(B, H, D, device=dev).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, torch.from_numpy(table).to(dev)


def phase_k4(dev, rng):
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    max_len = PAGE * K4_PPSEQ
    lengths = rng.integers(1, max_len + 1, K4_B)
    lengths[[0, 1, K4_B - 1]] = [0, 1, max_len]
    q, kp, vp, lens, table = _paged_case(dev, rng, lengths)
    o = pa.paged_decode(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    o_ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    err = (o.float() - o_ref).abs().max().item()
    zero_row = not o[0].any().item()
    log(f"K4 B={K4_B} ragged lengths 0..{max_len}: max|o-ref| {err:.3e}  length-0 row is zero {zero_row}")
    if not (err <= 2e-2 and zero_row and bool(torch.isfinite(o).all())):
        raise AssertionError("K4 disagrees with its plain version")
    # Timing at the engine's decode shape; 8 pool copies rotate so each launch
    # reads its pages from device memory, as the engine's do (12 layers apart).
    lengths = rng.integers(PROMPT_LEN + 1, PROMPT_LEN + MAX_TOKENS + 1, N_REQ)
    cases = [_paged_case(dev, rng, lengths) for _ in range(8)]
    it = iter(range(1 << 30))

    def run(fn):
        return lambda: fn(*cases[next(it) % len(cases)])

    ms = time_ms(run(pa.paged_decode), iters=40)
    plain_ms = time_ms(run(pa.paged_attention_reference), iters=40)
    tokens = int(lengths.sum())
    pages = int(sum(math.ceil(n / PAGE) for n in lengths))
    nbytes = 2 * tokens * KV * D * 2 + 2 * N_REQ * H * D * 2 + 4 * N_REQ + 4 * pages
    bound_ms, bound_by = bound(4 * H * D * tokens, nbytes)
    log(f"K4 at engine shape B={N_REQ} lengths {lengths.min()}..{lengths.max()}: kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def drive(eng, prompts, max_tokens):
    """Queues every prompt, steps until all finish. Returns per-request
    results and the wall times of the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", p, max_tokens)
    done, ttft = {}, {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("ttft_s") is not None and rid not in ttft:
                ttft[rid] = ev["ttft_s"]
            if ev.get("finished"):
                done[rid] = ev
    torch.cuda.synchronize()
    return done, ttft, t0, time.perf_counter()


def check_first_tokens(cfg, eng, prompts, done, dev, tol_max=0.25, tol_mean=0.02):
    """The engine's prefill logits against the plain forward, and each
    request's first token against the plain logits' top-1."""
    import torch

    from ray_tpu_torch.models import forward

    n = len(prompts)
    toks = torch.tensor(np.stack(prompts), dtype=torch.long, device=dev)
    with torch.no_grad():
        plain = forward(eng.params, toks, cfg)[:, -1].float()  # [n, V]
        third = (np.zeros((n, PROMPT_LEN // PAGE), np.int32) if eng.paged
                 else np.arange(n, dtype=np.int64))  # dead page / idle slots
        served = eng._prefill_logits(np.stack(prompts), np.full(n, PROMPT_LEN, np.int32), third)
    diff = (served - plain).abs()
    first = torch.tensor([done[f"r{i}"]["tokens"][0] for i in range(n)], device=dev)
    gap = plain.max(dim=-1).values - plain.gather(1, first[:, None])[:, 0]
    top1 = int((first == plain.argmax(dim=-1)).sum())
    log(f"  prefill logits vs plain forward: max|diff| {diff.max().item():.4f}  "
        f"mean|diff| {diff.mean().item():.5f}  first token top-1 {top1}/{n}  "
        f"worst top-1 gap {gap.max().item():.4f}")
    if not (bool(torch.isfinite(served).all()) and diff.max() <= tol_max and diff.mean() <= tol_mean
            and gap.max() <= tol_max):
        raise AssertionError("engine prefill disagrees with the plain forward")


def phase_engine(dev, rng, profile_dir=None):
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    cfg = TransformerConfig(**MODEL)
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0))
    n_params = sum(t.numel() for t in [eng.params["embed"], eng.params["lm_head"],
                                       eng.params["final_norm"], *eng.params["layers"].values()])
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    log(f"engine: {n_params / 1e6:.1f}M params, paged KV, warmup {time.perf_counter() - t0:.2f} s")
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32) for _ in range(N_REQ)]
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    done, ttft, t0, t1 = drive(eng, prompts, MAX_TOKENS)
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    n_tok = sum(len(ev["tokens"]) for ev in done.values())
    ok = (len(done) == N_REQ and all(len(ev["tokens"]) == MAX_TOKENS and ev["finish_reason"] == "length"
                                     and all(0 <= t < cfg.vocab_size for t in ev["tokens"])
                                     for ev in done.values()))
    tt = sorted(ttft.values())
    # Every request arrives at t0 and the last first token lands at t0 + max
    # TTFT; from then on the engine only decodes.
    decode_s = t1 - t0 - max(tt)
    stats = dict(
        ttft_p50_ms=1e3 * statistics.median(tt),
        ttft_p99_ms=1e3 * tt[min(len(tt) - 1, math.ceil(0.99 * len(tt)) - 1)],
        decode_tok_s=(n_tok - N_REQ) / decode_s,
        tok_s=n_tok / (t1 - t0),
        wall_s=t1 - t0,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"engine paged: {len(done)} requests x {MAX_TOKENS} tokens, wall {stats['wall_s']:.3f} s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
        f"decode {stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, "
        f"peak mem {stats['peak_mem_gb']:.2f} GB")
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']}")
    if not ok:
        raise AssertionError("paged engine run did not finish every request with max_tokens valid tokens")
    if not (launches["flash_fwd"] > 0 and launches["paged_decode"] > 0):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    check_first_tokens(cfg, eng, prompts, done, dev)
    if profile_dir:
        profile_engine(eng, prompts, profile_dir)
    del eng
    torch.cuda.empty_cache()

    # Dense layout (the engine's default): prefill runs K1, decode is plain.
    dense = LLMEngine(cfg, engine_config=EngineConfig(max_slots=4, max_seq=2048, seed=0))
    dense.warmup(buckets=(PROMPT_LEN,))
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    d_done, d_ttft, d0, d1 = drive(dense, prompts[:4], 16)
    d_launch = (attention.LAUNCHES, paged_attention.LAUNCHES)
    log(f"engine dense: 4 requests x 16 tokens, wall {d1 - d0:.3f} s, "
        f"TTFT p50 {1e3 * statistics.median(d_ttft.values()):.2f} ms, launches K1 {d_launch[0]} K4 {d_launch[1]}")
    if not (len(d_done) == 4 and all(len(ev["tokens"]) == 16 for ev in d_done.values())):
        raise AssertionError("dense engine run did not finish")
    if d_launch[0] == 0 or d_launch[1] != 0:
        raise AssertionError(f"dense run launches {d_launch}: expected K1 > 0 and K4 == 0")
    check_first_tokens(cfg, dense, prompts[:4], d_done, dev)
    return stats, launches


def _profile_window(name, fn, out_dir):
    """torch.profiler over fn(); writes the kernel table and the trace to
    out_dir and prints the wall time, device kernel time and top rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    ka = prof.key_averages()
    key = "self_device_time_total" if ka and hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(ka.table(sort_by=key, row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}.json"))
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, device kernel time {dev_us / 1e3:.2f} ms "
        f"(busy share {dev_us / 1e6 / wall:.3f})")
    log(ka.table(sort_by=key, row_limit=12))


def profile_engine(eng, prompts, out_dir):
    """The paged engine under torch.profiler: the admission step (32
    prefills and the first decode block), then two decode-only steps."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(prompts):
        eng.add_request(f"p{i}", p, MAX_TOKENS)
    _profile_window("admit_step", eng.step, out_dir)
    _profile_window("decode_2_steps", lambda: (eng.step(), eng.step()), out_dir)
    while eng.has_work():
        eng.step()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace the paged engine's steps into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    k1 = phase_k1(dev, rng)
    k4 = phase_k4(dev, rng)
    stats, launches = phase_engine(dev, rng, args.profile)
    kernels = [
        dict(name="flash_fwd", route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="ray_tpu/ops/attention.py:92", launches=launches["flash_fwd"], **k1),
        dict(name="paged_decode", route="cuda", source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:67", launches=launches["paged_decode"], **k4),
    ]
    log(json.dumps({"engine": stats}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
