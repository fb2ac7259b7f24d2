#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build: compiles the CUDA kernels from ray_tpu_torch/ops/csrc (one nvcc
     per source, in parallel) into ray_tpu_torch/ops/_build_out.
  3. K1 (flash forward) against its plain version, mha_reference in fp32
     on the same bf16 inputs, at B in {1, 8}, S in {512, 1000, 2048}, H 16,
     KV 4, D 64, causal and not, with a pad segment, plus MQA (H 8, KV 1),
     three packed segments per row, S 64 and S 33: max |o - o_ref| <= 2e-2
     (bf16 output, ulp 2^-8 relative) and max |lse - lse_ref| <= 1e-3; two
     launches on the same inputs must be bitwise equal. Timed at the
     engine's prefill shape (one group of 8 prompts of 512 tokens) and at
     the training shape (B 16, S 2048, causal), with TFLOP/s and the time
     over its bound. Every kernel's `ms` (and SDPA's forward) is its device
     time from a CUDA graph of back-to-back calls (device_ms); `eager_ms`
     (K1 at the prefill shape, K4) is the eager back-to-back time, which at
     those shapes is the wrapper's host time.
  4. K4 (paged decode) against paged_attention_reference in fp32 on the same
     bf16 inputs: B 32, ragged lengths in 1..2048 plus one length-0 row,
     ps 128, 16 pages per sequence; then page sizes 16, 64 and 128 x groups
     1, 2, 4 and 8 x B 1 (one sequence over most of a 2048-token table: the
     split's case) and B 32 (lengths 0, 1, two pages exactly, the full
     table, the rest random): max |o - o_ref| <= 2e-2, length-0 rows zero.
     Two launches must be bitwise equal, and a call at another batch size
     in between must agree with its plain version (the ticket counters were
     reset). Timed at the engine's decode shape (32 sequences of 513..576
     tokens).
  5. K3 (backward dQ) and K2 (backward dK, dV) against flash_bwd_reference
     in fp32 on the same bf16 inputs (O and LSE from K1), at B in {1, 4},
     S in {512, 1000, 2048}, H 16, KV 4, D 64, causal and not, with a pad
     segment: max |g - g_ref| <= 2e-2 * max |g_ref| + 2e-2 for each of dq,
     dk, dv (bf16 outputs; P and dS are rounded to bf16 before their
     products, as in the TPU kernels, and each output sums up to S * group
     such terms). The same check at MQA (B 2, S 1000, H 8, KV 1), with
     three packed segments per row (B 2, S 2048), at S 64 (one tile) and
     S 33 (H 8, KV 2), then two launches of each kernel on the same inputs
     must be bitwise equal (no atomics). Each timed alone at the training
     shape (TFLOP/s reached, times its bound), beside the plain backward
     and, as the library yardstick for K2 + K3 together, the backward of
     scaled_dot_product_attention (one call: dq, dk and dv).
  5b. K5, splash onto K1-K3: K1, K3 and K2 on splash's inputs (q folded
     with the softmax scale in fp32, scale 1.0) against the plain versions
     on the same inputs (B 2, S 2048, packed segments; the tolerances of
     phases 3 and 5), then timed at the training shape beside the plain
     forward + backward and SDPA's forward + backward.
  6. the engine end to end: the 250M-parameter GQA model (vocab 32000,
     d_model 1024, 12 layers, 16 heads, 4 KV heads, d_ff 4096, max_seq 2048)
     with seeded random weights, paged KV (page 128, 32 slots); warmup, then
     32 greedy requests of 512 prompt tokens and 64 new tokens. Both kernel
     launch counts are read across this run and must be > 0. The engine's
     prefill logits for all 32 prompts are held against the plain forward on
     the card (attention_impl="reference": einsum attention, no kernel):
     max |diff| <= 0.25 and mean |diff| <= 0.02 (bf16 logits of magnitude up
     to ~6, ulp 0.03, after 12 layers), and every request's first token must
     be within that tolerance of the plain top-1 logit. Then a short
     dense-layout run (4 requests), which runs K1 and not K4.
  7. training: (a) the model cut to 2 layers, B 2 x S 2048, bf16: the
     gradients of one cross_entropy_loss through the kernels
     (attention_impl="flash": K1, K3, K2) against the plain path
     ("reference") on the same weights and batch, per leaf
     |g - g_ref| / |g_ref| <= 5e-2 (L2 norms; bf16 activations, the two
     paths round P and dS at different places); (b) the same model through
     the kernels with remat off, "full" and "dots": per leaf relative
     difference <= 5e-3 (the kernels are deterministic and the recompute
     repeats the same ops; only reduction order may differ); (c) the same
     model with attention_impl="splash" (K5: K1, K3, K2 on the folded q)
     against "flash": loss within 5e-2 and per-leaf relative difference
     <= 5e-2 (splash rounds q * scale to bf16 before the kernel, flash
     scales in fp32 inside it), each of K1, K3, K2 launched; (d) the
     bench.py:57-77 configuration at full width and depth (12 layers,
     remat "dots", AdamW) at B 16 x S 2048 on one seeded batch: a warmup
     step, then 10 timed steps through make_train_step. The loss must be
     finite and fall, and each step must launch K1 24 times (12 forward +
     12 recompute), K3 12 and K2 12. Prints step time, tokens/s, MFU
     (bench.py's formula, 6 N T + 12 L d S T, against 989 TFLOP/s) and peak
     memory.
  8. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

``--profile DIR`` also traces the paged engine with torch.profiler (the
admission step with its prefills, then two decode steps) and one training
step, prints each window's device time by kind of kernel, and writes the
kernel tables and traces to DIR.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
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
K4_PAGES, K4_GROUPS = (16, 64, 128), (1, 2, 4, 8)  # K4's sweep: page sizes, q heads per kv head
K23_CHECK = ((1, 512), (1, 1000), (1, 2048), (4, 512), (4, 1000), (4, 2048))  # (B, S)
# (B, S, H, KV, segments): MQA, three packed segments per row, one tile, under one tile.
K23_EXTRA = ((2, 1000, 8, 1, "pad"), (2, 2048, H, KV, "packed"), (2, 64, H, KV, "pad"), (3, 33, 8, 2, "pad"))
TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 2048, 10  # bench.py's batch and sequence
PARITY_LAYERS, PARITY_B = 2, 2


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean time of one call from CUDA events around `iters` eager calls.
    Where a call's host work (the Python wrapper, the launch) takes longer
    than its kernels, this is the host's time: the card waits between
    calls. Used for the plain versions and for SDPA's backward."""
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


def device_ms(fn, iters=20, replays=3):
    """Mean device time of one call: `iters` calls captured in one CUDA graph
    (after warmup calls on a side stream), replayed `replays` times between
    CUDA events, so no host work stands between the kernels. The kernels'
    `ms` and SDPA's forward are timed so."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    return card


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        path = _build.log_path(name)
        if path.exists():
            for line in path.read_text().splitlines():
                kernel = re.search(r"([a-z_]+_kernel)", line) if "entry function" in line else None
                if kernel:
                    log(f"  {name}: {kernel.group(1)}")
                elif "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")


def _seg(B, S, rng, kind="pad"):
    """"pad": prompt padding as the engine builds it (pads are their own
    segment); "packed": three packed examples per row, cut at random places."""
    pos = np.arange(S)[None, :]
    if kind == "packed":
        cuts = np.sort(rng.integers(1, S, (B, 2)), axis=1)
        return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))
    lens = rng.integers(S // 2, S + 1, B)
    return (pos >= lens[:, None]).astype(np.int32)


def causal_pairs(seg):
    """Valid (query, key) pairs per head under the causal and segment masks
    (segments contiguous, as the engine's pads and packed batches are)."""
    pairs = 0
    for row in seg:
        for s_id in np.unique(row):
            n = int((row == s_id).sum())
            pairs += n * (n + 1) // 2
    return pairs


def k1_cost(seg, nbytes_io):
    """FLOPs this input needs (valid causal same-segment pairs only) and bytes."""
    return 4 * D * H * causal_pairs(seg), nbytes_io


def _check_k1(dev, B, S, seg, causal, h=H, kv=KV, label="pad"):
    """K1 against mha_reference in fp32 on the same bf16 inputs; returns
    max |o - o_ref|."""
    import torch

    from ray_tpu_torch.ops import attention as att

    q = torch.randn(B, S, h, D, device=dev).bfloat16()
    k = torch.randn(B, S, kv, D, device=dev).bfloat16()
    v = torch.randn(B, S, kv, D, device=dev).bfloat16()
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = att.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                                       segment_ids=seg, return_lse=True)
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref.reshape(B * h, S)).abs().max().item()
    finite = bool(torch.isfinite(o).all())
    log(f"K1 B={B} S={S} H={h} KV={kv} {label} causal={causal}: max|o-ref| {err:.3e}  "
        f"max|lse-ref| {lse_err:.3e}  finite {finite}")
    if not (finite and err <= 2e-2 and lse_err <= 1e-3):
        raise AssertionError(f"K1 disagrees with its plain version at B={B} S={S} H={h} KV={kv} {label} "
                             f"causal={causal}")
    return err


def phase_k1(dev, rng):
    import torch

    from ray_tpu_torch.ops import attention as att

    worst = 0.0
    for B, S in K1_CHECK:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal))
    for B, S, h, kv, kind in K23_EXTRA:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal, h, kv, kind))
    torch.cuda.empty_cache()
    # Determinism: no atomics; two launches on the same inputs give the same bits.
    B, S = 2, TRAIN_S
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q = torch.randn(B, S, H, D, device=dev).bfloat16()
    k, v = (torch.randn(B, S, KV, D, device=dev).bfloat16() for _ in range(2))
    runs = [att.flash_fwd(q, k, v, segment_ids=seg, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K1 determinism (B={B} S={S} packed, two launches): o {same[0]}  lse {same[1]} bitwise equal")
    if not all(same):
        raise AssertionError("K1 is not deterministic: two launches on the same inputs differ")
    del q, k, v, runs
    # Timing at the engine's prefill shape: one group of 8 prompts of 512
    # tokens in the 512 bucket (no padding, so one segment per row).
    B, S = 8, PROMPT_LEN
    q = torch.randn(B, S, H, D, device=dev).bfloat16()
    k = torch.randn(B, S, KV, D, device=dev).bfloat16()
    v = torch.randn(B, S, KV, D, device=dev).bfloat16()
    seg_np = np.zeros((B, S), np.int32)
    seg = torch.from_numpy(seg_np).to(dev)
    ms = device_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    eager_ms = time_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    plain_ms = time_ms(lambda: att.mha_reference(q, k, v, causal=True, segment_ids=seg))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S + 4 * B * S
    bound_ms, bound_by = bound(*k1_cost(seg_np, nbytes))
    flops = k1_cost(seg_np, nbytes)[0]
    log(f"K1 at engine shape B={B} S={S}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
        f"sdpa {library_ms:.4f} ms ({ms / library_ms:.2f}x)  bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, qt, kt, vt
    # The training shape: bench.py's batch, one causal sequence per row.
    B, S = TRAIN_B, TRAIN_S
    q = torch.randn(B, S, H, D, device=dev).bfloat16()
    k = torch.randn(B, S, KV, D, device=dev).bfloat16()
    v = torch.randn(B, S, KV, D, device=dev).bfloat16()
    t_ms = device_ms(lambda: att.flash_fwd(q, k, v, causal=True), iters=10)
    t_plain = time_ms(lambda: att.mha_reference(q, k, v, causal=True), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t_lib = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S
    t_flops = 4 * D * H * causal_pairs(np.zeros((B, S), np.int32))
    t_bound, t_by = bound(t_flops, nbytes)
    log(f"K1 at training shape B={B} S={S}: kernel {t_ms:.4f} ms ({t_flops / t_ms / 1e9:.1f} TFLOP/s, "
        f"{t_ms / t_bound:.2f}x bound)  plain {t_plain:.4f} ms  sdpa {t_lib:.4f} ms ({t_ms / t_lib:.2f}x)  "
        f"bound {t_bound:.4f} ms ({t_by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                train_shape=dict(ms=t_ms, plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, bound_by=t_by))


def _paged_case(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV):
    import torch

    B = len(lengths)
    P_total = B * ppseq + 1
    kp = torch.randn(kv, P_total, ps, D, device=dev).bfloat16()
    vp = torch.randn(kv, P_total, ps, D, device=dev).bfloat16()
    q = torch.randn(B, h, D, device=dev).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, torch.from_numpy(table).to(dev)


def _check_k4(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV, case=None):
    """K4 against paged_attention_reference in fp32 on the same bf16 inputs.
    Returns (max |o - o_ref|, o, inputs)."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    case = case or _paged_case(dev, rng, lengths, ps, ppseq, h, kv)
    o = pa.paged_decode(*case)
    torch.cuda.synchronize()
    q, kp, vp, lens, table = case
    o_ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    err = (o.float() - o_ref).abs().max().item()
    zero_rows = all(not o[b].any().item() for b, n in enumerate(lengths) if n == 0)
    log(f"K4 B={len(lengths)} ps={ps} pages/seq={ppseq} H={h} KV={kv} lengths {min(lengths)}..{max(lengths)}: "
        f"max|o-ref| {err:.3e}  length-0 rows zero {zero_rows}")
    if not (err <= 2e-2 and zero_rows and bool(torch.isfinite(o).all())):
        raise AssertionError(f"K4 disagrees with its plain version at B={len(lengths)} ps={ps} H={h} KV={kv}")
    return err, o, case


def _k4_lengths(rng, B, ps, ppseq):
    """B 1: one sequence over most of its table; else 0, 1, two pages
    exactly, the full table and random lengths."""
    if B == 1:
        return [ppseq * ps - 3]
    lengths = rng.integers(1, ppseq * ps + 1, B)
    lengths[:4] = [0, 1, 2 * ps, ppseq * ps]
    return [int(n) for n in lengths]


def phase_k4(dev, rng):
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    max_len = PAGE * K4_PPSEQ
    lengths = rng.integers(1, max_len + 1, K4_B)
    lengths[[0, 1, K4_B - 1]] = [0, 1, max_len]
    err, _, _ = _check_k4(dev, rng, [int(n) for n in lengths])
    for ps in K4_PAGES:
        for group in K4_GROUPS:
            for B in (1, K4_B):
                ppseq = max_len // ps if B == 1 else 8
                e, _, _ = _check_k4(dev, rng, _k4_lengths(rng, B, ps, ppseq), ps, ppseq, KV * group, KV)
                err = max(err, e)
    # Determinism, and counters back at 0: two launches on the same inputs
    # give the same bits, with a call at another batch size between them.
    lengths = _k4_lengths(rng, K4_B, PAGE, K4_PPSEQ)
    _, o1, case = _check_k4(dev, rng, lengths)
    _check_k4(dev, rng, _k4_lengths(rng, 5, PAGE, K4_PPSEQ))
    o2 = pa.paged_decode(*case)
    torch.cuda.synchronize()
    same, reset = torch.equal(o1, o2), not pa._COUNTERS[o1.device].any().item()
    log(f"K4 determinism (B={K4_B}, two launches around a B=5 call): bitwise equal {same}  counters at 0 {reset}")
    if not (same and reset):
        raise AssertionError("K4 is not deterministic or left a ticket counter set")
    # Timing at the engine's decode shape; 8 pool copies rotate so each launch
    # reads its pages from device memory, as the engine's do (12 layers apart).
    lengths = rng.integers(PROMPT_LEN + 1, PROMPT_LEN + MAX_TOKENS + 1, N_REQ)
    cases = [_paged_case(dev, rng, lengths) for _ in range(8)]
    it = iter(range(1 << 30))

    def run(fn):
        return lambda: fn(*cases[next(it) % len(cases)])

    ms = device_ms(run(pa.paged_decode), iters=40)
    eager_ms = time_ms(run(pa.paged_decode), iters=40)
    plain_ms = time_ms(run(pa.paged_attention_reference), iters=40)
    tokens = int(lengths.sum())
    pages = int(sum(math.ceil(n / PAGE) for n in lengths))
    nbytes = 2 * tokens * KV * D * 2 + 2 * N_REQ * H * D * 2 + 4 * N_REQ + 4 * pages
    bound_ms, bound_by = bound(4 * H * D * tokens, nbytes)
    log(f"K4 at engine shape B={N_REQ} lengths {lengths.min()}..{lengths.max()}: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.1f} GB/s, {ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  "
        f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def _bwd_case(dev, B, S, seg=None, causal=True, h=H, kv=KV):
    import torch

    from ray_tpu_torch.ops import attention as att

    q = torch.randn(B, S, h, D, device=dev).bfloat16()
    k = torch.randn(B, S, kv, D, device=dev).bfloat16()
    v = torch.randn(B, S, kv, D, device=dev).bfloat16()
    do = torch.randn(B, S, h, D, device=dev).bfloat16()
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    return q, k, v, o, lse, do


def _check_k23(dev, B, S, seg, causal, worst, h=H, kv=KV, label=""):
    """K3 and K2 (through flash_bwd) against flash_bwd_reference in fp32 on
    the same bf16 inputs."""
    import torch

    from ray_tpu_torch.ops import attention as att

    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg, causal, h, kv)
    got = att.flash_bwd(q, k, v, o, lse, do, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    want = att.flash_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                   segment_ids=seg, causal=causal)
    parts = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        finite = bool(torch.isfinite(g).all())
        parts.append(f"{name} {err:.3e} (max|ref| {top:.2f})")
        if not (finite and err <= 2e-2 * top + 2e-2):
            raise AssertionError(f"K2/K3 {name} disagrees with its plain version at "
                                 f"B={B} S={S} H={h} KV={kv} {label} causal={causal}: {err} (max|ref| {top})")
        worst[name] = max(worst[name], err)
    log(f"K3/K2 B={B} S={S} H={h} KV={kv} {label} causal={causal}: max|g-ref| " + "  ".join(parts))


def phase_k23(dev, rng):
    import torch

    from ray_tpu_torch.ops import attention as att

    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, S in K23_CHECK:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, label="pad")
    for B, S, h, kv, kind in K23_EXTRA:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, h, kv, label=kind)
    torch.cuda.empty_cache()

    # Determinism: no atomics, a fixed summation order; two launches of each
    # kernel on the same inputs give the same bits.
    B, S = 2, TRAIN_S
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, seg), *att.flash_bwd_dkv(q, k, v, do, lse, delta, seg))
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K3/K2 determinism (B={B} S={S} packed, two launches): dq {same[0]}  dk {same[1]}  dv {same[2]} bitwise equal")
    if not all(same):
        raise AssertionError("K3/K2 are not deterministic: two launches on the same inputs differ")
    del q, k, v, o, lse, do, delta, runs
    torch.cuda.empty_cache()

    # Timing at the training shape (causal, one sequence per row, as the
    # train phase runs them).
    B, S = TRAIN_B, TRAIN_S
    q, k, v, o, lse, do = _bwd_case(dev, B, S)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    dq_ms = device_ms(lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), iters=10)
    dkv_ms = device_ms(lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), iters=10)
    plain_ms = time_ms(lambda: att.flash_bwd_reference(q, k, v, o, lse, do), iters=3, warmup=1)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    pairs = B * H * S * (S + 1) // 2
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 2 * 4 * B * H * S  # q k v dO, LSE delta
    dq_bound = bound(6 * D * pairs, io + 2 * q.numel())
    dkv_bound = bound(8 * D * pairs, io + 2 * (k.numel() + v.numel()))
    for name, ms, flops, (b_ms, b_by) in (("K3 (dQ)", dq_ms, 6 * D * pairs, dq_bound),
                                          ("K2 (dK,dV)", dkv_ms, 8 * D * pairs, dkv_bound)):
        log(f"{name} at training shape B={B} S={S}: kernel {ms:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s  "
            f"bound {b_ms:.4f} ms ({b_by})  {ms / b_ms:.2f}x bound")
    log(f"  K3 + K2 {dq_ms + dkv_ms:.4f} ms = {(dq_ms + dkv_ms) / library_ms:.2f}x sdpa backward (dq, dk, dv) "
        f"{library_ms:.4f} ms;  plain backward (dq, dk, dv) {plain_ms:.4f} ms")
    del q, k, v, o, lse, do, delta, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    common = dict(plain_ms=plain_ms, library_ms=library_ms,
                  plain_covers="flash_bwd_reference: dq, dk and dv in one call",
                  library_covers="scaled_dot_product_attention backward: dq, dk and dv in one call; "
                                 "compare with K3 + K2 together")
    return (dict(max_abs_err=worst["dq"], ms=dq_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1], **common),
            dict(max_abs_err=max(worst["dk"], worst["dv"]), ms=dkv_ms, bound_ms=dkv_bound[0],
                 bound_by=dkv_bound[1], **common))


def phase_splash(dev, rng, k1_train, k3, k2):
    """K5, splash onto K1-K3: the kernels on splash's inputs (q folded with
    the softmax scale in fp32, scale 1.0), held against the plain version on
    the same inputs at B 2 x S 2048 with packed segments, then timed at the
    training shape beside the plain forward + backward and SDPA's."""
    import torch

    from ray_tpu_torch.ops import attention as att

    def inputs(B, S):
        """q folded as the splash wrapper folds it, k, v, dO."""
        q = (torch.randn(B, S, H, D, device=dev) * (1.0 / math.sqrt(D))).bfloat16()
        return q, *(torch.randn(B, S, n, D, device=dev).bfloat16() for n in (KV, KV, H))

    B, S = 2, TRAIN_S
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    qs, k, v, do = inputs(B, S)
    o, lse = att.flash_fwd(qs, k, v, segment_ids=seg, causal=True, scale=1.0)
    got = (o, *att.flash_bwd(qs, k, v, o, lse, do, segment_ids=seg, causal=True, scale=1.0))
    torch.cuda.synchronize()
    o_ref = att.mha_reference(qs.float(), k.float(), v.float(), causal=True, scale=1.0, segment_ids=seg)
    want = (o_ref, *att.flash_bwd_reference(qs.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                            segment_ids=seg, causal=True, scale=1.0))
    errs = {}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        errs[name] = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        if not (bool(torch.isfinite(g).all()) and errs[name] <= 2e-2 * top + 2e-2):
            raise AssertionError(f"splash {name} disagrees with its plain version: {errs[name]} (max|ref| {top})")
    log(f"splash (K1, K3, K2 on q * scale, scale 1.0) B={B} S={S} packed: max|g-ref| "
        + "  ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    del k, v, o, lse, do, qs, got, want, o_ref
    torch.cuda.empty_cache()

    B, S = TRAIN_B, TRAIN_S
    qs, k, v, do = inputs(B, S)
    o, lse = att.flash_fwd(qs, k, v, causal=True, scale=1.0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    t_fwd = device_ms(lambda: att.flash_fwd(qs, k, v, causal=True, scale=1.0), iters=10)
    t_dq = device_ms(lambda: att.flash_bwd_dq(qs, k, v, do, lse, delta, scale=1.0), iters=10)
    t_dkv = device_ms(lambda: att.flash_bwd_dkv(qs, k, v, do, lse, delta, scale=1.0), iters=10)
    plain_ms = time_ms(lambda: (att.mha_reference(qs, k, v, causal=True, scale=1.0),
                                att.flash_bwd_reference(qs, k, v, o, lse, do, scale=1.0)), iters=3, warmup=1)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (qs, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        out = sdpa(qt, kt, vt, is_causal=True, scale=1.0, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    library_ms = time_ms(library, iters=10)
    ms = t_fwd + t_dq + t_dkv
    bound_ms = k1_train["bound_ms"] + k3["bound_ms"] + k2["bound_ms"]
    log(f"splash at training shape B={B} S={S}: K1 {t_fwd:.4f} + K3 {t_dq:.4f} + K2 {t_dkv:.4f} = {ms:.4f} ms  "
        f"plain forward + backward {plain_ms:.4f} ms  sdpa forward + backward {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms (operations)")
    del k, v, o, lse, do, qs, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), ms=ms, ms_by_kernel={"K1": t_fwd, "K3": t_dq, "K2": t_dkv},
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by="operations",
                plain_covers="mha_reference + flash_bwd_reference on the folded q",
                library_covers="scaled_dot_product_attention forward + backward (scale 1.0) in one call each")


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
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    with torch.no_grad():
        plain = forward(eng.params, toks, plain_cfg)[:, -1].float()  # [n, V]
        third = (np.zeros((n, PROMPT_LEN // PAGE), np.int32) if eng.paged
                 else np.arange(n, dtype=np.int64))  # dead page / idle slots
        served = eng._prefill_logits(np.stack(prompts), np.full(n, PROMPT_LEN, np.int32), third)
    diff = (served - plain).abs()
    first = torch.tensor([done[f"r{i}"]["tokens"][0] for i in range(n)], device=dev)
    gap = plain.max(dim=-1).values - plain.gather(1, first[:, None])[:, 0]
    top1 = int((first == plain.argmax(dim=-1)).sum())
    log(f"  oracle: forward with attention_impl={plain_cfg.attention_impl!r} (einsum attention, no kernel)")
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


def _loss_grads(params, batch, cfg):
    import torch

    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.transformer import leaves

    ps = leaves(params)
    loss = cross_entropy_loss(params, batch, cfg)
    return loss.item(), [g.float() for g in torch.autograd.grad(loss, ps)]


def _rel_errs(got, want):
    return [((g - w).norm() / w.norm().clamp(min=1e-30)).item() for g, w in zip(got, want)]


def phase_train(dev, card, profile_dir=None):
    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.models.transformer import init_params, leaves
    from ray_tpu_torch.ops import attention

    # (a) gradient parity at full width, depth cut to 2 layers.
    cfg = TransformerConfig(**{**MODEL, "n_layers": PARITY_LAYERS})
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, g, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (PARITY_B, TRAIN_S + 1), generator=g, device=dev)}
    loss_f, g_flash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="flash"))
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    loss_r, g_ref = _loss_grads(params, batch, plain_cfg)
    rel = _rel_errs(g_flash, g_ref)
    log(f"train parity ({PARITY_LAYERS} layers, B {PARITY_B} x S {TRAIN_S}, bf16): oracle attention_impl="
        f"{plain_cfg.attention_impl!r}; loss flash {loss_f:.5f} reference {loss_r:.5f}; "
        f"per-leaf |g-g_ref|/|g_ref| max {max(rel):.3e} mean {statistics.mean(rel):.3e}")
    if not (math.isfinite(loss_f) and abs(loss_f - loss_r) <= 1e-2 and max(rel) <= 5e-2):
        raise AssertionError(f"flash training gradients disagree with the plain path: {rel}")

    # (b) remat off / full / dots through the kernels.
    flash_cfg = dataclasses.replace(cfg, attention_impl="flash")
    remat = {}
    for policy in ("full", "dots"):
        _, g_r = _loss_grads(params, batch, dataclasses.replace(flash_cfg, remat=True, remat_policy=policy))
        remat[policy] = max(_rel_errs(g_r, g_flash))
    log(f"train remat parity (through K1-K3): max per-leaf relative difference vs remat off: "
        f"full {remat['full']:.3e}  dots {remat['dots']:.3e}")
    if max(remat.values()) > 5e-3:
        raise AssertionError(f"remat changes the gradients: {remat}")

    # (c) splash (K5) onto K1-K3: the same model and batch with
    # attention_impl="splash" against "flash".
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    loss_s, g_splash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="splash"))
    torch.cuda.synchronize()
    splash_launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                       "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    rel_s = _rel_errs(g_splash, g_flash)
    log(f"train splash parity ({PARITY_LAYERS} layers): loss splash {loss_s:.5f} flash {loss_f:.5f}; per-leaf "
        f"|g-g_flash|/|g_flash| max {max(rel_s):.3e}; launches in one loss + gradient: K1 "
        f"{splash_launches['flash_fwd']}  K3 {splash_launches['flash_bwd_dq']}  K2 {splash_launches['flash_bwd_dkv']}")
    if not (math.isfinite(loss_s) and abs(loss_s - loss_f) <= 5e-2 and max(rel_s) <= 5e-2):
        raise AssertionError(f"splash training gradients disagree with flash: loss {loss_s} vs {loss_f}, {rel_s}")
    if min(splash_launches.values()) == 0:
        raise AssertionError(f"splash did not run through K1-K3: {splash_launches}")
    del params, g_flash, g_ref, g_splash, batch
    torch.cuda.empty_cache()

    # (d) the bench.py:57-77 configuration, full width and depth.
    cfg = TransformerConfig(**MODEL, remat=True, remat_policy="dots")
    init_state, train_step = make_train_step(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, device=dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=g, device=dev)}
    t0 = time.perf_counter()
    first = train_step(state, batch)
    torch.cuda.synchronize()
    log(f"train: {n_params / 1e6:.1f}M params, remat {cfg.remat_policy!r}, B {TRAIN_B} x S {TRAIN_S}, "
        f"warmup step {time.perf_counter() - t0:.2f} s, loss {first['loss'].item():.4f}")
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [train_step(state, batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    tokens = TRAIN_B * TRAIN_S
    flops = 6.0 * n_params * tokens + 12.0 * cfg.n_layers * cfg.d_model * TRAIN_S * tokens
    stats = dict(step_ms=dt * 1e3, tokens_per_s=tokens / dt, mfu=flops / dt / PEAK_BF16_FLOPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, loss_first=losses[0],
                 loss_last=losses[-1], card=card)
    log(f"train: {TRAIN_STEPS} steps, step {stats['step_ms']:.2f} ms, {stats['tokens_per_s']:.1f} tokens/s, "
        f"MFU {stats['mfu']:.4f} (6NT + 12LdST against 989 TFLOP/s), peak mem {stats['peak_mem_gb']:.2f} GB  "
        f"[{card}]")
    log(f"  loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad_norm {' '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"  launches in {TRAIN_STEPS} steps: K1 {launches['flash_fwd']}  K3 {launches['flash_bwd_dq']}  "
        f"K2 {launches['flash_bwd_dkv']}")
    if not all(math.isfinite(x) for x in losses + gnorms) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss is not finite and falling: {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS, "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"kernel launches in {TRAIN_STEPS} training steps {launches} != {want}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        _profile_window("train_step", lambda: train_step(state, batch), profile_dir)
    del state, batch
    torch.cuda.empty_cache()
    return stats, launches, splash_launches


# Device time by kind in a profile: (kind, substrings of the device
# kernel's name); the first match wins, the rest is "other".
KERNEL_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K2 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K4 paged_decode", ("paged_decode_kernel",)),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel", "CatArrayBatchedCopy")),
)


def _by_kind(device_events):
    """[(kind, device us, kernels)] over the profile's device events, largest first."""
    acc = {}
    for e in device_events:
        kind = next((k for k, subs in KERNEL_KINDS if any(s in e.name for s in subs)), "other")
        us, n = acc.get(kind, (0.0, 0))
        acc[kind] = (us + e.time_range.elapsed_us(), n + 1)
    return sorted(((k, us, n) for k, (us, n) in acc.items()), key=lambda r: -r[1])


def _profile_window(name, fn, out_dir):
    """torch.profiler over fn(); writes the kernel table and the trace to
    out_dir and prints the wall time, device kernel time, device time by
    kind and top rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels, copies and memsets; a user annotation's device span (the
    # optimizer's step) covers kernels already counted.
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.time_range.elapsed_us() for e in device_events)
    ka = prof.key_averages()
    key = "self_device_time_total" if ka and hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(ka.table(sort_by=key, row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}.json"))
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, device kernel time {dev_us / 1e3:.2f} ms "
        f"(busy share {dev_us / 1e6 / wall:.3f}), {len(device_events)} device events")
    for kind, us, n in _by_kind(device_events):
        log(f"  {kind}: {us / 1e3:.2f} ms ({100 * us / max(dev_us, 1e-9):.1f} %, {n} events)")
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
    ap.add_argument("--profile", metavar="DIR", help="also trace the paged engine's steps and a training step into DIR")
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
    card = phase_device()
    phase_build()
    k1 = phase_k1(dev, rng)
    k4 = phase_k4(dev, rng)
    k3, k2 = phase_k23(dev, rng)
    splash = phase_splash(dev, rng, k1["train_shape"], k3, k2)
    stats, launches = phase_engine(dev, rng, args.profile)
    train, t_launches, s_launches = phase_train(dev, card, args.profile)
    bwd_src = "ray_tpu_torch/ops/csrc/flash_bwd.cu"
    kernels = [
        dict(name="flash_fwd", route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="ray_tpu/ops/attention.py:92",
             launches=launches["flash_fwd"] + t_launches["flash_fwd"],
             launches_by_path={"serve": launches["flash_fwd"], "train": t_launches["flash_fwd"]}, **k1),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_src, replaces="ray_tpu/ops/attention.py:277",
             launches=t_launches["flash_bwd_dq"], **k3),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_src, replaces="ray_tpu/ops/attention.py:210",
             launches=t_launches["flash_bwd_dkv"], **k2),
        dict(name="paged_decode", route="cuda", source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:67", launches=launches["paged_decode"], **k4),
        dict(name="splash", route="onto K1-K3", source="ray_tpu_torch/ops/splash.py",
             replaces="ray_tpu/ops/splash.py:33", launches=sum(s_launches.values()),
             launches_by_kernel=s_launches, **splash),
    ]
    log(json.dumps({"engine": stats}))
    log(json.dumps({"train": train}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
