#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build: compiles the CUDA kernels from ray_tpu_torch/ops/csrc (one nvcc
     per source, in parallel) into ray_tpu_torch/ops/_build_out, every
     template instance (K1, K3 and K2 at head dims 64, 128 and 256; K4 per
     group) in the same build, and prints each instance's ptxas registers
     and spill bytes (a source already built by an earlier run of the same
     checkout is not compiled again and has no report).
  3. K1 (flash forward) against its plain version, mha_reference in fp32
     on the same bf16 inputs, at B in {1, 8}, S in {512, 1000, 2048}, H 16,
     KV 4, D 64, causal and not, with a pad segment, plus MQA (H 8, KV 1),
     three packed segments per row, S 64 and S 33: max |o - o_ref| <= 2e-2
     (bf16 output, ulp 2^-8 relative) and max |lse - lse_ref| <= 1e-3; two
     launches on the same inputs must be bitwise equal. Timed at the
     engine's prefill shape (one group of 8 prompts of 512 tokens) and at
     the training shape (B 16, S 2048, causal), with TFLOP/s and the time
     over its bound, and held against its plain version at both, on the
     timed inputs, with the same bounds. Every kernel's `ms` (and SDPA's forward) is its device
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
  6b. the prefix cache and chunked prefill on phase 6's model (full width
     and depth, page 128, 32 slots, prefix_cache on, chunked_prefill 512,
     warmup first). (a) A shared system prompt: one seed request of a
     1024-token system prompt plus a 96-token tail (a chunked miss: chunks
     of 512, 512 and 96 over three steps), then 32 requests of the same
     system prompt plus their own 64-192-token tails at once (partial hits:
     each prefills only its tail over the cached pages), then 8 of those 32
     prompts again (exact hits: no prefill). (b) 8 requests of 512 tokens
     start decoding, then 2 prompts of 1536 tokens arrive (three chunks
     each). Gates: every request finishes with its 64 tokens inside the
     vocabulary; prefix_cache_stats after (a) are 1 miss, 32 partial hits, 8
     hits; pages are conserved (free + cached + held = the pool); in (b) the
     short requests emit tokens in at least 2 steps that begin with a long
     prompt mid-prefill; K1 is launched 0 times in (a) and exactly 12 times
     per prefill group in (b), K4 in both. The tail prefill's logits (each
     partial hit, each chunked prompt's last chunk, over the cached pages)
     against the plain forward over the whole prompt: max |diff| <= 0.25,
     mean <= 0.02; every first token, exact hits included, within 0.25 of
     the plain top-1 logit (token equality with a cold run is not a gate:
     cold prefill runs K1 in bf16, the tail plain einsum, so near-ties may
     differ); one page copy bitwise equal in every layer. TTFT of the seed,
     the partial and the exact hits and decode tokens/s during the steps
     that begin mid-prefill are printed, not gated.
  3-5 at D 128 and D 256: phases 3, 4 and 5 again at head dim 128 and
     Mistral-7B's heads (H 32, KV 8), then at head dim 256 and Gemma-2B's
     (H 8, KV 1), after every D-64 phase (3, 4, 5, 5b) has run on the
     random streams of earlier versions of this script. K1: B in {1, 8} at
     D 128, {1, 4} at D 256, S in {512, 1000, 4096}, causal and not, with a
     pad segment, plus MQA or GQA (H 8, KV 1 or 2), packed segments (B 2 x
     S 4096), S 64 and S 33; K3/K2 the same set at B in {1, 2} (D 128) or
     {1, 4} (D 256); the plain versions run one batch row at a time (a
     row's fp32 scores are 2.1 GB at 32 heads). The same tolerances and
     two-launch checks. K1 timed at the large engine's prefill shape (one
     group of 8 prompts: 8 x 1024 at D 128, 8 x 2048 at D 256) and the
     training shape (B 8 x S 4096), K3/K2 at the training shape, each beside
     SDPA's forward or backward; the timed inputs of K1 (at both shapes)
     and of K3/K2 are also held against the plain versions, so the timed
     shapes themselves are checked (at D 64 too). K4: the large engine's decode shape (32 sequences of
     1025..1152 tokens at group 4, or of 2049..2176 at group 8, page 128, a
     table of max_seq / 128 pages), one sequence split over most of its
     table, the two-launch check, then timed at the decode shape.
  6c. serve-mistral7b-paged: Mistral-7B-v0.3's shape (vocab 32768, d_model
     4096, 32 layers, 32 heads, 8 KV heads, head_dim 128, d_ff 14336,
     max_seq 4096, rope_theta 1e6; 7.25B parameters, 14.5 GB in bf16) with
     seeded random weights through the paged engine (page 128, 32 slots:
     1025 pages, 17.2 GB of KV); warmup, then 32 greedy requests of 1024
     prompt tokens and 128 new tokens at once. Gates: every request
     finishes with its 128 tokens inside the vocabulary; K1 launches =
     32 x the prefill groups and K4 = 32 x the decode steps, both counted
     from the engine's calls and both > 0; the prefill logits of all 32
     prompts against the plain forward (4 prompts at a time, its last
     position only) within phase 6's 0.25 / 0.02, every first token within
     0.25 of the plain top-1.
  6d. serve-gemma2b-paged: Gemma-2B's shape (vocab 256000, d_model 2048, 18
     layers, 8 heads, 1 KV head, head_dim 256, d_ff 16384, max_seq 8192;
     3.03B parameters, 6.1 GB in bf16), not cut, through the same engine
     (page 128, 32 slots: 2049 pages, 4.8 GB of KV): 32 greedy requests of
     2048 prompt tokens and 128 new tokens at once. The gates of 6c, K1 and
     K4 at D 256.
  6e. serve-openai-250M: phase 6's model (full width and depth, seeded bf16
     weights, paged KV, page 128, 32 slots) served as text through
     OpenAIServer over LLMServer, whose stepping thread launches K1 and K4;
     warmup at every prefill bucket. A byte-level BPE tokenizer trained on
     seeded text (200 merges), saved and read back with load_tokenizer; the
     ChatML jinja template (the legacy format where jinja2 is missing). 32
     client threads released together, each one request of 480-512 encoded
     prompt tokens x 64 new tokens (ignore_eos): 8 streamed /v1/completions
     greedy, 8 streamed sampled (temperature 0.8, top_p 0.95, top_k 40), 8
     /v1/chat/completions greedy, 8 token-id dicts through LLMServer's
     __call__; every request carries a 60 s deadline. Then a token-level
     stream closed after 2 frames, a chat stream read to its end and a chat
     request with a 50 ms deadline. Gates: each of the 32 ends with 64
     tokens inside the vocabulary and finish_reason "length" (usage for
     chat, the last chunk for streams); every SSE frame parses and every
     stream ends with [DONE]; the chat stream's first chunk carries the
     assistant role; the deadline raises DeadlineExceeded; within 2 s of the
     early close and of the deadline the engine holds no request and every
     page is back; the stepping thread stays alive; serve.ttft_s observes
     each of the 32 once; K1 = 12 x the prefill groups and K4 = 12 x the
     decode steps (both > 0); the token-level requests' first tokens and
     prefill logits against the plain forward (phase 6's tolerances).
     Printed: client TTFT (call to first SSE frame, streams), the engine's
     TTFT, decode and overall tokens/s, beside phase 6's engine-only
     numbers and their ratio (the serving surface's overhead).
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
  7e. train-mistral7b-4L: at Mistral-7B's widths, first the gradient check
     of 7(a) (2 layers, B 1 x S 2048, K1-K3 at D 128 against the plain
     path, per leaf relative L2 <= 5e-2, one launch of each per layer), then
     make_train_step at the same widths cut to 4 layers (1.141B parameters;
     the whole model's AdamW state alone is 116 GB), remat "dots", AdamW,
     B 8 x S 4096 on one seeded batch: a warmup step, then 10 timed steps.
     The loss must be finite and fall; each step launches K1 8 times, K3 4
     and K2 4. Prints step time, tokens/s, MFU and peak memory.
  7f. train-gemma2b-4L: 7e at Gemma-2B's widths (K1-K3 at D 256), cut to 4
     of 18 layers (1.489B parameters; the whole model's AdamW state is
     ~48 GB), with the loss over sequence chunks of 1024 (ce_chunk: the
     [8, 4096, 256000] logits never exist; a fallback to them is an error).
  8. JSON lines {"engine": ...}, {"engine_prefix": ...},
     {"engine_mistral7b": ...}, {"engine_gemma2b": ...}, {"engine_openai": ...},
     {"train": ...},
     {"train_mistral7b": ...}, {"train_gemma2b": ...}, {"kernels": [...]}
     (each kernel's D-64 numbers, its "d128" and "d256" numbers with their
     launches by path and ptxas report, its launches by path, ptxas's
     registers and spills per instance, null where this run did not
     compile it) and, last, {"ok": true, "device": ...}.

``--profile DIR`` also traces the paged engine with torch.profiler (the
admission step with its prefills, then two decode steps), the admission
step of 32 more partial hits in phase 6b (with the device time under the
tail attention's einsums and softmax, the GEMMs and the page copies), the
7B engine's admission step and two decode steps (6c), and one training
step of each training cell, prints each window's device time by kind of
kernel, and writes the kernel tables and traces to DIR (the 2B engine's
and training step too).
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
# Mistral-7B-v0.3's published shape (huggingface.co/mistralai/Mistral-7B-v0.3,
# config.json: hidden_size 4096, 32 layers, 32 heads, 8 KV heads, head_dim
# 128, intermediate_size 14336, vocab 32768, rope_theta 1e6, no sliding
# window, untied embeddings). One departure: RMSNorm eps is 1e-6 here, as in
# both packages' rms_norm, where Mistral publishes 1e-5.
H7, KV7, D7 = 32, 8, 128
MISTRAL = dict(vocab_size=32_768, d_model=4096, n_layers=32, n_heads=H7, n_kv_heads=KV7, d_ff=14_336,
               max_seq_len=4096, rope_theta=1e6)
# Gemma-2B's published shape (huggingface.co/google/gemma-2b, config.json:
# hidden_size 2048, 18 layers, 8 heads, 1 KV head, head_dim 256,
# intermediate_size 16384, vocab 256000, max_position_embeddings 8192,
# rope_theta 10000, rms_norm_eps 1e-6). Departures, both packages' model
# code: SwiGLU where Gemma gates with GELU, an untied head, no sqrt(hidden)
# scaling of the embeddings and RMSNorm weights w where Gemma has 1 + w.
H2, KV2, D2 = 8, 1, 256
GEMMA = dict(vocab_size=256_000, d_model=2048, n_layers=18, n_heads=H2, n_kv_heads=KV2, d_ff=16_384,
             max_seq_len=8192, rope_theta=10_000.0)
# The large-model cells: 6c/7e at Mistral-7B's shape (D 128), 6d/7f at
# Gemma-2B's (D 256). serve: requests x prompt tokens x new tokens at once,
# engine slots, prompts per plain forward in the logits gate; train: the
# widths cut to `layers` layers at B x S (ce_chunk: the loss over sequence
# chunks of that size, 0 = whole logits); parity: the 2-layer gradient
# check before it.
BIG = {
    "mistral7b": dict(model=MISTRAL, serve=dict(req=32, prompt=1024, tokens=128, slots=32, check_chunk=4),
                      train=dict(layers=4, b=8, s=4096, ce_chunk=0), parity=dict(layers=2, b=1, s=2048, seed=2)),
    "gemma2b": dict(model=GEMMA, serve=dict(req=32, prompt=2048, tokens=128, slots=32, check_chunk=4),
                    train=dict(layers=4, b=8, s=4096, ce_chunk=1024), parity=dict(layers=2, b=1, s=2048, seed=3)),
}
M_PROMPT, M_TOKENS = BIG["mistral7b"]["serve"]["prompt"], BIG["mistral7b"]["serve"]["tokens"]
G_PROMPT, G_TOKENS = BIG["gemma2b"]["serve"]["prompt"], BIG["gemma2b"]["serve"]["tokens"]
N_REQ, PROMPT_LEN, MAX_TOKENS, SLOTS, PAGE = 32, 512, 64, 32, 128
K1_CHECK = ((1, 512), (1, 1000), (1, 2048), (8, 512), (8, 1000), (8, 2048))  # (B, S)
K4_B, K4_PPSEQ = 32, 16  # sequences; pages per sequence (max length 2048)
K4_PAGES, K4_GROUPS = (16, 64, 128), (1, 2, 4, 8)  # K4's sweep: page sizes, q heads per kv head
K23_CHECK = ((1, 512), (1, 1000), (1, 2048), (4, 512), (4, 1000), (4, 2048))  # (B, S)
# (B, S, H, KV, segments): MQA, three packed segments per row, one tile, under one tile.
K23_EXTRA = ((2, 1000, 8, 1, "pad"), (2, 2048, H, KV, "packed"), (2, 64, H, KV, "pad"), (3, 33, 8, 2, "pad"))
# Phase 6b: a shared system prompt (a seed request with a 96-token tail, then
# partial hits with tails of 64-192 tokens, then exact hits), chunks of 512;
# then short prompts decoding while long prompts prefill chunk by chunk.
SYS_LEN, SEED_TAIL, HIT_TAIL, N_HIT, N_EXACT, CHUNK = 1024, 96, (64, 192), 32, 8, 512
N_SHORT, N_LONG, LONG_LEN = 8, 2, 1536
# Phase 6e: the serving surface (OpenAIServer over LLMServer) on phase 6's
# model. A tokenizer trained on seeded text (a word list, then sentences of
# its words; few merges, so it trains in seconds); OAI_PER_KIND requests of
# each kind released together, prompts of OAI_PROMPT encoded tokens,
# MAX_TOKENS new tokens, every wait bounded by OAI_TIMEOUT_S; then a
# token-level stream closed after 2 frames, a chat stream read to its end
# and a chat request with a 50 ms deadline.
OAI_KINDS = ("completions_stream_greedy", "completions_stream_sampled", "chat_greedy", "tokens_greedy")
OAI_PER_KIND, OAI_PROMPT, OAI_TIMEOUT_S, OAI_DEADLINE_S = 8, (480, 512), 60.0, 0.05
OAI_SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=40)
OAI_WORDS, OAI_SENTENCES, OAI_MERGES = 400, 300, 200
# The ChatML template (the format Qwen-family checkpoints are tuned on).
CHATML = ("{% for message in messages %}<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
          "{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
# Ops whose device time the profile of 6b's admission step reports (the
# tail attention's einsums, softmax and mask; the projections' GEMMs; the
# page copies, pool writes and context gathers).
PREFIX_OPS = ("aten::einsum", "aten::_softmax", "aten::masked_fill", "aten::mm", "aten::index_select",
              "aten::index_copy_", "aten::cat")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 2048, 10  # bench.py's batch and sequence
PARITY_LAYERS, PARITY_B = 2, 2
# The kernel phases' shapes for each head dim: D 64 at the 250M model's
# heads, D 128 at Mistral-7B's (H 32, KV 8), D 256 at Gemma-2B's (H 8, KV
# 1) with GQA cases (H 8, KV 2). k1/k23: (B, S) swept with a
# pad segment, causal and not; extra: (B, S, H, KV, segments); det: the
# two-launch check's (B, S); prefill/train: the timed shapes (one group of 8
# prompts of the serving cell's prompt length; the training cell's batch).
# rows: the plain versions run one batch row at a time (a row's fp32 scores
# at 32 heads x 4096^2 are 2.1 GB).
SHAPES = {
    64: dict(h=H, kv=KV, d=D, k1=K1_CHECK, k23=K23_CHECK, extra=K23_EXTRA, det=(2, TRAIN_S),
             prefill=(8, PROMPT_LEN), train=(TRAIN_B, TRAIN_S), rows=False),
    128: dict(h=H7, kv=KV7, d=D7, k1=((1, 512), (1, 1000), (1, 4096), (8, 512), (8, 1000), (8, 4096)),
              k23=((1, 512), (1, 1000), (1, 4096), (2, 512), (2, 1000), (2, 4096)),
              extra=((2, 1000, 8, 1, "pad"), (2, 4096, H7, KV7, "packed"), (2, 64, H7, KV7, "pad"),
                     (3, 33, 8, 2, "pad")),
              det=(2, 4096), prefill=(8, M_PROMPT), train=(8, 4096), rows=True),
    256: dict(h=H2, kv=KV2, d=D2, k1=((1, 512), (1, 1000), (1, 4096), (4, 512), (4, 1000), (4, 4096)),
              k23=((1, 512), (1, 1000), (1, 4096), (4, 512), (4, 1000), (4, 4096)),
              extra=((2, 1000, 8, 2, "pad"), (2, 4096, H2, KV2, "packed"), (2, 4096, 8, 2, "packed"),
                     (2, 64, H2, KV2, "pad"), (3, 33, 8, 2, "pad")),
              det=(2, 4096), prefill=(8, G_PROMPT), train=(8, 4096), rows=True),
}
# K4's decode shapes at D 128 and 256: the 7B and 2B engines' (32
# sequences, page 128, tables of max_seq / 128 pages).
K4_BIG = {128: dict(h=H7, kv=KV7, lengths=(M_PROMPT + 1, M_PROMPT + M_TOKENS), ppseq=4096 // 128),
          256: dict(h=H2, kv=KV2, lengths=(G_PROMPT + 1, G_PROMPT + G_TOKENS), ppseq=8192 // 128)}


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
    """Builds every kernel; prints ptxas's registers and spills for each
    instance this run compiled and returns them: {kernel: {head dim or "-":
    {registers, spill_stores, spill_loads}}}. A source whose library was
    already built is not compiled and has no report (its kernels' "ptxas"
    is null in the kernels line)."""
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    compiled = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    report, cur = {}, None
    for name in _build.SOURCES:
        if name not in compiled:
            log(f"  {name}: already built, not compiled in this run: no ptxas report")
            continue
        for line in _build.log_path(name).read_text().splitlines():
            kernel = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", line) if "entry function" in line else None
            if kernel:
                cur = report.setdefault(kernel.group(1), {}).setdefault(kernel.group(2) or "-", {})
                log(f"  {name}: {kernel.group(1)}" + (f"<{kernel.group(2)}>" if kernel.group(2) else ""))
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
                if cur is not None:
                    for key, pat in (("registers", r"Used (\d+) registers"),
                                     ("spill_stores", r"(\d+) bytes spill stores"),
                                     ("spill_loads", r"(\d+) bytes spill loads")):
                        m = re.search(pat, line)
                        if m:
                            cur[key] = int(m.group(1))
    return report


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


def k1_cost(seg, nbytes_io, h=H, d=D):
    """FLOPs this input needs (valid causal same-segment pairs only) and bytes."""
    return 4 * d * h * causal_pairs(seg), nbytes_io


def _mha_rows(q, k, v, causal=True, seg=None, scale=None):
    """mha_reference one batch row at a time, in the inputs' dtype: (o,
    lse [B * H, S])."""
    import torch

    from ray_tpu_torch.ops import attention as att

    outs, lses = [], []
    for b in range(q.shape[0]):
        o, lse = att.mha_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal, scale=scale,
                                   segment_ids=None if seg is None else seg[b:b + 1], return_lse=True)
        outs.append(o)
        lses.append(lse.reshape(-1, q.shape[1]))
    return torch.cat(outs), torch.cat(lses)


def _bwd_rows(q, k, v, o, lse, do, seg=None, causal=True, scale=None):
    """flash_bwd_reference one batch row at a time: (dq, dk, dv)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h = q.shape[2]
    parts = [att.flash_bwd_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1], o[b:b + 1], lse[b * h:(b + 1) * h],
                                     do[b:b + 1], segment_ids=None if seg is None else seg[b:b + 1],
                                     causal=causal, scale=scale)
             for b in range(q.shape[0])]
    return tuple(torch.cat(t) for t in zip(*parts))


def _hold_k1(q, k, v, seg, causal, desc):
    """K1 on these bf16 inputs against mha_reference in fp32 on the same
    inputs: max |o - o_ref| <= 2e-2 and max |lse - lse_ref| <= 1e-3, or it
    raises; returns max |o - o_ref|."""
    import torch

    from ray_tpu_torch.ops import attention as att

    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = _mha_rows(q.float(), k.float(), v.float(), causal, seg)
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o).all())
    log(f"K1 {desc}: max|o-ref| {err:.3e}  max|lse-ref| {lse_err:.3e}  finite {finite}")
    if not (finite and err <= 2e-2 and lse_err <= 1e-3):
        raise AssertionError(f"K1 disagrees with its plain version at {desc}")
    return err


def _check_k1(dev, B, S, seg, causal, h=H, kv=KV, label="pad", d=D):
    """K1 against its plain version on random bf16 inputs of this shape."""
    import torch

    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    return _hold_k1(q, k, v, seg, causal, f"D={d} B={B} S={S} H={h} KV={kv} {label} causal={causal}")


def phase_k1(dev, rng, shp):
    """Phase 3 at one head dim (an entry of SHAPES)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h, kv, d = shp["h"], shp["kv"], shp["d"]

    def plain(q, k, v, seg=None):
        if shp["rows"]:
            return _mha_rows(q, k, v, True, seg)
        return att.mha_reference(q, k, v, causal=True, segment_ids=seg)

    worst = 0.0
    for B, S in shp["k1"]:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal, h, kv, d=d))
    for B, S, hh, kk, kind in shp["extra"]:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal, hh, kk, kind, d=d))
    torch.cuda.empty_cache()
    # Determinism: no atomics; two launches on the same inputs give the same bits.
    B, S = shp["det"]
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k, v = (torch.randn(B, S, kv, d, device=dev).bfloat16() for _ in range(2))
    runs = [att.flash_fwd(q, k, v, segment_ids=seg, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K1 D={d} determinism (B={B} S={S} packed, two launches): o {same[0]}  lse {same[1]} bitwise equal")
    if not all(same):
        raise AssertionError(f"K1 at D={d} is not deterministic: two launches on the same inputs differ")
    del q, k, v, runs
    # Timing at the engine's prefill shape: one group of 8 prompts in their
    # bucket (no padding, so one segment per row).
    B, S = shp["prefill"]
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    seg_np = np.zeros((B, S), np.int32)
    seg = torch.from_numpy(seg_np).to(dev)
    worst = max(worst, _hold_k1(q, k, v, seg, True, f"D={d} B={B} S={S} H={h} KV={kv} engine shape causal=True"))
    ms = device_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    eager_ms = time_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    plain_ms = time_ms(lambda: plain(q, k, v, seg))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * h * S + 4 * B * S
    bound_ms, bound_by = bound(*k1_cost(seg_np, nbytes, h, d))
    flops = k1_cost(seg_np, nbytes, h, d)[0]
    log(f"K1 D={d} at engine shape B={B} S={S}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
        f"sdpa {library_ms:.4f} ms ({ms / library_ms:.2f}x)  bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, qt, kt, vt, mask
    # The training shape: one causal sequence per row.
    B, S = shp["train"]
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    worst = max(worst, _hold_k1(q, k, v, None, True, f"D={d} B={B} S={S} H={h} KV={kv} training shape causal=True"))
    t_ms = device_ms(lambda: att.flash_fwd(q, k, v, causal=True), iters=10)
    t_plain = time_ms(lambda: plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t_lib = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * h * S
    t_flops = 4 * d * h * causal_pairs(np.zeros((B, S), np.int32))
    t_bound, t_by = bound(t_flops, nbytes)
    log(f"K1 D={d} at training shape B={B} S={S}: kernel {t_ms:.4f} ms ({t_flops / t_ms / 1e9:.1f} TFLOP/s, "
        f"{t_ms / t_bound:.2f}x bound)  plain {t_plain:.4f} ms  sdpa {t_lib:.4f} ms ({t_ms / t_lib:.2f}x)  "
        f"bound {t_bound:.4f} ms ({t_by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                train_shape=dict(ms=t_ms, plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, bound_by=t_by))


def _paged_case(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV, d=D):
    import torch

    B = len(lengths)
    P_total = B * ppseq + 1
    kp = torch.randn(kv, P_total, ps, d, device=dev).bfloat16()
    vp = torch.randn(kv, P_total, ps, d, device=dev).bfloat16()
    q = torch.randn(B, h, d, device=dev).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, torch.from_numpy(table).to(dev)


def _check_k4(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV, case=None, d=D):
    """K4 against paged_attention_reference in fp32 on the same bf16 inputs.
    Returns (max |o - o_ref|, o, inputs)."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    case = case or _paged_case(dev, rng, lengths, ps, ppseq, h, kv, d)
    o = pa.paged_decode(*case)
    torch.cuda.synchronize()
    q, kp, vp, lens, table = case
    o_ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    err = (o.float() - o_ref).abs().max().item()
    zero_rows = all(not o[b].any().item() for b, n in enumerate(lengths) if n == 0)
    log(f"K4 D={d} B={len(lengths)} ps={ps} pages/seq={ppseq} H={h} KV={kv} lengths {min(lengths)}..{max(lengths)}: "
        f"max|o-ref| {err:.3e}  length-0 rows zero {zero_rows}")
    if not (err <= 2e-2 and zero_rows and bool(torch.isfinite(o).all())):
        raise AssertionError(f"K4 disagrees with its plain version at D={d} B={len(lengths)} ps={ps} H={h} KV={kv}")
    return err, o, case


def _k4_lengths(rng, B, ps, ppseq):
    """B 1: one sequence over most of its table; else 0, 1, two pages
    exactly, the full table and random lengths."""
    if B == 1:
        return [ppseq * ps - 3]
    lengths = rng.integers(1, ppseq * ps + 1, B)
    lengths[:4] = [0, 1, 2 * ps, ppseq * ps]
    return [int(n) for n in lengths]


def _time_k4(dev, rng, lengths, ppseq, h, kv, d):
    """K4 timed at a decode shape; 8 pool copies rotate so each launch reads
    its pages from device memory, as the engine's do (a layer apart)."""
    from ray_tpu_torch.ops import paged_attention as pa

    cases = [_paged_case(dev, rng, lengths, PAGE, ppseq, h, kv, d) for _ in range(8)]
    it = iter(range(1 << 30))

    def run(fn):
        return lambda: fn(*cases[next(it) % len(cases)])

    ms = device_ms(run(pa.paged_decode), iters=40)
    eager_ms = time_ms(run(pa.paged_decode), iters=40)
    plain_ms = time_ms(run(pa.paged_attention_reference), iters=40)
    B, tokens = len(lengths), int(sum(lengths))
    pages = int(sum(math.ceil(n / PAGE) for n in lengths))
    nbytes = 2 * tokens * kv * d * 2 + 2 * B * h * d * 2 + 4 * B + 4 * pages
    bound_ms, bound_by = bound(4 * h * d * tokens, nbytes)
    log(f"K4 D={d} at engine shape B={B} lengths {min(lengths)}..{max(lengths)}: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.1f} GB/s, {ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  "
        f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def _k4_determinism(dev, rng, lengths, ppseq, h, kv, d):
    """Two launches on the same inputs give the same bits, with a call at
    another batch size between them, and the ticket counters are back at 0."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    _, o1, case = _check_k4(dev, rng, lengths, PAGE, ppseq, h, kv, d=d)
    _check_k4(dev, rng, _k4_lengths(rng, 5, PAGE, ppseq), PAGE, ppseq, h, kv, d=d)
    o2 = pa.paged_decode(*case)
    torch.cuda.synchronize()
    same, reset = torch.equal(o1, o2), not pa._COUNTERS[o1.device].any().item()
    log(f"K4 D={d} determinism (B={len(lengths)}, two launches around a B=5 call): bitwise equal {same}  "
        f"counters at 0 {reset}")
    if not (same and reset):
        raise AssertionError(f"K4 at D={d} is not deterministic or left a ticket counter set")


def phase_k4(dev, rng):
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
    _k4_determinism(dev, rng, _k4_lengths(rng, K4_B, PAGE, K4_PPSEQ), K4_PPSEQ, H, KV, D)
    lengths = rng.integers(PROMPT_LEN + 1, PROMPT_LEN + MAX_TOKENS + 1, N_REQ)
    return dict(max_abs_err=err, **_time_k4(dev, rng, [int(n) for n in lengths], K4_PPSEQ, H, KV, D))


def phase_k4_big(dev, rng, d):
    """K4 at a large model's decode shape (K4_BIG[d]: D 128 at Mistral-7B's
    heads, group 4, 32 sequences of 1025..1152 tokens; D 256 at Gemma-2B's,
    group 8, 32 sequences of 2049..2176), page 128, and one sequence split
    over most of its table, the two-launch check, then the time at the
    decode shape."""
    import torch

    shp = K4_BIG[d]
    h, kv, ppseq = shp["h"], shp["kv"], shp["ppseq"]
    lo, hi = shp["lengths"]
    lengths = [int(n) for n in rng.integers(lo, hi + 1, 32)]
    err = max(_check_k4(dev, rng, lengths, PAGE, ppseq, h, kv, d=d)[0],
              _check_k4(dev, rng, _k4_lengths(rng, 1, PAGE, ppseq), PAGE, ppseq, h, kv, d=d)[0])
    _k4_determinism(dev, rng, lengths, ppseq, h, kv, d)
    out = dict(max_abs_err=err, **_time_k4(dev, rng, lengths, ppseq, h, kv, d))
    torch.cuda.empty_cache()
    return out


def _bwd_case(dev, B, S, seg=None, causal=True, h=H, kv=KV, d=D):
    import torch

    from ray_tpu_torch.ops import attention as att

    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    do = torch.randn(B, S, h, d, device=dev).bfloat16()
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    return q, k, v, o, lse, do


def _check_k23(dev, B, S, seg, causal, worst, h=H, kv=KV, label="", d=D):
    """K3 and K2 (through flash_bwd) against flash_bwd_reference in fp32 on
    the same bf16 inputs."""
    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg, causal, h, kv, d)
    _hold_k23(q, k, v, o, lse, do, seg, causal, worst, f"D={d} B={B} S={S} H={h} KV={kv} {label} causal={causal}")


def _hold_k23(q, k, v, o, lse, do, seg, causal, worst, desc):
    """One launch of K3 and K2 (through flash_bwd) on these inputs against
    flash_bwd_reference in fp32, one batch row at a time."""
    import torch

    from ray_tpu_torch.ops import attention as att

    got = att.flash_bwd(q, k, v, o, lse, do, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    want = _bwd_rows(q.float(), k.float(), v.float(), o.float(), lse, do.float(), seg, causal)
    parts = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        finite = bool(torch.isfinite(g).all())
        parts.append(f"{name} {err:.3e} (max|ref| {top:.2f})")
        if not (finite and err <= 2e-2 * top + 2e-2):
            raise AssertionError(f"K2/K3 {name} disagrees with its plain version at {desc}: {err} (max|ref| {top})")
        worst[name] = max(worst[name], err)
    log(f"K3/K2 {desc}: max|g-ref| " + "  ".join(parts))


def phase_k23(dev, rng, shp):
    """Phase 5 at one head dim (an entry of SHAPES)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h, kv, d = shp["h"], shp["kv"], shp["d"]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, S in shp["k23"]:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, h, kv, "pad", d)
    for B, S, hh, kk, kind in shp["extra"]:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, hh, kk, kind, d)
    torch.cuda.empty_cache()

    # Determinism: no atomics, a fixed summation order; two launches of each
    # kernel on the same inputs give the same bits.
    B, S = shp["det"]
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg, True, h, kv, d)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * h, S)
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, seg), *att.flash_bwd_dkv(q, k, v, do, lse, delta, seg))
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K3/K2 D={d} determinism (B={B} S={S} packed, two launches): dq {same[0]}  dk {same[1]}  dv {same[2]} "
        f"bitwise equal")
    if not all(same):
        raise AssertionError(f"K3/K2 at D={d} are not deterministic: two launches on the same inputs differ")
    del q, k, v, o, lse, do, delta, runs
    torch.cuda.empty_cache()

    # Timing at the training shape (causal, one sequence per row, as the
    # train phase runs them).
    B, S = shp["train"]
    q, k, v, o, lse, do = _bwd_case(dev, B, S, h=h, kv=kv, d=d)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * h, S)
    dq_ms = device_ms(lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), iters=10)
    dkv_ms = device_ms(lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), iters=10)
    plain = _bwd_rows if shp["rows"] else att.flash_bwd_reference
    plain_ms = time_ms(lambda: plain(q, k, v, o, lse, do), iters=3, warmup=1)
    torch.cuda.empty_cache()
    # The timed shape itself, held like the sweep (no new random draws).
    _hold_k23(q, k, v, o, lse, do, None, True, worst, f"D={d} B={B} S={S} H={h} KV={kv} train causal=True")
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    pairs = B * h * S * (S + 1) // 2
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 2 * 4 * B * h * S  # q k v dO, LSE delta
    dq_bound = bound(6 * d * pairs, io + 2 * q.numel())
    dkv_bound = bound(8 * d * pairs, io + 2 * (k.numel() + v.numel()))
    for name, ms, flops, (b_ms, b_by) in (("K3 (dQ)", dq_ms, 6 * d * pairs, dq_bound),
                                          ("K2 (dK,dV)", dkv_ms, 8 * d * pairs, dkv_bound)):
        log(f"{name} D={d} at training shape B={B} S={S}: kernel {ms:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s  "
            f"bound {b_ms:.4f} ms ({b_by})  {ms / b_ms:.2f}x bound")
    log(f"  K3 + K2 {dq_ms + dkv_ms:.4f} ms = {(dq_ms + dkv_ms) / library_ms:.2f}x sdpa backward (dq, dk, dv) "
        f"{library_ms:.4f} ms;  plain backward (dq, dk, dv) {plain_ms:.4f} ms")
    del q, k, v, o, lse, do, delta, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    common = dict(plain_ms=plain_ms, library_ms=library_ms,
                  plain_covers="flash_bwd_reference: dq, dk and dv in one call"
                               + (", one batch row at a time" if shp["rows"] else ""),
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


def _finished(done, n, vocab, max_tokens=None):
    """n requests finished at their token budget (default MAX_TOKENS), every
    token inside the vocabulary."""
    max_tokens = max_tokens or MAX_TOKENS
    return len(done) == n and all(len(ev["tokens"]) == max_tokens and ev["finish_reason"] == "length"
                                  and all(0 <= t < vocab for t in ev["tokens"]) for ev in done.values())


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)]


def drive(eng, prompts, max_tokens, prefix="r"):
    """Queues every prompt (ids prefix0, prefix1, ...), steps until all
    finish. Returns per-request results and the wall times of the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.add_request(f"{prefix}{i}", p, max_tokens)
    done, ttft = {}, {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("ttft_s") is not None and rid not in ttft:
                ttft[rid] = ev["ttft_s"]
            if ev.get("finished"):
                done[rid] = ev
    torch.cuda.synchronize()
    return done, ttft, t0, time.perf_counter()


def check_first_tokens(cfg, eng, prompts, done, dev, tol_max=0.25, tol_mean=0.02, chunk=None):
    """The engine's prefill logits against the plain forward, and each
    request's first token against the plain logits' top-1; `chunk` prompts
    at a time (default all: the plain forward's fp32 scores grow with it)."""
    import torch

    from ray_tpu_torch.models.transformer import forward_hidden, linear

    n, P = len(prompts), len(prompts[0])
    chunk = chunk or n
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    plain, served = [], []
    with torch.no_grad():
        for i in range(0, n, chunk):
            part = np.stack(prompts[i:i + chunk])
            m = len(part)
            toks = torch.tensor(part, dtype=torch.long, device=dev)
            # The plain forward's last position only: the [m, S, V] logits
            # at a 256000-entry vocabulary are 1 GB a 2048-token prompt in bf16.
            hidden = forward_hidden(eng.params, toks, plain_cfg)[0][:, -1]
            plain.append(linear(hidden, eng.params["lm_head"]).float())  # [m, V]
            third = (np.zeros((m, P // eng.ec.page_size), np.int32) if eng.paged
                     else np.arange(m, dtype=np.int64))  # dead page / idle slots
            served.append(eng._prefill_logits(part, np.full(m, P, np.int32), third))
    plain, served = torch.cat(plain), torch.cat(served)
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
    return dict(logits_max_diff=diff.max().item(), logits_mean_diff=diff.mean().item(), first_token_top1=top1,
                first_token_worst_gap=gap.max().item())


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
    tt = sorted(ttft.values())
    # Every request arrives at t0 and the last first token lands at t0 + max
    # TTFT; from then on the engine only decodes.
    decode_s = t1 - t0 - max(tt)
    stats = dict(
        ttft_p50_ms=1e3 * statistics.median(tt),
        ttft_p99_ms=1e3 * _pct(tt, 0.99),
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
    if not _finished(done, N_REQ, cfg.vocab_size):
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
    if not _finished(d_done, 4, cfg.vocab_size, max_tokens=16):
        raise AssertionError("dense engine run did not finish")
    if d_launch[0] == 0 or d_launch[1] != 0:
        raise AssertionError(f"dense run launches {d_launch}: expected K1 > 0 and K4 == 0")
    check_first_tokens(cfg, dense, prompts[:4], d_done, dev)
    return stats, launches


def _cached_tail_logits(eng, prompt, start):
    """The engine's tail prefill of prompt[start:] over the cached pages of
    prompt[:start], as admission runs it; the tail's own K/V go to the dead
    page."""
    j = start // eng.ec.page_size
    row = np.zeros(eng.ppseq, np.int32)
    row[:j] = eng._prefix_cache[eng._prefix_digests(prompt[:start])[-1][1]]["pages"][:j]
    padded, ctx, tail_pages = eng._tail_args(row, prompt, start, len(prompt) - start)
    return eng._tail_prefill_logits(padded, start, len(prompt), ctx, tail_pages)


def phase_prefix(dev, rng, profile_dir=None):
    """Phase 6b: the prefix cache and chunked prefill on phase 6's model."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig, forward
    from ray_tpu_torch.ops import attention, paged_attention

    cfg = TransformerConfig(**MODEL)
    V = cfg.vocab_size
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0,
        prefix_cache=True, chunked_prefill=CHUNK))
    eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # (a) shared system prompt: a chunked cold seed, partial hits, exact hits.
    sys_prompt = rng.integers(0, V, SYS_LEN).astype(np.int32)

    def with_tail(n):
        return np.concatenate([sys_prompt, rng.integers(0, V, n).astype(np.int32)])

    seed = with_tail(SEED_TAIL)
    hits = [with_tail(int(rng.integers(HIT_TAIL[0], HIT_TAIL[1] + 1))) for _ in range(N_HIT)]
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    d_seed, tt_seed, _, _ = drive(eng, [seed], MAX_TOKENS, "seed")
    d_hit, tt_hit, _, _ = drive(eng, hits, MAX_TOKENS, "hit")
    d_exact, tt_exact, _, _ = drive(eng, hits[:N_EXACT], MAX_TOKENS, "exact")
    launch_a = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    stats_a = eng.prefix_cache_stats
    hit_ms, exact_ms = [1e3 * t for t in tt_hit.values()], [1e3 * t for t in tt_exact.values()]
    log(f"engine prefix (a): seed {SYS_LEN}+{SEED_TAIL} tokens (chunks of {CHUNK}) TTFT "
        f"{1e3 * tt_seed['seed0']:.2f} ms; {N_HIT} partial hits (tails {HIT_TAIL[0]}-{HIT_TAIL[1]}) TTFT "
        f"p50 {statistics.median(hit_ms):.2f} ms p99 {_pct(hit_ms, 0.99):.2f} ms; {N_EXACT} exact hits TTFT "
        f"p50 {statistics.median(exact_ms):.2f} ms p99 {_pct(exact_ms, 0.99):.2f} ms")
    log(f"  prefix_cache_stats {stats_a}  launches K1 {launch_a['flash_fwd']}  K4 {launch_a['paged_decode']}")
    if not (_finished(d_seed, 1, V) and _finished(d_hit, N_HIT, V) and _finished(d_exact, N_EXACT, V)):
        raise AssertionError("prefix run (a) did not finish every request with max_tokens valid tokens")
    want = {"misses": 1, "partial_hits": N_HIT, "hits": N_EXACT}
    if {k: stats_a[k] for k in want} != want:
        raise AssertionError(f"prefix_cache_stats {stats_a} after (a), expected {want}")
    if launch_a["flash_fwd"] != 0 or launch_a["paged_decode"] == 0:
        raise AssertionError(f"launches in (a) {launch_a}: expected K1 0 (tail prefills only) and K4 > 0")

    # (b) short prompts decoding while long prompts prefill chunk by chunk.
    shorts = [rng.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(N_SHORT)]
    longs = [rng.integers(0, V, LONG_LEN).astype(np.int32) for _ in range(N_LONG)]
    groups = []  # prefill groups (each one K1 launch per layer)
    prefill = eng._prefill_batch_impl

    def counted(tokens, *a):
        groups.append(tokens.shape)
        return prefill(tokens, *a)

    eng._prefill_batch_impl = counted
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    for i, p in enumerate(shorts):
        eng.add_request(f"short{i}", p, MAX_TOKENS)
    done_b, steps, mid_steps, interleaved, mid_tokens, mid_s = {}, 0, 0, 0, 0, 0.0
    while eng.has_work():
        mid = bool(eng._prefilling)
        s0 = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - s0
        steps += 1
        n_short = sum(len(ev.get("new_tokens", ())) for r, ev in events.items() if r.startswith("short"))
        if mid:
            mid_steps, mid_s, mid_tokens = mid_steps + 1, mid_s + dt, mid_tokens + n_short
            interleaved += n_short > 0
        done_b.update((r, ev) for r, ev in events.items() if ev.get("finished"))
        if steps == 1:  # the short requests decode now; the long prompts arrive
            for i, p in enumerate(longs):
                eng.add_request(f"long{i}", p, MAX_TOKENS)
    del eng._prefill_batch_impl  # back to the class's method
    launch_b = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    decode_mid = mid_tokens / mid_s if mid_s else 0.0
    log(f"engine prefix (b): {N_SHORT} x {PROMPT_LEN}-token requests decoding, {N_LONG} x {LONG_LEN}-token "
        f"prompts chunked: {mid_steps} steps began mid-prefill, {interleaved} of them emitted short tokens; "
        f"decode {decode_mid:.1f} tok/s during those steps; prefill groups {len(groups)}; launches K1 "
        f"{launch_b['flash_fwd']}  K4 {launch_b['paged_decode']}")
    if not _finished(done_b, N_SHORT + N_LONG, V):
        raise AssertionError("prefix run (b) did not finish every request with max_tokens valid tokens")
    if interleaved < 2:
        raise AssertionError(f"decode emitted tokens in only {interleaved} steps that began mid-prefill")
    if launch_b["flash_fwd"] != cfg.n_layers * len(groups) or launch_b["paged_decode"] == 0:
        raise AssertionError(f"launches in (b) {launch_b}: expected K1 {cfg.n_layers} x {len(groups)} "
                             f"prefill groups and K4 > 0")
    wall_s = time.perf_counter() - t_phase
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Logits against the plain forward over the whole prompt: the tail
    # prefill of every partial hit and of each chunked prompt's last chunk,
    # and every request's first token (exact hits: out of the decode block).
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    with torch.no_grad():
        def plain(p):
            return forward(eng.params, torch.tensor(p[None], dtype=torch.long, device=dev), plain_cfg)[:, -1].float()

        last_chunk = [(p, (len(p) - 1) // CHUNK * CHUNK) for p in [seed] + longs]
        tails = [(p, SYS_LEN) for p in hits] + last_chunk
        diff = torch.cat([(_cached_tail_logits(eng, p, s) - plain(p)).abs() for p, s in tails])
        prompts = {"seed0": seed, **{f"hit{i}": p for i, p in enumerate(hits)},
                   **{f"exact{i}": hits[i] for i in range(N_EXACT)},
                   **{f"short{i}": p for i, p in enumerate(shorts)}, **{f"long{i}": p for i, p in enumerate(longs)}}
        firsts = {**d_seed, **d_hit, **d_exact, **done_b}
        gaps = []
        for rid, p in prompts.items():
            lg = plain(p)[0]
            gaps.append((lg.max() - lg[firsts[rid]["tokens"][0]]).item())
    log(f"  tail prefill logits vs plain forward ({len(tails)} prompts: {N_HIT} partial hits, {len(last_chunk)} "
        f"last chunks): max|diff| {diff.max().item():.4f}  mean|diff| {diff.mean().item():.5f}; first tokens of "
        f"{len(gaps)} requests: worst top-1 gap {max(gaps):.4f}")
    if not (bool(torch.isfinite(diff).all()) and diff.max() <= 0.25 and diff.mean() <= 0.02 and max(gaps) <= 0.25):
        raise AssertionError("the prefix/chunked engine's logits disagree with the plain forward")

    # The page copy moves bytes unchanged, in every layer.
    src, dst = sorted(eng._page_refs)[:8], list(eng.free_pages)[:8]
    eng._copy_pages(src, dst)
    same = all(torch.equal(pool[:, :, eng._pool_rows(dst)], pool[:, :, eng._pool_rows(src)])
               for pool in (eng.k_pages, eng.v_pages))
    held = sum(len(sl.pages) for sl in eng.slots if sl is not None)
    conserved = len(eng.free_pages) + len(eng._page_refs) + held == eng.ec.total_pages - 1
    log(f"  page copy of {len(src)} pages bitwise equal {same}; pages conserved {conserved} "
        f"(free {len(eng.free_pages)}, cached {len(eng._page_refs)}, pool {eng.ec.total_pages - 1}); "
        f"phase wall {wall_s:.3f} s, peak mem {peak_gb:.2f} GB")
    if not (same and conserved):
        raise AssertionError("page copy not bitwise or pages not conserved")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        for i in range(N_HIT):
            eng.add_request(f"p{i}", with_tail(int(rng.integers(HIT_TAIL[0], HIT_TAIL[1] + 1))), MAX_TOKENS)
        _profile_window("prefix_admit_step", eng.step, profile_dir, ops=PREFIX_OPS)
        while eng.has_work():
            eng.step()
    del eng
    torch.cuda.empty_cache()
    stats = dict(
        ttft_seed_ms=1e3 * tt_seed["seed0"],
        ttft_partial_hit_p50_ms=statistics.median(hit_ms), ttft_partial_hit_p99_ms=_pct(hit_ms, 0.99),
        ttft_exact_hit_p50_ms=statistics.median(exact_ms), ttft_exact_hit_p99_ms=_pct(exact_ms, 0.99),
        decode_tok_s_mid_prefill=decode_mid, mid_prefill_steps=mid_steps, interleaved_steps=interleaved,
        prefix_cache_stats=stats_a, tail_logits_max_diff=diff.max().item(),
        tail_logits_mean_diff=diff.mean().item(), first_token_worst_gap=max(gaps),
        wall_s=wall_s, peak_mem_gb=peak_gb, launches_a=launch_a, launches_b=launch_b, prefill_groups_b=len(groups),
    )
    launches = {k: launch_a[k] + launch_b[k] for k in launch_a}
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


def _count_calls(eng):
    """Counts the engine's prefill groups and decode steps from here on
    (each prefill group is one K1 launch per layer, each decode step one K4
    launch per layer). Returns (groups, steps, undo)."""
    groups, steps = [], []
    prefill, decode = eng._prefill_batch_impl, eng._decode

    def counted_prefill(tokens, *a):
        groups.append(tokens.shape)
        return prefill(tokens, *a)

    def counted_decode(n, gen):
        steps.append(n)
        return decode(n, gen)

    eng._prefill_batch_impl, eng._decode = counted_prefill, counted_decode

    def undo():
        del eng._prefill_batch_impl, eng._decode  # back to the class's methods

    return groups, steps, undo


def phase_big_serve(dev, rng, name, profile_dir=None):
    """Phase 6c (serve-mistral7b-paged) or 6d (serve-gemma2b-paged): the
    published shape of BIG[name] at full width and depth with seeded random
    weights through the paged engine (page 128), its requests all at once.
    K1 prefills and K4 decodes at the model's head dim."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import leaves
    from ray_tpu_torch.ops import attention, paged_attention

    spec = BIG[name]["serve"]
    cfg = TransformerConfig(**BIG[name]["model"])
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=spec["slots"], max_seq=cfg.max_seq_len, kv_layout="paged", page_size=PAGE, seed=0))
    n_params = sum(t.numel() for t in leaves(eng.params))
    pool_gb = 2 * eng.k_pages.numel() * eng.k_pages.element_size() / 1e9
    eng.warmup(buckets=(spec["prompt"],))
    torch.cuda.synchronize()
    log(f"engine {name}: {n_params / 1e9:.3f}B params (bf16 {2 * n_params / 1e9:.1f} GB), head_dim {cfg.head_dim}, "
        f"paged KV {eng.ec.total_pages} pages x {PAGE} tokens ({pool_gb:.1f} GB), built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s, memory {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    n_req, n_tokens = spec["req"], spec["tokens"]
    prompts = [rng.integers(0, cfg.vocab_size, spec["prompt"]).astype(np.int32) for _ in range(n_req)]
    groups, steps, undo = _count_calls(eng)
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    done, ttft, t0, t1 = drive(eng, prompts, n_tokens)
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    undo()
    n_tok = sum(len(ev["tokens"]) for ev in done.values())
    tt = sorted(ttft.values())
    decode_s = t1 - t0 - max(tt)  # every request arrives at t0; after the last first token, decode only
    stats = dict(
        ttft_p50_ms=1e3 * statistics.median(tt),
        ttft_p99_ms=1e3 * _pct(tt, 0.99),
        decode_tok_s=(n_tok - n_req) / decode_s,
        tok_s=n_tok / (t1 - t0),
        wall_s=t1 - t0,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        n_params=n_params, head_dim=cfg.head_dim, prefill_groups=len(groups), decode_steps=sum(steps),
    )
    log(f"engine {name} paged: {len(done)} requests x {spec['prompt']} prompt x {n_tokens} tokens, wall "
        f"{stats['wall_s']:.3f} s, TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
        f"decode {stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, "
        f"peak mem {stats['peak_mem_gb']:.2f} GB")
    want = {"flash_fwd": cfg.n_layers * len(groups), "paged_decode": cfg.n_layers * sum(steps)}
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']} "
        f"({len(groups)} prefill groups {groups[:1]}..., {sum(steps)} decode steps; expected {want})")
    if not _finished(done, n_req, cfg.vocab_size, max_tokens=n_tokens):
        raise AssertionError(f"{name} engine run did not finish every request with max_tokens valid tokens")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"{name} launches {launches} != {want} (or a kernel never launched)")
    stats.update(check_first_tokens(cfg, eng, prompts, done, dev, chunk=spec["check_chunk"]))
    if profile_dir:
        profile_engine(eng, prompts, profile_dir, n_tokens, prefix=f"{name}_")
    del eng
    torch.cuda.empty_cache()
    return stats, launches


def _oai_text(rng, words, fits):
    """Seeded words appended one at a time until `fits(text)` says the
    encoded prompt is long enough (True), must stop (None) or is short
    (False)."""
    text = str(rng.choice(words))
    while True:
        ok = fits(text)
        if ok:
            return text
        if ok is None:
            raise AssertionError("a prompt passed the top of its token range")
        text += " " + str(rng.choice(words))


def _oai_idle(srv, what):
    """The engine holds no request and every page is back, within 2 s."""
    eng = srv._llm.engine
    t_end = time.perf_counter() + 2.0
    while True:
        s = srv.stats()
        pages = len(eng.free_pages)
        if s["active_slots"] == 0 and s["waiting"] == 0 and pages == eng.ec.total_pages - 1:
            return
        if time.perf_counter() > t_end:
            raise AssertionError(f"after {what}: {s}, free pages {pages} of {eng.ec.total_pages - 1}")
        time.sleep(0.01)


def _oai_frames(frames, t_call):
    """Reads an SSE stream to its end: every frame parses, the last is
    [DONE]. Returns (chunks, seconds from the call to the first frame)."""
    chunks, first = [], None
    for f in frames:
        if first is None:
            first = time.perf_counter() - t_call
        if not (f.startswith("data: ") and f.endswith("\n\n")):
            raise AssertionError(f"not an SSE frame: {f!r}")
        chunks.append(f[len("data: "):-2])
    if chunks[-1] != "[DONE]":
        raise AssertionError(f"stream did not end with [DONE]: {chunks[-1]!r}")
    return [json.loads(c) for c in chunks[:-1]], first


def phase_serve_openai(dev, engine_only):
    """Phase 6e (serve-openai-250M): phase 6's model at full width and depth
    served as text through OpenAIServer (tokenizer, chat template, SSE) over
    LLMServer's stepping thread, which launches K1 and K4. `engine_only`:
    phase 6's numbers on the same model, printed beside these."""
    import tempfile
    import threading

    import torch

    from ray_tpu_torch import qos
    from ray_tpu_torch.llm import EngineConfig, OpenAIServer, Tokenizer, load_tokenizer
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    rng = np.random.default_rng(6)  # its own stream: the earlier phases keep theirs
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(OAI_WORDS)]
    corpus = [" ".join(rng.choice(words, 12)) for _ in range(OAI_SENTENCES)]
    try:
        import jinja2  # noqa: F401  (OpenAIServer renders a jinja template with it)
        template = CHATML
    except ImportError:
        template = None  # the legacy "role: content" format
    cfg = TransformerConfig(**MODEL)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokenizer.json")
        Tokenizer.train(corpus, vocab_size=3 + 256 + OAI_MERGES).save(path)
        tok = load_tokenizer(path)
        t_tok = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv = OpenAIServer(MODEL, dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0),
                           tokenizer=path, model_name="serve-openai-250M",
                           warmup_buckets=EngineConfig().prefill_buckets, chat_template=template)
    torch.cuda.synchronize()
    llm, eng = srv._llm, srv._llm.engine
    log(f"serve-openai: tokenizer {tok.vocab_size} ids ({len(tok.merges)} merges, trained in {t_tok:.2f} s), "
        f"chat template {'ChatML (jinja2)' if template else 'legacy (no jinja2)'}, server built and warmed up "
        f"in {time.perf_counter() - t0:.2f} s")
    lo, hi = OAI_PROMPT

    def n_completion(text):
        n = len(tok.encode(text, add_bos=True))
        return True if lo <= n <= hi else (None if n > hi else False)

    def chat(text):
        return [{"role": "system", "content": "You answer in words."}, {"role": "user", "content": text}]

    def n_chat(text):
        prompt, templated = srv._chat_prompt(chat(text))
        n = len(tok.encode(prompt, add_bos=not templated))
        return True if lo <= n <= hi else (None if n > hi else False)

    bodies = {}  # (kind, i) -> what the client sends
    base = dict(max_tokens=MAX_TOKENS, ignore_eos=True, timeout_s=OAI_TIMEOUT_S)
    for i in range(OAI_PER_KIND):
        bodies["completions_stream_greedy", i] = dict(base, prompt=_oai_text(rng, words, n_completion),
                                                      stream=True, temperature=0.0)
        bodies["completions_stream_sampled", i] = dict(base, prompt=_oai_text(rng, words, n_completion),
                                                       stream=True, **OAI_SAMPLED)
        bodies["chat_greedy", i] = dict(base, messages=chat(_oai_text(rng, words, n_chat)), temperature=0.0)
        ids = tok.encode(_oai_text(rng, words, lambda t: len(tok.encode(t, add_bos=True)) >= hi), add_bos=True)
        bodies["tokens_greedy", i] = dict(tokens=ids[:hi], max_tokens=MAX_TOKENS, ignore_eos=True)
    n_prompt = [len(tok.encode(b["prompt"], add_bos=True)) for k, b in bodies.items() if "prompt" in b]
    n_prompt += [len(b["tokens"]) for b in bodies.values() if "tokens" in b]

    # Observe without changing: each request's arrival and the engine's TTFT
    # for it, each step's span, and the final event of every generate /
    # generate_stream call, by client thread.
    groups, steps, undo = _count_calls(eng)
    finals, engine_ttft, arrivals, timeline = {}, {}, {}, []
    step, add_request, generate, generate_stream = eng.step, eng.add_request, llm.generate, llm.generate_stream

    def observed_add(rid, *a, **kw):
        arrivals[rid] = time.perf_counter()
        return add_request(rid, *a, **kw)

    def observed_step():
        t, n_wait, g0, s0 = time.perf_counter(), len(eng.waiting), len(groups), sum(steps)
        events = step()
        timeline.append((t, time.perf_counter(), n_wait, [g[0] for g in groups[g0:]], sum(steps) - s0))
        for rid, ev in events.items():
            if ev.get("ttft_s") is not None:
                engine_ttft.setdefault(rid, ev["ttft_s"])
        return events

    def observed_generate(*a, **kw):
        out = generate(*a, **kw)
        finals[threading.current_thread().name] = out
        return out

    def observed_stream(*a, **kw):
        it = generate_stream(*a, **kw)
        try:
            for ev in it:
                if ev["finished"]:
                    finals[threading.current_thread().name] = ev
                yield ev
        finally:
            it.close()

    eng.step, eng.add_request = observed_step, observed_add
    llm.generate, llm.generate_stream = observed_generate, observed_stream
    if not srv.check_health():
        raise AssertionError("the stepping thread is not running")
    results, errors = {}, []
    barrier = threading.Barrier(len(bodies))

    def client(key):
        kind, _ = key
        body = bodies[key]
        try:
            barrier.wait(timeout=OAI_TIMEOUT_S)
            t_call = time.perf_counter()
            if kind == "tokens_greedy":
                with qos.request_context(timeout_s=OAI_TIMEOUT_S):
                    results[key] = dict(out=srv._llm(body), wall_s=time.perf_counter() - t_call)
            elif body.get("stream"):
                chunks, first = _oai_frames(srv(body), t_call)
                results[key] = dict(chunks=chunks, client_ttft_s=first, wall_s=time.perf_counter() - t_call)
            else:
                results[key] = dict(out=srv(body), wall_s=time.perf_counter() - t_call)
        except Exception as e:  # noqa: BLE001  (raised in the main thread below)
            errors.append((key, e))

    threads = [threading.Thread(target=client, args=(key,), name=f"{key[0]}-{key[1]}") for key in bodies]
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    ttft_before = _ttft_count()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * OAI_TIMEOUT_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve-openai clients failed: {errors[:4]}")
    main_ttft, main_steps = dict(engine_ttft), list(timeline)
    ttft_observed = _ttft_count() - ttft_before
    if not srv.check_health():
        raise AssertionError("the stepping thread died during the traffic")

    # Gates on the 32: 64 tokens inside the vocabulary, finish "length".
    for key, r in results.items():
        kind, _ = key
        final = finals.get(f"{kind}-{key[1]}")
        if final is None or len(final["tokens"]) != MAX_TOKENS or final["finish_reason"] != "length" or \
                not all(0 <= t < cfg.vocab_size for t in final["tokens"]):
            raise AssertionError(f"{key}: engine result {final}")
        if kind == "tokens_greedy":
            out = r["out"]
            ok = out["tokens"] == final["tokens"] and out["finish_reason"] == "length"
        elif kind == "chat_greedy":
            out = r["out"]
            ok = (out["usage"]["completion_tokens"] == MAX_TOKENS and out["choices"][0]["finish_reason"] == "length"
                  and out["object"] == "chat.completion" and out["choices"][0]["message"]["role"] == "assistant")
        else:
            ch = r["chunks"]
            ok = (ch[-1]["choices"][0]["finish_reason"] == "length" and all(c["object"] == "text_completion"
                                                                           for c in ch)
                  and all(c["choices"][0]["finish_reason"] is None for c in ch[:-1]))
        if not ok:
            raise AssertionError(f"{key}: response {r}")
    n_req = len(results)
    tt = sorted(main_ttft.values())
    client_tt = sorted(r["client_ttft_s"] for r in results.values() if "client_ttft_s" in r)
    n_tok = n_req * MAX_TOKENS
    decode_s = t1 - t0 - max(tt)  # all released at t0; after the last first token, decode only
    peak = torch.cuda.max_memory_allocated() / 1e9

    # A token-level stream whose client leaves after 2 frames: aborted.
    frames = srv._llm(dict(bodies["tokens_greedy", 0], stream=True))
    two = [json.loads(next(frames)[len("data: "):]) for _ in range(2)]
    frames.close()
    if any(f["finished"] for f in two):
        raise AssertionError(f"the stream finished within 2 frames: {two}")
    _oai_idle(srv, "a stream closed after 2 frames")
    # A chat stream read to its end: the first chunk carries the role.
    chunks, _ = _oai_frames(srv(dict(bodies["chat_greedy", 0], stream=True)), time.perf_counter())
    if chunks[0]["choices"][0]["delta"].get("role") != "assistant" or \
            chunks[-1]["choices"][0]["finish_reason"] != "length":
        raise AssertionError(f"chat stream: first {chunks[0]}, last {chunks[-1]}")
    # A chat request whose deadline passes mid-decode: DeadlineExceeded, slot freed.
    try:
        srv(dict(bodies["chat_greedy", 1], timeout_s=OAI_DEADLINE_S))
    except qos.DeadlineExceeded:
        pass
    else:
        raise AssertionError(f"a {OAI_DEADLINE_S} s deadline did not raise DeadlineExceeded")
    _oai_idle(srv, f"a {OAI_DEADLINE_S} s deadline")
    if not srv.check_health():
        raise AssertionError("the stepping thread died")
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    undo()
    del eng.step, eng.add_request, llm.generate, llm.generate_stream  # back to the class's methods
    want = {"flash_fwd": cfg.n_layers * len(groups), "paged_decode": cfg.n_layers * sum(steps)}
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']} "
        f"({len(groups)} prefill groups {sorted(g[0] for g in groups)}, {sum(steps)} decode steps; "
        f"expected {want})")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"serve-openai launches {launches} != {want} (or a kernel never launched)")
    stats = dict(
        requests=n_req, prompt_tokens=[min(n_prompt), max(n_prompt)], max_tokens=MAX_TOKENS,
        client_ttft_p50_ms=1e3 * statistics.median(client_tt), client_ttft_p99_ms=1e3 * _pct(client_tt, 0.99),
        ttft_p50_ms=1e3 * statistics.median(tt), ttft_p99_ms=1e3 * _pct(tt, 0.99),
        decode_tok_s=(n_tok - n_req) / decode_s, tok_s=n_tok / (t1 - t0), wall_s=t1 - t0, peak_mem_gb=peak,
        serve_ttft_s_observed=ttft_observed, prefill_groups=len(groups), decode_steps=sum(steps),
        tokenizer_vocab=tok.vocab_size, chat_template="chatml-jinja" if template else "legacy",
    )
    log(f"serve-openai: {n_req} requests ({OAI_PER_KIND} each of {', '.join(OAI_KINDS)}), prompts "
        f"{min(n_prompt)}-{max(n_prompt)} tokens x {MAX_TOKENS}, wall {stats['wall_s']:.3f} s, client TTFT "
        f"(streams) p50 {stats['client_ttft_p50_ms']:.2f} ms p99 {stats['client_ttft_p99_ms']:.2f} ms, engine "
        f"TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, decode "
        f"{stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, peak mem {peak:.2f} GB")
    arr = sorted(1e3 * (t - t0) for rid, t in arrivals.items() if rid in main_ttft)
    stats["arrival_ms"] = [arr[0], statistics.median(arr), arr[-1]]
    stats["steps"] = [dict(start_ms=1e3 * (a - t0), ms=1e3 * (b - a), waiting=w, prefill_k=k, decode=n)
                      for a, b, w, k, n in main_steps]
    log(f"  requests reach the engine {arr[0]:.2f} / {statistics.median(arr):.2f} / {arr[-1]:.2f} ms after "
        f"the release (first / median / last); steps (start ms, ms, waiting, prefill groups, decode steps): "
        + " ".join(f"({1e3 * (a - t0):.1f}, {1e3 * (b - a):.1f}, {w}, {k}, {n})" for a, b, w, k, n in main_steps[:8])
        + f" ... {len(main_steps)} steps")
    over = {k: stats[k] / engine_only[k] for k in ("ttft_p50_ms", "wall_s")}
    over.update({k: engine_only[k] / stats[k] for k in ("decode_tok_s", "tok_s")})
    log(f"  phase 6 (engine alone, same model and traffic shape): TTFT p50 {engine_only['ttft_p50_ms']:.2f} ms, "
        f"decode {engine_only['decode_tok_s']:.1f} tok/s, overall {engine_only['tok_s']:.1f} tok/s, wall "
        f"{engine_only['wall_s']:.3f} s; the serving surface's overhead (x): "
        + ", ".join(f"{k} {v:.3f}" for k, v in over.items()))
    stats["engine_only"] = {k: engine_only[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "decode_tok_s", "tok_s",
                                                         "wall_s")}
    stats["overhead_x"] = over
    if ttft_observed != n_req:
        raise AssertionError(f"serve.ttft_s observed {ttft_observed} first tokens of {n_req} requests")
    # The token-level requests' first tokens against the plain forward.
    keys = [("tokens_greedy", i) for i in range(OAI_PER_KIND)]
    prompts = [np.asarray(bodies[k]["tokens"], np.int32) for k in keys]
    done = {f"r{i}": results[k]["out"] for i, k in enumerate(keys)}
    stats.update(check_first_tokens(cfg, eng, prompts, done, dev))
    srv.__raytpu_exit__()
    del srv, llm, eng
    torch.cuda.empty_cache()
    return stats, launches


def _ttft_count():
    """Observations in this process's serve.ttft_s histogram."""
    from ray_tpu_torch.util import metrics

    return sum(s.get("n", 0) for s in metrics.snapshot() if s["name"] == "serve.ttft_s")


def phase_big_train(dev, card, name, profile_dir=None):
    """Phase 7e (train-mistral7b-4L) or 7f (train-gemma2b-4L): the gradient
    check at BIG[name]'s widths (2 layers, B 1 x S 2048, K1-K3 at the
    model's head dim against the plain path), then make_train_step on the
    same widths cut to a few layers (remat "dots", AdamW, one seeded batch):
    a warmup step and TRAIN_STEPS timed steps."""
    import warnings

    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.models.transformer import init_params, leaves
    from ray_tpu_torch.ops import attention

    model, par, tr = BIG[name]["model"], BIG[name]["parity"], BIG[name]["train"]
    cfg = TransformerConfig(**{**model, "n_layers": par["layers"]})
    g = torch.Generator(device=dev).manual_seed(par["seed"])
    params = init_params(cfg, g, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (par["b"], par["s"] + 1), generator=g, device=dev)}
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    loss_f, g_flash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="flash"))
    parity_launches = (attention.LAUNCHES, attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES)
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    loss_r, g_ref = _loss_grads(params, batch, plain_cfg)
    rel = _rel_errs(g_flash, g_ref)
    log(f"train {name} parity ({par['layers']} layers, B {par['b']} x S {par['s']}, bf16, D {cfg.head_dim}): "
        f"oracle attention_impl={plain_cfg.attention_impl!r}; loss flash {loss_f:.5f} reference {loss_r:.5f}; "
        f"per-leaf |g-g_ref|/|g_ref| max {max(rel):.3e} mean {statistics.mean(rel):.3e}; launches K1/K3/K2 "
        f"{parity_launches}")
    if not (math.isfinite(loss_f) and abs(loss_f - loss_r) <= 1e-2 and max(rel) <= 5e-2):
        raise AssertionError(f"{name} flash training gradients disagree with the plain path: {rel}")
    if parity_launches != (par["layers"],) * 3:
        raise AssertionError(f"the parity step did not run K1, K3, K2 once per layer: {parity_launches}")
    del params, g_flash, g_ref, batch
    torch.cuda.empty_cache()

    B, S = tr["b"], tr["s"]
    if tr["ce_chunk"] and S % tr["ce_chunk"]:
        raise AssertionError(f"ce_chunk {tr['ce_chunk']} does not divide S {S}: the loss would materialise logits")
    cfg = TransformerConfig(**{**model, "n_layers": tr["layers"]}, remat=True, remat_policy="dots",
                            ce_chunk=tr["ce_chunk"])
    init_state, train_step = make_train_step(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, device=dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g, device=dev)}
    with warnings.catch_warnings():
        # The chunked loss's fallback to whole logits warns: make it an error here.
        warnings.filterwarnings("error", message=".*ce_chunk.*")
        t0 = time.perf_counter()
        first = train_step(state, batch)
        torch.cuda.synchronize()
        log(f"train {name}: {n_params / 1e9:.3f}B params ({tr['layers']} of {model['n_layers']} layers), remat "
            f"{cfg.remat_policy!r}, ce_chunk {cfg.ce_chunk}, B {B} x S {S}, warmup step "
            f"{time.perf_counter() - t0:.2f} s, loss {first['loss'].item():.4f}")
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
    tokens = B * S
    flops = 6.0 * n_params * tokens + 12.0 * cfg.n_layers * cfg.d_model * S * tokens
    stats = dict(step_ms=dt * 1e3, tokens_per_s=tokens / dt, mfu=flops / dt / PEAK_BF16_FLOPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, loss_first=losses[0],
                 loss_last=losses[-1], n_params=n_params, head_dim=cfg.head_dim, ce_chunk=cfg.ce_chunk,
                 parity_max_rel=max(rel), card=card)
    log(f"train {name}: {TRAIN_STEPS} steps, step {stats['step_ms']:.2f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s, MFU {stats['mfu']:.4f} (6NT + 12LdST against 989 TFLOP/s), peak mem "
        f"{stats['peak_mem_gb']:.2f} GB  [{card}]")
    log(f"  loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad_norm {' '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"  launches in {TRAIN_STEPS} steps: K1 {launches['flash_fwd']}  K3 {launches['flash_bwd_dq']}  "
        f"K2 {launches['flash_bwd_dkv']}")
    if not all(math.isfinite(x) for x in losses + gnorms) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} training loss is not finite and falling: {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS, "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"{name} kernel launches in {TRAIN_STEPS} training steps {launches} != {want}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        _profile_window(f"{name}_train_step", lambda: train_step(state, batch), profile_dir)
    del state, batch
    torch.cuda.empty_cache()
    return stats, launches


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


def _profile_window(name, fn, out_dir, ops=()):
    """torch.profiler over fn(); writes the kernel table and the trace to
    out_dir and prints the wall time, device kernel time, device time by
    kind, the device time under each of ``ops`` (ops may nest) and top rows."""
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
    total = "device_time_total" if ka and hasattr(ka[0], "device_time_total") else "cuda_time_total"
    for row in (r for r in ka if r.key in ops):
        us = getattr(row, total)
        log(f"  under {row.key}: {us / 1e3:.2f} ms ({100 * us / max(dev_us, 1e-9):.1f} %, {row.count} calls)")
    log(ka.table(sort_by=key, row_limit=12))


def profile_engine(eng, prompts, out_dir, max_tokens=MAX_TOKENS, prefix=""):
    """The paged engine under torch.profiler: the admission step (32
    prefills and the first decode block), then two decode-only steps."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(prompts):
        eng.add_request(f"p{i}", p, max_tokens)
    _profile_window(f"{prefix}admit_step", eng.step, out_dir)
    _profile_window(f"{prefix}decode_2_steps", lambda: (eng.step(), eng.step()), out_dir)
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
    ptxas = phase_build()
    # Every D-64 phase first, in the order and on the random streams of
    # earlier versions of this script; then the D-128 and D-256 kernel phases.
    timed = {}
    for d in SHAPES:
        if d == 64:
            k1 = phase_k1(dev, rng, SHAPES[64])
            k4 = phase_k4(dev, rng)
            k3, k2 = phase_k23(dev, rng, SHAPES[64])
            splash = phase_splash(dev, rng, k1["train_shape"], k3, k2)
            timed[64] = dict(flash_fwd=k1, paged_decode=k4, flash_bwd_dq=k3, flash_bwd_dkv=k2)
        else:
            k1_d = phase_k1(dev, rng, SHAPES[d])
            k4_d = phase_k4_big(dev, rng, d)
            k3_d, k2_d = phase_k23(dev, rng, SHAPES[d])
            timed[d] = dict(flash_fwd=k1_d, paged_decode=k4_d, flash_bwd_dq=k3_d, flash_bwd_dkv=k2_d)
    stats, launches = phase_engine(dev, rng, args.profile)
    prefix, p_launches = phase_prefix(dev, rng, args.profile)
    m_serve, m_launches = phase_big_serve(dev, rng, "mistral7b", args.profile)
    g_serve, g_launches = phase_big_serve(dev, rng, "gemma2b", args.profile)
    oai, o_launches = phase_serve_openai(dev, stats)
    train, t_launches, s_launches = phase_train(dev, card, args.profile)
    m_train, mt_launches = phase_big_train(dev, card, "mistral7b", args.profile)
    g_train, gt_launches = phase_big_train(dev, card, "gemma2b", args.profile)
    # Launches by path: serve, serve_prefix, serve_openai and train are the
    # 250M cells (D 64); serve_mistral7b and train_mistral7b the 7B cells
    # (D 128); serve_gemma2b and train_gemma2b the 2B cells (D 256).
    paths = {"serve": launches, "serve_prefix": p_launches, "serve_openai": o_launches, "train": t_launches,
             "serve_mistral7b": m_launches, "train_mistral7b": mt_launches, "serve_gemma2b": g_launches,
             "train_gemma2b": gt_launches}
    big_paths = {128: "mistral7b", 256: "gemma2b"}

    def entry(name, source, replaces, **extra):
        counts = {p: n[name] for p, n in paths.items() if name in n}
        kind = {"paged_decode": "paged_decode_kernel"}.get(name, f"{name}_kernel")
        reports = ptxas.get(kind)
        big = {}
        for d, model in big_paths.items():
            # K4's instances are per group (4 at Mistral-7B's heads, 8 at
            # Gemma-2B's), the flash kernels' per head dim.
            key = str(SHAPES[d]["h"] // SHAPES[d]["kv"]) if name == "paged_decode" else str(d)
            big[f"d{d}"] = dict(timed[d][name], launches_by_path={p: n for p, n in counts.items() if p.endswith(model)},
                                ptxas=None if reports is None else reports.get(key))
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=sum(counts.values()),
                    launches_by_path=counts, ptxas=reports, **timed[64][name], **big, **extra)

    bwd_src = "ray_tpu_torch/ops/csrc/flash_bwd.cu"
    kernels = [
        entry("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:92"),
        entry("flash_bwd_dq", bwd_src, "ray_tpu/ops/attention.py:277"),
        entry("flash_bwd_dkv", bwd_src, "ray_tpu/ops/attention.py:210"),
        entry("paged_decode", "ray_tpu_torch/ops/csrc/paged_decode.cu", "ray_tpu/ops/paged_attention.py:67"),
        dict(name="splash", route="onto K1-K3", source="ray_tpu_torch/ops/splash.py",
             replaces="ray_tpu/ops/splash.py:33", launches=sum(s_launches.values()),
             launches_by_kernel=s_launches, **splash),
    ]
    log(json.dumps({"engine": stats}))
    log(json.dumps({"engine_prefix": prefix}))
    log(json.dumps({"engine_mistral7b": m_serve}))
    log(json.dumps({"engine_gemma2b": g_serve}))
    log(json.dumps({"engine_openai": oai}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_mistral7b": m_train}))
    log(json.dumps({"train_gemma2b": g_train}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
