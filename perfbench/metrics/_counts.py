"""The yardstick's arithmetic: the chip's peaks, operation and byte counts
of the model and of each kernel, percentiles.

The kernel counts are those of PERF.md's kernel table (``chip_smoke.py``'s
``k1_cost``/``causal_pairs``, its K3/K2 ``bound`` arguments and ``_time_k4``'s
bytes), copied here so the benchmark owns them; they count what the inputs
need (real prompt lengths, valid causal pairs), not padded buffers.

Model FLOPs: 2 per weight that enters a matrix product, per token; the
untied head counts where logits are computed, the embedding lookup never;
attention counts the causal work, 4 * d per valid (query, key) pair per
layer forward (d = heads * head_dim), three times that for training;
recomputation is not counted.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth,
# at the full 700 W power limit.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over the
    peak rate and bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def dims(m: dict):
    """(L, D, H, KV, Hd, F, V) of a TransformerConfig keyword dict."""
    D, H = m["d_model"], m["n_heads"]
    return m["n_layers"], D, H, m["n_kv_heads"] or H, D // H, m["d_ff"], m["vocab_size"]


def layer_matmul_params(m: dict) -> int:
    """Weights of one layer that enter matrix products: wq, wk, wv, wo and
    the three SwiGLU matrices."""
    _, D, H, KV, Hd, F, _ = dims(m)
    return D * H * Hd + 2 * D * KV * Hd + H * Hd * D + 3 * D * F


def head_params(m: dict) -> int:
    _, D, *_, V = dims(m)
    return D * V


def causal_pairs(n: int) -> int:
    """Valid (query, key) pairs of one causal sequence of n tokens."""
    return n * (n + 1) // 2


def attn_fwd_flops(m: dict, n: int) -> float:
    """Causal attention of one sequence of n tokens, all layers, forward."""
    L, _, H, _, Hd, _, _ = dims(m)
    return 4.0 * H * Hd * causal_pairs(n) * L


def prefill_flops(m: dict, lengths) -> float:
    """Prompts of these real lengths: every token through every layer, the
    head at each prompt's last position only (the engine computes no other
    prompt logits)."""
    L = m["n_layers"]
    return float(sum(2.0 * L * layer_matmul_params(m) * P + 2.0 * head_params(m) + attn_fwd_flops(m, P)
                     for P in lengths))


def decode_token_flops(m: dict, ctx: int) -> float:
    """One generated token attending to ``ctx`` keys (itself included)."""
    L, _, H, _, Hd, _, _ = dims(m)
    return 2.0 * (L * layer_matmul_params(m) + head_params(m)) + 4.0 * H * Hd * ctx * L


def train_step_flops(m: dict, B: int, S: int) -> float:
    """Forward and backward of B sequences of S tokens with logits at every
    position: 6 per matmul weight per token plus 3 x the causal attention."""
    L = m["n_layers"]
    return 6.0 * (L * layer_matmul_params(m) + head_params(m)) * B * S + 3.0 * attn_fwd_flops(m, S) * B


# -- kernels (one launch = one layer) -----------------------------------------

def k1_cost(h: int, kv: int, d: int, lengths, seg: bool = True):
    """K1 (flash forward) on sequences of these real lengths: (flops,
    bytes). Bytes: q and o, k and v in bf16, the fp32 LSE per q head and
    token, the int32 segment ids when the engine passes them."""
    T = int(sum(lengths))
    flops = 4.0 * d * h * sum(causal_pairs(int(P)) for P in lengths)
    nbytes = 2 * (2 * T * h * d + 2 * T * kv * d) + 4 * T * h + (4 * T if seg else 0)
    return flops, nbytes


def k3_cost(B: int, S: int, h: int, kv: int, d: int):
    """K3 (backward dQ), causal, one sequence per row: (flops, bytes)."""
    pairs = B * h * causal_pairs(S)
    io = 2 * (B * S * h * d * 2 + B * S * kv * d * 2) + 2 * 4 * B * h * S  # q, do, k, v; LSE, delta
    return 6.0 * d * pairs, io + 2 * B * S * h * d


def k2_cost(B: int, S: int, h: int, kv: int, d: int):
    """K2 (backward dK, dV), causal, one sequence per row: (flops, bytes)."""
    pairs = B * h * causal_pairs(S)
    io = 2 * (B * S * h * d * 2 + B * S * kv * d * 2) + 2 * 4 * B * h * S
    return 8.0 * d * pairs, io + 2 * 2 * B * S * kv * d


def k4_cost(h: int, kv: int, d: int, ctx_lengths, page_size: int):
    """K4 (paged decode), one query per sequence attending to ``ctx``
    keys: (flops, bytes). Bytes: K and V of every key read once, q and o,
    the lengths and the page-table entries of the pages read."""
    tokens = int(sum(ctx_lengths))
    B = len(ctx_lengths)
    pages = sum(math.ceil(n / page_size) for n in ctx_lengths)
    return 4.0 * h * d * tokens, 2 * tokens * kv * d * 2 + 2 * B * h * d * 2 + 4 * B + 4 * pages


# -- statistics ---------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default); +inf entries sort last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)
