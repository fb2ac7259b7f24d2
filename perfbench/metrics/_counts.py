"""The yardstick's arithmetic: the chip's peaks, the model's FLOPs from the
counts its model type's module gives (``models/<type>.py``, which also owns
its kernels' operations and bytes), percentiles.

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


def causal_pairs(n: int) -> int:
    """Valid (query, key) pairs of one causal sequence of n tokens."""
    return n * (n + 1) // 2


# -- the model's FLOPs, from its model type's module (models/<type>.py) -------

def prefill_flops(model, m: dict, lengths) -> float:
    """Prompts of these real lengths: every token through every layer, the
    head at each prompt's last position only (the engine computes no other
    prompt logits)."""
    weights, head = model.matmul_params(m), model.head_params(m)
    return float(sum(2.0 * weights * P + 2.0 * head + model.attn_fwd_flops(m, P) for P in lengths))


def decode_token_flops(model, m: dict, ctx: int) -> float:
    """One generated token attending to ``ctx`` keys (itself included)."""
    return 2.0 * (model.matmul_params(m) + model.head_params(m)) + model.decode_attn_flops(m, ctx)


def train_step_flops(model, m: dict, B: int, S: int) -> float:
    """Forward and backward of B sequences of S tokens with logits at every
    position: 6 per matmul weight per token plus 3 x the causal attention."""
    return 6.0 * (model.matmul_params(m) + model.head_params(m)) * B * S + 3.0 * model.attn_fwd_flops(m, S) * B


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
