"""Splash attention: the counterpart of ``ray_tpu/ops/splash.py``, which
wraps jax's library splash kernel (a block-sparse TPU flash attention with a
causal ``MultiHeadMask`` and optional segment ids).

No second kernel: for a causal mask, splash's block sparsity is the skip of
the tiles above the diagonal, which the port's flash kernels already do
(K1 ``csrc/flash_fwd.cu``; K3 and K2 ``csrc/flash_bwd.cu`` never load those
tiles), and its segment ids are their same-segment mask. So this wrapper keeps
the JAX wrapper's contract and dispatches onto ``flash_attention``: on the
card K1 runs forward and K3 + K2 backward; CPU tensors take the plain
version. GQA needs no fold to ``[B * KV, group, S, D]`` as the TPU kernel
needed (its MQA form): the kernels read grouped K/V natively.
"""
from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops.attention import flash_attention


def splash_attention(q, k, v, causal: bool = True, scale=None, segment_ids=None):
    """q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D] (causal only)."""
    if not causal:
        raise NotImplementedError("splash wrapper is causal-only")
    # Splash computes q @ k^T unscaled: the softmax scale is folded into q in
    # fp32 and cast back, as the JAX wrapper does.
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q_scaled = (q.to(torch.float32) * scale).to(q.dtype)
    return flash_attention(q_scaled, k, v, causal=True, scale=1.0, segment_ids=segment_ids)
