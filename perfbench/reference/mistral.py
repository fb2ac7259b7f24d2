"""The plain reference of model_type "mistral": the Mistral 7B paper's
block (pre-norm RMSNorm, rotary positions, grouped-query causal attention
over the whole context, SwiGLU) in the decoder of ``plain.py``."""
from __future__ import annotations

import torch

from perfbench.reference import plain
from perfbench.reference.plain import attention, mm, rms_norm, rope


def layer(x, lp, m: dict, fp8=False):
    """One decoder block on x [R, S, D] with this layer's weights ``lp``."""
    theta = m["rope_theta"]
    h = rms_norm(x, lp["attn_norm"])
    q = rope(mm(h, lp["wq"], fp8), theta)
    k = rope(mm(h, lp["wk"], fp8), theta)
    v = mm(h, lp["wv"], fp8)
    o = attention(q, k, v)
    x = x + mm(o.reshape(*o.shape[:2], -1), lp["wo"].reshape(-1, lp["wo"].shape[-1]), fp8)
    h = rms_norm(x, lp["ffn_norm"])
    return x + mm(torch.nn.functional.silu(mm(h, lp["w_gate"], fp8)) * mm(h, lp["w_up"], fp8), lp["w_down"], fp8)


def served_gaps(params: dict, m: dict, seqs: list, control: bool = False) -> list:
    return plain.served_gaps(params, lambda x, lp, fp8: layer(x, lp, m, fp8), seqs, control)


def train_steps(params0: dict, m: dict, batches: list, rows: int, fp8: bool = False) -> dict:
    def loss_sum(p, tokens, fp8):
        return plain.nll_sum(p, tokens, lambda x, lp, fp8: layer(x, lp, m, fp8), fp8)

    return plain.train_steps(params0, loss_sum, batches, rows, fp8)
