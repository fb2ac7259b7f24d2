"""The plain reference of model_type "mellum" (JetBrains' Mellum2), in the
decoder of ``plain.py``: float32, TF32 off, no kernel of the port.

Written from the published description, not from the port: grouped-query
attention at the configuration's head_dim; sliding layers see the keys j of
query i with i - window < j <= i and rotate with plain RoPE; full layers
attend causally and rotate with YaRN's frequencies (written out below, as
transformers' ``_compute_yarn_parameters`` gives them), cos and sin times
its attention factor. Attention runs in blocks of queries, each against the
keys it can see, so an 8k-token sequence fits beside the program. The
experts: this reference's own router (an fp32 softmax over the experts, the
top k renormalised; in the control the router's product is float8 like
every other weight product) picks each token's experts, and each expert's
SwiGLU runs on the tokens routed to it; the program's routing is never
read.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import plain
from perfbench.reference.plain import mm, rms_norm

Q_BLOCK = 1024  # queries per attention block


def yarn_freqs(d: int, theta: float, p: dict):
    """YaRN's rotation frequencies [d / 2]: theta^(-2i/d) where a dimension
    turns within the original context, divided by ``factor`` where it
    does not, a linear ramp between the correction dims of beta_fast and
    beta_slow."""
    i = torch.arange(d // 2, dtype=torch.float64)
    extra = theta ** (-2.0 * i / d)
    inter = extra / p["factor"]
    orig = p["original_max_position_embeddings"]
    low = math.floor(d * math.log(orig / (p["beta_fast"] * 2 * math.pi)) / (2 * math.log(theta)))
    high = math.ceil(d * math.log(orig / (p["beta_slow"] * 2 * math.pi)) / (2 * math.log(theta)))
    low, high = max(low, 0), min(high, d - 1)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return (inter * ramp + extra * (1 - ramp)).float()


def rotate(x, freqs, scale=1.0):
    """x [R, S, H, Hd] at positions 0..S-1 by ``freqs``, the two halves
    rotated (the port's layout), cos and sin times ``scale``."""
    S, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs.to(x.device)
    cos, sin = (torch.cos(ang) * scale)[None, :, None, :], (torch.sin(ang) * scale)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int = 0):
    """Causal grouped-query attention, within ``window`` keys of each query
    when it is > 0, in blocks of Q_BLOCK queries. q [R, S, H, Hd], k/v
    [R, S, KV, Hd]."""
    S, H, Hd = q.shape[1], q.shape[2], q.shape[3]
    group = H // k.shape[2]
    out = torch.empty_like(q)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        k0 = max(0, q0 - window + 1) if window else 0
        kb = k[:, k0:q1].repeat_interleave(group, dim=2)
        vb = v[:, k0:q1].repeat_interleave(group, dim=2)
        s = torch.einsum("rqhd,rkhd->rhqk", q[:, q0:q1], kb) / math.sqrt(Hd)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        hidden = kj > qi
        if window:
            hidden = hidden | (kj <= qi - window)
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
        out[:, q0:q1] = torch.einsum("rhqk,rkhd->rqhd", p, vb)
    return out


def experts(h, lp, m: dict, fp8=False):
    """The routed experts on h [R, S, D]: the router's fp32 softmax, each
    token's top k renormalised, each expert's SwiGLU on its tokens."""
    R, S, D = h.shape
    flat = h.reshape(R * S, D)
    probs = torch.softmax(mm(flat, lp["router"], fp8), dim=-1)
    top_w, top_idx = torch.topk(probs, m["expert_top_k"], dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(flat)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(top_idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = flat[tok]
        y = mm(torch.nn.functional.silu(mm(x, lp["w_gate"][e], fp8)) * mm(x, lp["w_up"][e], fp8), lp["w_down"][e], fp8)
        out.index_add_(0, tok, top_w[tok, slot][:, None] * y)
    return out.reshape(R, S, D)


def layer(x, lp, m: dict, li: int, fp8=False):
    """Decoder block ``li`` on x [R, S, D] with that layer's weights ``lp``."""
    Hd = m["head_dim"]
    window = m["sliding_window"] if m["layer_types"][li] == "sliding" else 0
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = mm(h, lp["wq"], fp8), mm(h, lp["wk"], fp8), mm(h, lp["wv"], fp8)
    if window:
        freqs = m["rope_theta"] ** (-2.0 * torch.arange(Hd // 2, dtype=torch.float64) / Hd)
        q, k = rotate(q, freqs.float()), rotate(k, freqs.float())
    else:
        y = m["rope_scaling"]
        freqs = yarn_freqs(Hd, y["rope_theta"], y)
        q, k = rotate(q, freqs, y["attention_factor"]), rotate(k, freqs, y["attention_factor"])
    o = attention(q, k, v, window)
    x = x + mm(o.reshape(*o.shape[:2], -1), lp["wo"].reshape(-1, lp["wo"].shape[-1]), fp8)
    return x + experts(rms_norm(x, lp["ffn_norm"]), lp, m, fp8)


def _indexed(params: dict) -> dict:
    """The tree with each layer's index beside its weights ("index", [L]),
    so a block that ``plain`` hands one layer's slice knows which it is."""
    L = plain.n_layers(params)
    index = torch.arange(L, device=params["embed"].device)
    return {**params, "layers": {**params["layers"], "index": index}}


def forward_logits(params: dict, m: dict, tokens, fp8=False):
    """Logits [S, V] of one sequence (float32 copies of the weights): the
    whole forward, for tests and checks."""
    with torch.no_grad(), plain.exact_fp32():
        x = params["embed"][torch.as_tensor(tokens, device=params["embed"].device).long()].float()[None]
        for i in range(plain.n_layers(params)):
            lp = {k: t[i].float() for k, t in params["layers"].items()}
            x = layer(x, lp, m, i, fp8)
        return mm(rms_norm(x[0], params["final_norm"].float()), params["lm_head"].float(), fp8)


def served_gaps(params: dict, m: dict, seqs: list, control: bool = False) -> list:
    def block(x, lp, fp8):
        return layer(x, lp, m, int(lp["index"]), fp8)

    return plain.served_gaps(_indexed(params), block, seqs, control)


def train_steps(params0: dict, m: dict, batches: list, rows: int, fp8: bool = False) -> dict:
    raise NotImplementedError("the mellum block is served, not trained, here: K3/K2 take no window")
