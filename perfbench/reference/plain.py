"""The plain pieces every reference is built from: plain PyTorch, float32,
TF32 off, no kernel, no cache, no batching across sequences. A model type's
reference (``reference/<model_type>.py``) gives its block; the decoder
around it (embedding, the blocks, a final norm, an untied head), the served
gaps and the AdamW steps are here.

RMSNorm has the port's eps (1e-6), rotary positions turn the two halves of
each head, attention is grouped-query and causal with an fp32 softmax.
Weights come in the benchmark's tree layout (layers stacked on [L]); in
``served_gaps`` each layer is cast to float32 only while it runs, so a 7B
model fits beside the program on one card.

``fp8=True`` computes every matrix product of the weights from operands
rounded to float8 with one scale per tensor: e4m3 activations and weights
forward, e5m2 output gradients backward. That is the next precision below
the bfloat16 the configurations state, which the comparison's control is
computed in; attention and the norms stay in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch

from perfbench.weights import leaf_items

EPS = 1e-6


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products in float32 (TF32 off) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


E4M3, E5M2 = (torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)


def fake_fp8(x, fmt=E4M3):
    """x rounded to float8 under a per-tensor scale (its absolute maximum
    mapped to the format's largest value), back in x's type."""
    dtype, top = fmt
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w from float8 operands: e4m3 activations and weights forward,
    e5m2 output gradients backward (the usual float8 training recipe), the
    products accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fake_fp8(x), fake_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fake_fp8(g, E5M2)
        return gq @ wq.T, xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])


def mm(x, w, fp8=False):
    """x [..., K] times a weight whose leading axis is K; the weight's
    trailing axes are kept."""
    w2 = w.reshape(w.shape[0], -1)
    out = _Fp8Matmul.apply(x, w2) if fp8 else x @ w2
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def rms_norm(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def rope(x, theta):
    """x [R, S, H, Hd] at positions 0..S-1, the two halves rotated."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal grouped-query attention. q [R, S, H, Hd], k/v [R, S, KV, Hd]."""
    S, H, Hd = q.shape[1], q.shape[2], q.shape[3]
    group = H // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) / math.sqrt(Hd)
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    return torch.einsum("rhqk,rkhd->rqhd", p, v)


def n_layers(params: dict) -> int:
    return next(iter(params["layers"].values())).shape[0]


def _layer_f32(params, i):
    return {k: v[i].float() for k, v in params["layers"].items()}


def served_gaps(params: dict, block, seqs: list, control: bool = False) -> list:
    """For each (prompt, served tokens) pair, the reference's logits at the
    positions that produced the served tokens, the prompt and the tokens
    before each as context; ``block(x, lp, fp8)`` is one layer on x [R, S, D]
    with that layer's weights ``lp``. Returns per pair {"gap": the widest
    amount by which a served token's logit lies below the reference's best,
    "tokens": its count} and, with ``control``, "control_gap": the same for
    the tokens the fp8 computation ranks first at those positions."""
    with torch.no_grad(), exact_fp32():
        dev = params["embed"].device
        ids = [torch.tensor(list(p) + list(s[:-1]), dtype=torch.long, device=dev) for p, s in seqs]
        xs = [params["embed"][t].float()[None] for t in ids]
        xcs = [x.clone() for x in xs] if control else None
        for i in range(n_layers(params)):
            lp = _layer_f32(params, i)
            for j in range(len(xs)):
                xs[j] = block(xs[j], lp, False)
                if control:
                    xcs[j] = block(xcs[j], lp, True)
            del lp
        fnorm, head = params["final_norm"].float(), params["lm_head"].float()
        out = []
        for j, (p, s) in enumerate(seqs):
            at = torch.arange(len(p) - 1, len(p) - 1 + len(s), device=dev)
            logits = mm(rms_norm(xs[j][0, at], fnorm), head)
            best = logits.max(dim=-1).values
            served = torch.tensor(list(s), dtype=torch.long, device=dev)
            rec = {"gap": float((best - logits.gather(-1, served[:, None])[:, 0]).max()), "tokens": len(s)}
            if control:
                picked = mm(rms_norm(xcs[j][0, at], fnorm), head, fp8=True).argmax(dim=-1)
                rec["control_gap"] = float((best - logits.gather(-1, picked[:, None])[:, 0]).max())
            out.append(rec)
        return out


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def nll_sum(params, tokens, block, fp8):
    """Summed next-token NLL of tokens [R, S + 1] (inputs all but the last)
    through the decoder of ``block``."""
    x = params["embed"][tokens[:, :-1]]
    for i in range(n_layers(params)):
        x = block(x, {k: v[i] for k, v in params["layers"].items()}, fp8)
    logits = mm(rms_norm(x, params["final_norm"]), params["lm_head"], fp8)
    tgt = tokens[:, 1:]
    return (torch.logsumexp(logits, dim=-1) - logits.gather(-1, tgt[..., None])[..., 0]).sum()


def train_steps(params0: dict, loss_sum, batches: list, rows: int, fp8: bool = False,
                lr: float = 3e-4, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01) -> dict:
    """Plain AdamW training from ``params0`` (float32 copies are made) over
    ``batches`` ([B, S + 1] token ids each): the loss is ``loss_sum(params,
    tokens, fp8)`` of each block of ``rows`` rows over B x S, each batch's
    gradient summed over the blocks. Returns {"losses": per step,
    "grad_norms": per leaf, of the first step's gradient, "change_norms": per
    leaf, of the parameters' change over all steps} (leaves by dotted path,
    as ``weights.leaf_items`` names them)."""
    with exact_fp32():
        p = _tree_map(lambda t: t.float().clone(), params0)
        names, leaves = zip(*leaf_items(p))
        start = [t.clone() for t in leaves]
        for t in leaves:
            t.requires_grad_(True)
        m1 = [torch.zeros_like(t) for t in leaves]
        m2 = [torch.zeros_like(t) for t in leaves]
        losses, grad_norms = [], None
        for step, tokens in enumerate(batches, 1):
            B, S = tokens.shape[0], tokens.shape[1] - 1
            for t in leaves:
                t.grad = None
            total = 0.0
            for r in range(0, B, rows):
                s = loss_sum(p, tokens[r:r + rows], fp8)
                (s / (B * S)).backward()
                total += float(s.detach())
            losses.append(total / (B * S))
            with torch.no_grad():
                grads = [t.grad for t in leaves]
                if grad_norms is None:
                    grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
                b1, b2 = betas
                for t, g, a, v in zip(leaves, grads, m1, m2):
                    a.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    t.mul_(1 - lr * weight_decay)
                    denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
                    t.addcdiv_(a, denom, value=-lr / (1 - b1 ** step))
        with torch.no_grad():
            change = [float(torch.linalg.vector_norm(t - s)) for t, s in zip(leaves, start)]
        return {"losses": losses, "grad_norms": dict(zip(names, grad_norms)),
                "change_norms": dict(zip(names, change))}
