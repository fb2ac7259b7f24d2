"""Decoder-only transformer LM in PyTorch: the forward pieces the serving
engine runs.

Counterpart of ``ray_tpu/models/transformer.py``. The parameter tree keeps
that module's names and shapes, layers stacked on a leading ``[L, ...]``
axis, so one set of weights (``ray_tpu_torch.convert``) feeds both packages.
The layer scan becomes a Python loop. Training, MoE, remat and the chunked
cross-entropy are not part of this package yet.

Numerics follow the JAX code, cast for cast: parameters are kept in
``param_dtype`` and cast to the activation ``dtype`` at each use (``.to`` is
a no-op once a caller has cast them, as the engine does at load), RMSNorm
takes its variance in fp32 and multiplies in the activation dtype, and RoPE
rotates the two HALVES of the head dimension.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ray_tpu_torch.ops.attention import mha_reference


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # GQA; None -> n_heads
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not divisible by kv_heads {self.kv_heads}")


def param_shapes(cfg: TransformerConfig) -> dict:
    """Same-structure tree of the parameter shapes (the JAX tree's)."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, Hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "embed": (cfg.vocab_size, D),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, H, Hd),
            "wk": (L, D, KV, Hd),
            "wv": (L, D, KV, Hd),
            "wo": (L, H, Hd, D),
            "ffn_norm": (L, D),
            "w_gate": (L, D, F),
            "w_up": (L, D, F),
            "w_down": (L, F, D),
        },
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab_size),
    }


def _dense_init(gen, shape, fan_in, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) / math.sqrt(fan_in)


def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cpu") -> dict:
    """Stacked-layer parameter tree with the JAX tree's names, shapes and
    init scales, drawn from ``generator`` (which must live on ``device``).
    The values differ from ``ray_tpu``'s; parity tests convert weights."""
    pd = cfg.param_dtype
    shapes = param_shapes(cfg)
    ls = shapes["layers"]
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Hd = cfg.n_heads, cfg.head_dim

    def dense(shape, fan_in):
        return _dense_init(generator, shape, fan_in, pd, device)

    layers = {
        "attn_norm": torch.ones(ls["attn_norm"], dtype=pd, device=device),
        "wq": dense(ls["wq"], D),
        "wk": dense(ls["wk"], D),
        "wv": dense(ls["wv"], D),
        "wo": dense(ls["wo"], H * Hd),
        "ffn_norm": torch.ones(ls["ffn_norm"], dtype=pd, device=device),
        "w_gate": dense(ls["w_gate"], D),
        "w_up": dense(ls["w_up"], D),
        "w_down": dense(ls["w_down"], F),
    }
    return {
        "embed": dense(shapes["embed"], cfg.vocab_size) * math.sqrt(D),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=pd, device=device),
        "lm_head": dense(shapes["lm_head"], D),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked tree (views, no copies)."""
    return {name: t[i] for name, t in params["layers"].items()}


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict:
    """The whole tree cast once to ``dtype`` (and moved to ``device``): the
    same values the JAX code gets by casting at every matmul."""
    def cast(t):
        return t.detach().to(device=device, dtype=dtype)

    return {
        "embed": cast(params["embed"]),
        "layers": {k: cast(v) for k, v in params["layers"].items()},
        "final_norm": cast(params["final_norm"]),
        "lm_head": cast(params["lm_head"]),
    }


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w.to(x.dtype)


def rope(x, positions, theta):
    """x: [B, S, H, Hd]; positions: [B, S]. Rotates the two halves of the
    head dimension (the JAX code's layout, whatever its docstring says)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def linear(x, w):
    """x [..., D] against a weight whose leading axis is the contraction
    (the JAX einsums' "...d,d..." layout); trailing weight axes are kept."""
    wd = w.to(x.dtype)
    out = x @ wd.reshape(wd.shape[0], -1)
    return out.reshape(*x.shape[:-1], *wd.shape[1:])


def attn_proj(h, lp):
    """h [B, S, D] -> q [B, S, H, Hd], k/v [B, S, KV, Hd]."""
    return linear(h, lp["wq"]), linear(h, lp["wk"]), linear(h, lp["wv"])


def out_proj(o, wo):
    """o [B, S, H, Hd] -> [B, S, D] (einsum "bshk,hkd->bsd")."""
    wd = wo.to(o.dtype)
    return o.reshape(*o.shape[:-2], -1) @ wd.reshape(-1, wd.shape[-1])


def dense_ffn(x, p):
    gate = linear(x, p["w_gate"])
    up = linear(x, p["w_up"])
    return linear(torch.nn.functional.silu(gate) * up, p["w_down"])


def _layer(x, lp, cfg: TransformerConfig, positions, segment_ids=None):
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = attn_proj(h, lp)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = mha_reference(q, k, v, causal=True, segment_ids=segment_ids)
    x = x + out_proj(o, lp["wo"])
    h = rms_norm(x, lp["ffn_norm"])
    return x + dense_ffn(h, lp)


def forward(params: dict, tokens, cfg: TransformerConfig, segment_ids=None, positions=None):
    """tokens [B, S] int -> logits [B, S, vocab] in the activation dtype.

    The plain full-sequence path (einsum attention, no kernel): the oracle
    the serving engine is held against. Unlike the JAX ``forward`` it returns
    the logits alone; there is no MoE aux loss to return."""
    B, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    for i in range(cfg.n_layers):
        x = _layer(x, layer_params(params, i), cfg, positions, segment_ids)
    x = rms_norm(x, params["final_norm"])
    return linear(x, params["lm_head"])


class Transformer(nn.Module):
    """The parameter tree as an ``nn.Module``: stacked layer tensors in a
    ``ParameterDict``, ``forward(tokens)`` the plain path above."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ParameterDict({k: nn.Parameter(v) for k, v in params["layers"].items()})
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def params(self) -> dict:
        """The nested tree (the same tensors, not copies)."""
        return {
            "embed": self.embed,
            "layers": dict(self.layers.items()),
            "final_norm": self.final_norm,
            "lm_head": self.lm_head,
        }

    def forward(self, tokens, segment_ids=None, positions=None):
        return forward(self.params(), tokens, self.cfg, segment_ids, positions)
