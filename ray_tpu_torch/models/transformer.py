"""Decoder-only transformer LM in PyTorch: the forward pieces the serving
engine runs, and the training step.

Counterpart of ``ray_tpu/models/transformer.py``. The parameter tree keeps
that module's names and shapes, layers stacked on a leading ``[L, ...]``
axis, so one set of weights (``ray_tpu_torch.convert``) feeds both packages.
The layer scan becomes a Python loop.

Numerics follow the JAX code, cast for cast: parameters are kept in
``param_dtype`` and cast to the activation ``dtype`` at each use (``.to`` is
a no-op once a caller has cast them, as the engine does at load), RMSNorm
takes its variance in fp32 and multiplies in the activation dtype, and RoPE
rotates the two HALVES of the head dimension.

Training: ``forward_hidden``, the MoE dense dispatch with the Switch aux
loss, remat ("full", and "dots" which saves only the matmuls without batch
dims), the materialised and the chunked cross-entropy, and
``make_train_step`` with AdamW. Attention dispatches on
``attention_impl``: "auto" is the flash kernels (K1 forward, K3/K2
backward) for CUDA tensors and the plain einsum version elsewhere, as the
JAX code picks flash on the TPU; "splash" keeps the JAX splash wrapper's
contract (causal, scale folded into q) on the same kernels. Not carried over: ``attention_block_q/k``
(TPU tile sizes; the CUDA kernels have fixed 64-row tiles), and
``state_logical_axes`` and ``make_pipeline_train_step``, which wait for the
parallelism slice.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.splash import splash_attention


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
    # MoE: n_experts=0 -> dense FFN; else top-k routed experts (expert axis).
    n_experts: int = 0
    expert_top_k: int = 2
    remat: bool = False
    # When remat=True: "full" recomputes the whole layer in the backward;
    # "dots" keeps the outputs of the matmuls without batch dims (the JAX
    # policy dots_with_no_batch_dims_saveable) and recomputes the rest.
    remat_policy: str = "full"
    attention_impl: str = "auto"  # auto | flash | reference | splash (ring | ulysses: later slices)
    # Training loss over sequence chunks of this size, so the full [B, S, V]
    # logits never materialise (0 = off). Needs chunk | (S - 1).
    ce_chunk: int = 0

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
    layers = {
        "attn_norm": (L, D),
        "wq": (L, D, H, Hd),
        "wk": (L, D, KV, Hd),
        "wv": (L, D, KV, Hd),
        "wo": (L, H, Hd, D),
        "ffn_norm": (L, D),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update({
            "router": (L, D, E),
            "w_gate": (L, E, D, F),
            "w_up": (L, E, D, F),
            "w_down": (L, E, F, D),
        })
    else:
        layers.update({"w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)})
    return {
        "embed": (cfg.vocab_size, D),
        "layers": layers,
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab_size),
    }


def _dense_init(gen, shape, fan_in, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) / math.sqrt(fan_in)


def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cpu") -> dict:
    """Stacked-layer parameter tree with the JAX tree's names, shapes and
    init scales (experts included when ``n_experts``), drawn from
    ``generator`` (which must live on ``device``). The values differ from
    ``ray_tpu``'s; parity tests convert weights."""
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
    }
    if cfg.n_experts:
        layers["router"] = dense(ls["router"], D)
    layers.update({
        "w_gate": dense(ls["w_gate"], D),
        "w_up": dense(ls["w_up"], D),
        "w_down": dense(ls["w_down"], F),
    })
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


def leaves(params: dict) -> list:
    """The tree's tensors in a fixed order (embed, layer leaves, final_norm,
    lm_head): what the optimizer steps."""
    return [params["embed"], *params["layers"].values(), params["final_norm"], params["lm_head"]]


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


def _attention(q, k, v, cfg: TransformerConfig, segment_ids=None):
    """Dispatches to the configured attention implementation. q [B, S, H, D],
    k/v [B, S, KV, D]: both implementations take grouped K/V as they are."""
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    if impl == "reference":
        return mha_reference(q, k, v, causal=True, segment_ids=segment_ids)
    if impl == "splash":
        return splash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported yet (ROADMAP.md Queue 1 item 6: parallelism)")
    raise ValueError(f"unknown attention_impl {impl!r} (auto|flash|reference|splash)")


def moe_ffn(x, p, cfg: TransformerConfig):
    """Top-k routed MoE, dense-dispatch formulation: every expert runs on
    every token and a [B, S, E] routing matrix, zero outside each token's
    top k (renormalised), combines them. Returns (out, Switch aux loss)."""
    E, K = cfg.n_experts, cfg.expert_top_k
    dt = x.dtype
    weights = torch.softmax(linear(x, p["router"]).float(), dim=-1)  # [B, S, E]
    top_w, top_idx = torch.topk(weights, K, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    route = (torch.nn.functional.one_hot(top_idx, E).float() * top_w[..., None]).sum(dim=2).to(dt)
    gate = torch.einsum("bsd,edf->ebsf", x, p["w_gate"].to(dt))
    up = torch.einsum("bsd,edf->ebsf", x, p["w_up"].to(dt))
    h = torch.nn.functional.silu(gate) * up
    out = torch.einsum("ebsf,efd->ebsd", h, p["w_down"].to(dt))
    out = torch.einsum("ebsd,bse->bsd", out, route)
    return out, load_balance_loss(weights, top_idx, E)


def load_balance_loss(weights, top_idx, n_experts: int):
    """Switch-transformer aux loss: n_experts * sum over experts of (mean
    router probability) * (share of tokens whose top-1 is that expert)."""
    me = weights.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(top_idx[..., 0], n_experts).float().mean(dim=(0, 1))
    return n_experts * (me * ce).sum()


def _layer(x, lp, cfg: TransformerConfig, positions, segment_ids=None):
    """One decoder block. x: [B, S, D] in cfg.dtype -> (x, MoE aux loss)."""
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = attn_proj(h, lp)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attention(q, k, v, cfg, segment_ids)
    x = x + out_proj(o, lp["wo"])
    h = rms_norm(x, lp["ffn_norm"])
    if cfg.n_experts:
        ffn_out, aux = moe_ffn(h, lp, cfg)
    else:
        ffn_out, aux = dense_ffn(h, lp), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_out, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of aten.mm, the matmuls without
    batch dims (every projection of the layer); recompute everything else,
    the attention kernel and the einsum attention's bmm included."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_matmuls)


def _layer_body(cfg: TransformerConfig):
    """The layer as the forward runs it: plain, or checkpointed per remat."""
    if not cfg.remat:
        return _layer
    if cfg.remat_policy == "full":
        context_fn = noop_context_fn
    elif cfg.remat_policy == "dots":
        context_fn = _dots_contexts
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full|dots)")

    def body(x, lp, cfg, positions, segment_ids):
        return checkpoint(_layer, x, lp, cfg, positions, segment_ids,
                          use_reentrant=False, context_fn=context_fn)

    return body


def forward_hidden(params: dict, tokens, cfg: TransformerConfig, segment_ids=None, positions=None):
    """tokens [B, S] int -> (final-norm hidden states [B, S, D], summed MoE
    aux loss). The shared trunk of ``forward`` and the training loss."""
    B, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    body = _layer_body(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = body(x, layer_params(params, i), cfg, positions, segment_ids)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


def forward(params: dict, tokens, cfg: TransformerConfig, segment_ids=None, positions=None):
    """tokens [B, S] int -> logits [B, S, vocab] in the activation dtype.

    Packed sequences: pass ``segment_ids`` [B, S] and per-segment positions.
    Attention follows ``cfg.attention_impl``; with "reference" this is the
    plain path, the oracle the serving engine is held against. Unlike the
    JAX ``forward`` it returns the logits alone, without the MoE aux loss
    (``forward_hidden`` returns that)."""
    x, _ = forward_hidden(params, tokens, cfg, segment_ids, positions)
    return linear(x, params["lm_head"])


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------

def _nll(logits, targets):
    """Per-position NLL in logsumexp form (no [B, S, V] log_softmax), fp32
    reductions over logits kept in the activation dtype."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return lse - logits.gather(-1, targets[..., None].long())[..., 0].float()


def ce_from_logits(logits, targets, mask=None):
    """Mean NLL over the positions; ``mask`` weights them."""
    nll = _nll(logits, targets)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def _ce_chunk(xc, lm_head, tc, mc):
    return (_nll(xc @ lm_head, tc) * mc).sum(), mc.sum()


def ce_chunked(x, lm_head, targets, mask, chunk: int):
    """Cross-entropy over sequence chunks: each chunk's logits [B, c, V] are
    computed, reduced to (sum nll, count) and dropped; the backward
    recomputes them chunk by chunk, so the [B, S, V] logits never exist.
    Eager PyTorch runs the chunks in order and frees each one's logits
    before the next starts, so the JAX code's optimization barrier between
    chunks (which kept XLA from overlapping them all) has no counterpart."""
    B, S, _ = x.shape
    mask = torch.ones(B, S, dtype=torch.float32, device=x.device) if mask is None else mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        s_i, c_i = checkpoint(_ce_chunk, x[:, sl], lm_head, targets[:, sl], mask[:, sl], use_reentrant=False)
        tot = tot + s_i
        cnt = cnt + c_i
    return tot / cnt.clamp(min=1.0)


def cross_entropy_loss(params: dict, batch: dict, cfg: TransformerConfig):
    """batch: {"tokens": [B, S+1] int, optional "mask" / "segment_ids" /
    "positions" [B, S+1]} -> scalar mean NLL + 0.01 * MoE aux. With
    segment_ids (packed sequences) attention stays within segments and the
    position that predicts across a boundary is not trained."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    segs = batch.get("segment_ids")
    pos = batch.get("positions")
    mask = None if batch.get("mask") is None else batch["mask"][:, 1:].float()
    if segs is not None:
        boundary = (segs[:, 1:] == segs[:, :-1]).float()
        mask = boundary if mask is None else mask * boundary
    S = inputs.shape[1]
    if cfg.ce_chunk and S % cfg.ce_chunk:
        warnings.warn(
            f"ce_chunk={cfg.ce_chunk} does not divide the train seq length {S}; falling back "
            f"to MATERIALIZED logits ([B,S,V] on the device) - a run sized around chunked CE may OOM here",
            stacklevel=2,
        )
    x, aux = forward_hidden(params, inputs, cfg,
                            segment_ids=None if segs is None else segs[:, :-1],
                            positions=None if pos is None else pos[:, :-1])
    if cfg.ce_chunk and S % cfg.ce_chunk == 0:
        loss = ce_chunked(x, params["lm_head"].to(cfg.dtype), targets, mask, cfg.ce_chunk)
    else:
        loss = ce_from_logits(linear(x, params["lm_head"]), targets, mask)
    return loss + 0.01 * aux


def adamw(params):
    """The default optimizer. ``torch.optim.AdamW`` with these settings is the
    update of ``optax.adamw(3e-4, weight_decay=0.01)``: beta 0.9 / 0.999,
    eps 1e-8 added to sqrt of the bias-corrected second moment, and the
    decoupled decay lr * 0.01 * p on every leaf, taken from the parameter
    before the step."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: TransformerConfig, optimizer=None):
    """Returns (init_state, train_step).

    ``optimizer`` maps a list of parameter tensors to a
    ``torch.optim.Optimizer`` (default ``adamw``). ``init_state(generator,
    device=None)`` draws fp32 parameters that require grad and builds the
    optimizer: {"params", "opt", "step"}. ``device=None`` means the GPU (it
    raises when none is visible); pass ``device="cpu"`` for the CPU, with a
    generator on that device. ``train_step(state, batch)`` takes one step and
    returns {"loss", "grad_norm", "step"}; grad_norm is the global L2 norm of
    the gradients before the update (``optax.global_norm``). Unlike the JAX
    step, which returns a new state, it updates the parameters and the
    optimizer state in place."""
    make_opt = optimizer or adamw

    def init_state(generator: torch.Generator, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_state runs on the GPU by default and no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        params = init_params(cfg, generator, device)
        for t in leaves(params):
            t.requires_grad_(True)
        return {"params": params, "opt": make_opt(leaves(params)), "step": 0}

    def train_step(state: dict, batch: dict) -> dict:
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(state["params"], batch, cfg)
        loss.backward()
        grads = [t.grad for t in leaves(state["params"])]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        opt.step()
        state["step"] += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "step": state["step"]}

    return init_state, train_step


class Transformer(nn.Module):
    """The parameter tree as an ``nn.Module``: stacked layer tensors in a
    ``ParameterDict``, ``forward(tokens)`` the functional ``forward``."""

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
