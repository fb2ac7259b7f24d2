"""model_type "mellum": the block of JetBrains' Mellum2 as the port runs it.
Pre-norm RMSNorm (eps 1e-6), grouped-query attention at an explicit
head_dim (q is heads x head_dim wide, not hidden), sliding-window layers
(the key j is seen by the query i when i - window < j <= i) with plain
rotary positions beside full causal layers with YaRN-scaled ones, and in
every layer a top-k routed MoE of SwiGLU experts (an fp32 softmax router,
the top k renormalised, no shared expert); a final norm and an untied head.

Counts follow ``models/mistral.py``'s conventions: real prompt lengths,
valid (query, key) pairs, windowed where the layer is; the MoE counts the
router and the k experts a token passes through.
"""
from __future__ import annotations

import math

from perfbench.metrics._counts import bound_s, causal_pairs
from perfbench.models import mistral

# The published config.json's keys, and the benchmark's own. Any other key
# is refused: it may change the block.
KEYS = frozenset({
    "attention_bias", "head_dim", "hidden_act", "hidden_size", "intermediate_size", "layer_types",
    "mlp_layer_types", "max_position_embeddings", "max_window_layers", "model_type", "moe_intermediate_size",
    "norm_topk_prob", "num_attention_heads", "num_experts", "num_experts_per_tok", "num_hidden_layers",
    "num_key_value_heads", "rms_norm_eps", "rope_parameters", "sliding_window", "tie_word_embeddings",
    "vocab_size", "use_sliding_window", "torch_dtype",
    "source", "reduced", "assumed", "deployment", "param_dtype",
})
EPS = 1e-6  # the port's rms_norm
LAYER_KINDS = {"sliding_attention": "sliding", "full_attention": "full"}
# The router's draw, times init's 1/sqrt(hidden): its logits spread by 2 a
# token, so the top 8 of 64 experts hold about three quarters of the
# softmax and the 8th about 4 % of a token's weight. At init's scale the
# router has learnt nothing (top 8 about 42 %, the 8th 7.5 %), so every
# bfloat16 rounding that swaps the 8th expert for the 9th moves the block
# by a twelfth of its output, and the served logits part from the
# reference's by as much as the float8 control's do.
ROUTER_SCALE = 2.0
YARN_KEYS = ("factor", "original_max_position_embeddings", "beta_fast", "beta_slow", "attention_factor")


def port_kwargs(config: dict) -> dict:
    """The port's TransformerConfig keywords (dtypes as names) for a
    configuration file written in the published config.json's keys."""
    unknown = sorted(set(config) - KEYS)
    if unknown:
        raise ValueError(f"the mellum block cannot express {unknown}")
    if config.get("hidden_act", "silu") != "silu" or config.get("attention_bias", False):
        raise ValueError("the port's block is SwiGLU with bias-free attention")
    if config.get("tie_word_embeddings"):
        raise ValueError("the port's model has an untied head")
    if config.get("rms_norm_eps", EPS) != EPS:
        raise ValueError(f"the port's rms_norm has eps {EPS}")
    L = config["num_hidden_layers"]
    if set(config.get("mlp_layer_types", ["sparse"] * L)) != {"sparse"} or not config.get("norm_topk_prob", True):
        raise ValueError("the port's MoE layer is sparse in every layer with the top k renormalised")
    kinds = config["layer_types"]
    if len(kinds) != L or set(kinds) - set(LAYER_KINDS):
        raise ValueError(f"layer_types must give {sorted(LAYER_KINDS)} for each of the {L} layers")
    window = config["sliding_window"] if config.get("use_sliding_window", True) else None
    if "sliding_attention" in kinds and not window:
        raise ValueError("sliding layers need a sliding_window")
    if config.get("max_window_layers", 0) != 0:
        raise ValueError("max_window_layers other than 0 would turn layer_types' sliding layers full")
    rp = config["rope_parameters"]
    sliding, full = rp.get("sliding_attention", {}), rp.get("full_attention", {})
    if sliding.get("rope_type", "default") != "default" or set(sliding) - {"rope_type", "rope_theta"}:
        raise ValueError("the sliding layers' rotary positions must be plain")
    if full.get("rope_type") != "yarn" or set(full) - {"rope_type", "rope_theta", *YARN_KEYS}:
        raise ValueError("the full layers' rotary positions must be YaRN's")
    theta = float(sliding.get("rope_theta", full["rope_theta"]))
    return dict(
        vocab_size=config["vocab_size"], d_model=config["hidden_size"], n_layers=L,
        n_heads=config["num_attention_heads"], n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["moe_intermediate_size"],
        max_seq_len=config["max_position_embeddings"], rope_theta=theta,
        n_experts=config["num_experts"], expert_top_k=config["num_experts_per_tok"],
        layer_types=tuple(LAYER_KINDS[k] for k in kinds), sliding_window=int(window or 0),
        rope_scaling={"rope_type": "yarn", "rope_theta": float(full["rope_theta"]),
                      **{k: full[k] for k in YARN_KEYS if k in full}},
        dtype=config.get("torch_dtype", "bfloat16"), param_dtype=config.get("param_dtype", "float32"),
    )


def dims(m: dict):
    """(L, D, H, KV, Hd, F, V) of a TransformerConfig keyword dict; F is an
    expert's width."""
    H = m["n_heads"]
    return m["n_layers"], m["d_model"], H, m["n_kv_heads"] or H, m["head_dim"], m["d_ff"], m["vocab_size"]


def windows(m: dict) -> list:
    """Each layer's window in keys, 0 for a full layer."""
    return [m["sliding_window"] if k == "sliding" else 0 for k in m["layer_types"]]


def leaves(m: dict) -> list:
    """The draw order of the port's tree at the scales of its init_params,
    but for the router, drawn ROUTER_SCALE times wider."""
    L, D, H, KV, Hd, F, V = dims(m)
    E, proj = m["n_experts"], 1.0 / math.sqrt(D)
    return [
        ("layers.attn_norm", (L, D), None), ("layers.wq", (L, D, H, Hd), proj),
        ("layers.wk", (L, D, KV, Hd), proj), ("layers.wv", (L, D, KV, Hd), proj),
        ("layers.wo", (L, H, Hd, D), 1.0 / math.sqrt(H * Hd)), ("layers.ffn_norm", (L, D), None),
        ("layers.router", (L, D, E), ROUTER_SCALE * proj), ("layers.w_gate", (L, E, D, F), proj),
        ("layers.w_up", (L, E, D, F), proj), ("layers.w_down", (L, E, F, D), 1.0 / math.sqrt(F)),
        ("embed", (V, D), math.sqrt(D / V)), ("final_norm", (D,), None), ("lm_head", (D, V), proj),
    ]


def kv_bytes_per_token(m: dict, itemsize: int = 2) -> int:
    """K and V of one token over all layers in the served type."""
    L, _, _, KV, Hd, _, _ = dims(m)
    return L * 2 * KV * Hd * itemsize


# -- the model's FLOPs (metrics/_counts.py) -----------------------------------

def layer_matmul_params(m: dict) -> int:
    """Weights of one layer a token passes through in matrix products: wq,
    wk, wv, wo, the router and its top-k experts' three SwiGLU matrices."""
    _, D, H, KV, Hd, F, _ = dims(m)
    return 2 * D * H * Hd + 2 * D * KV * Hd + D * m["n_experts"] + m["expert_top_k"] * 3 * D * F


def matmul_params(m: dict) -> int:
    return m["n_layers"] * layer_matmul_params(m)


head_params = mistral.head_params


def window_pairs(n: int, window: int) -> int:
    """Valid (query, key) pairs of one sequence of n tokens, causal, within
    ``window`` keys of each query (0: the whole causal context)."""
    if not window or n <= window:
        return causal_pairs(n)
    return causal_pairs(window) + (n - window) * window


def attn_fwd_flops(m: dict, n: int) -> float:
    """Attention of one sequence of n tokens, all layers, forward, each
    layer over its window."""
    _, _, H, _, Hd, _, _ = dims(m)
    return 4.0 * H * Hd * sum(window_pairs(n, w) for w in windows(m))


def decode_attn_flops(m: dict, ctx: int) -> float:
    """One token attending to ``ctx`` keys (itself included), all layers,
    each over at most its window."""
    _, _, H, _, Hd, _, _ = dims(m)
    return 4.0 * H * Hd * sum(min(ctx, w) if w else ctx for w in windows(m))


# -- kernels (one launch = one layer) -----------------------------------------

def k1_bound(m: dict, lengths):
    """(bound seconds, launches) of K1 over one prefill group, a launch a
    layer, each layer's operations over its window."""
    _, _, h, kv, d, _, _ = dims(m)
    total = 0.0
    nbytes = mistral.k1_cost(h, kv, d, lengths)[1]
    for w in windows(m):
        total += bound_s(4.0 * d * h * sum(window_pairs(int(P), w) for P in lengths), nbytes)
    return total, m["n_layers"]


def k4_bound(m: dict, steps, page_size: int):
    """(bound seconds, launches) of K4 over one decode block, a launch a
    layer and token step: each layer reads the keys of its window."""
    _, _, h, kv, d, _, _ = dims(m)
    total = 0.0
    for w in windows(m):
        for ctx in steps:
            seen = [min(c, w) if w else c for c in ctx]
            total += bound_s(*mistral.k4_cost(h, kv, d, seen, page_size))
    return total, m["n_layers"] * len(steps)


def train_attn_bounds(m: dict, B: int, S: int) -> dict:
    raise NotImplementedError("the mellum block is not trained: K3/K2 take no window")


def moe_bound(m: dict, rows: int) -> float:
    """Bound seconds of one layer's routed experts (K6) over ``rows``
    token-expert rows. FLOPs: 2 rows x 3 x hidden x width. Bytes: the
    weights of min(E, rows) experts, each read once, and the rows in and
    out (hidden wide, bf16). Exact when every expert receives a row; at the
    cell's 512 or more rows a launch in which some expert receives none
    reads less than counted (each of the 64 experts misses all of 64
    tokens' 8 picks with probability 0.875^64, about 2e-4, under uniform
    routing)."""
    _, D, _, _, _, F, _ = dims(m)
    experts = min(m["n_experts"], rows)
    return bound_s(2.0 * rows * 3 * D * F, experts * 3 * D * F * 2 + 2 * rows * D * 2)
