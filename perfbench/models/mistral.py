"""model_type "mistral": the block of the Mistral 7B paper as the port runs
it. Pre-norm RMSNorm (eps fixed at 1e-6), rotary positions, grouped-query
causal attention over the whole context, a SwiGLU feed-forward, a final norm
and an untied head; head_dim is hidden_size / num_attention_heads.

The kernel counts are those of PERF.md's kernel table (``chip_smoke.py``'s
``k1_cost``/``causal_pairs``, its K3/K2 ``bound`` arguments and ``_time_k4``'s
bytes), copied here so the benchmark owns them; they count what the inputs
need (real prompt lengths, valid causal pairs), not padded buffers.
"""
from __future__ import annotations

import math

from perfbench.metrics._counts import bound_s, causal_pairs

# The published config.json's keys, and the benchmark's own (source, the
# cut, the trained types). Any other key is refused: it may change the block.
KEYS = frozenset({
    "architectures", "attention_dropout", "bos_token_id", "eos_token_id", "head_dim", "hidden_act",
    "hidden_size", "initializer_range", "intermediate_size", "max_position_embeddings", "model_type",
    "num_attention_heads", "num_hidden_layers", "num_key_value_heads", "rms_norm_eps", "rope_theta",
    "sliding_window", "tie_word_embeddings", "torch_dtype", "transformers_version", "use_cache", "vocab_size",
    "source", "reduced", "assumed", "deployment", "param_dtype", "remat",
})
EPS = 1e-6  # the port's rms_norm


def port_kwargs(config: dict) -> dict:
    """The port's TransformerConfig keywords (dtypes as names) for a
    configuration file written in the published config.json's keys."""
    unknown = sorted(set(config) - KEYS)
    if unknown:
        raise ValueError(f"the mistral block cannot express {unknown} (experts, layer types and rope scaling "
                         "need a model type of their own)")
    hidden, heads = config["hidden_size"], config["num_attention_heads"]
    if config.get("head_dim", hidden // heads) * heads != hidden:
        raise ValueError("the port derives head_dim as hidden_size / num_attention_heads")
    if config.get("tie_word_embeddings"):
        raise ValueError("the port's model has an untied head")
    if config.get("hidden_act", "silu") != "silu" or config.get("sliding_window") is not None:
        raise ValueError("the port's block is SwiGLU with full causal attention")
    if config.get("rms_norm_eps", EPS) != EPS or config.get("attention_dropout", 0.0) != 0.0:
        raise ValueError(f"the port's rms_norm has eps {EPS} and its attention no dropout")
    remat = config.get("remat")
    return dict(
        vocab_size=config["vocab_size"], d_model=hidden, n_layers=config["num_hidden_layers"],
        n_heads=heads, n_kv_heads=config["num_key_value_heads"], d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"], rope_theta=float(config["rope_theta"]),
        dtype=config.get("torch_dtype", "bfloat16"), param_dtype=config.get("param_dtype", "float32"),
        remat=bool(remat), remat_policy=remat or "full",
    )


def dims(m: dict):
    """(L, D, H, KV, Hd, F, V) of a TransformerConfig keyword dict."""
    D, H = m["d_model"], m["n_heads"]
    return m["n_layers"], D, H, m["n_kv_heads"] or H, D // H, m["d_ff"], m["vocab_size"]


def leaves(m: dict) -> list:
    """The draw order of the port's tree (layers stacked on [L]) at the scales
    of its init_params: normal / sqrt(fan_in) for the projections,
    sqrt(D / V) for the embedding, ones for the norms."""
    L, D, H, KV, Hd, F, V = dims(m)
    proj = 1.0 / math.sqrt(D)
    return [
        ("layers.attn_norm", (L, D), None), ("layers.wq", (L, D, H, Hd), proj),
        ("layers.wk", (L, D, KV, Hd), proj), ("layers.wv", (L, D, KV, Hd), proj),
        ("layers.wo", (L, H, Hd, D), 1.0 / math.sqrt(H * Hd)), ("layers.ffn_norm", (L, D), None),
        ("layers.w_gate", (L, D, F), proj), ("layers.w_up", (L, D, F), proj),
        ("layers.w_down", (L, F, D), 1.0 / math.sqrt(F)),
        ("embed", (V, D), math.sqrt(D / V)), ("final_norm", (D,), None), ("lm_head", (D, V), proj),
    ]


# -- the model's FLOPs (metrics/_counts.py) -----------------------------------

def layer_matmul_params(m: dict) -> int:
    """Weights of one layer that enter matrix products: wq, wk, wv, wo and
    the three SwiGLU matrices."""
    _, D, H, KV, Hd, F, _ = dims(m)
    return D * H * Hd + 2 * D * KV * Hd + H * Hd * D + 3 * D * F


def matmul_params(m: dict) -> int:
    return m["n_layers"] * layer_matmul_params(m)


def head_params(m: dict) -> int:
    _, D, *_, V = dims(m)
    return D * V


def attn_fwd_flops(m: dict, n: int) -> float:
    """Causal attention of one sequence of n tokens, all layers, forward."""
    L, _, H, _, Hd, _, _ = dims(m)
    return 4.0 * H * Hd * causal_pairs(n) * L


def decode_attn_flops(m: dict, ctx: int) -> float:
    """One token attending to ``ctx`` keys (itself included), all layers."""
    L, _, H, _, Hd, _, _ = dims(m)
    return 4.0 * H * Hd * ctx * L


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


def k1_bound(m: dict, lengths):
    """(bound seconds, launches) of K1 over one prefill group, a launch a layer."""
    L, _, h, kv, d, _, _ = dims(m)
    return L * bound_s(*k1_cost(h, kv, d, lengths)), L


def k4_bound(m: dict, steps, page_size: int):
    """(bound seconds, launches) of K4 over one decode block, a launch a
    layer and token step."""
    L, _, h, kv, d, _, _ = dims(m)
    return L * sum(bound_s(*k4_cost(h, kv, d, ctx, page_size)) for ctx in steps), L * len(steps)


def train_attn_bounds(m: dict, B: int, S: int) -> dict:
    """Bound of one launch of each attention kernel at this step's shape."""
    _, _, h, kv, d, _, _ = dims(m)
    return {"flash_fwd_kernel": bound_s(*k1_cost(h, kv, d, [S] * B, seg=False)),
            "flash_bwd_dq_kernel": bound_s(*k3_cost(B, S, h, kv, d)),
            "flash_bwd_dkv_kernel": bound_s(*k2_cost(B, S, h, kv, d))}
