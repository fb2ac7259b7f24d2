"""The per-model-type dispatch: each configuration's ``model_type`` picks
``models/<type>.py`` and ``reference/<type>.py``. For the existing
configurations the dispatch draws the same weights, bit for bit, and counts
the same FLOPs and bytes, to the last digit, as the dense-only functions it
replaced (frozen below); configurations the mistral block cannot express
are refused, not built dense."""
import math

import pytest
import torch

from perfbench import harness, weights
from perfbench.metrics import _counts
from perfbench.tests.conftest import TINY_MODEL, TINY_TRAIN

MAN = harness.manifest()
CONFIGS = [c["name"] for c in MAN["configs"]]


def _cell_of(config_name):
    w = next(w for w in MAN["workloads"] if w["config"] == config_name)
    return harness.load_cell(w["name"], MAN)


# -- the dense-only functions as they were before the dispatch (frozen) -------

def frozen_dims(m):
    D, H = m["d_model"], m["n_heads"]
    return m["n_layers"], D, H, m["n_kv_heads"] or H, D // H, m["d_ff"], m["vocab_size"]


_FROZEN_LEAVES = (("attn_norm", None), ("wq", "D"), ("wk", "D"), ("wv", "D"), ("wo", "HHd"),
                  ("ffn_norm", None), ("w_gate", "D"), ("w_up", "D"), ("w_down", "F"))


def frozen_make_params(m, seed, dtype, device):
    L, D, H, KV, Hd, F, V = frozen_dims(m)
    fan = {"D": D, "HHd": H * Hd, "F": F}
    shp = {"attn_norm": (L, D), "wq": (L, D, H, Hd), "wk": (L, D, KV, Hd), "wv": (L, D, KV, Hd),
           "wo": (L, H, Hd, D), "ffn_norm": (L, D), "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}
    g = torch.Generator(device=device)
    g.manual_seed(harness.seed_for(seed, "weights"))

    def draw(shape, std):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=g)

    layers = {}
    for name, fan_key in _FROZEN_LEAVES:
        s = shp[name]
        layers[name] = (torch.ones(s, dtype=dtype, device=device) if fan_key is None
                        else draw(s, 1.0 / math.sqrt(fan[fan_key])))
    embed = draw((V, D), math.sqrt(D / V))
    final_norm = torch.ones((D,), dtype=dtype, device=device)
    lm_head = draw((D, V), 1.0 / math.sqrt(D))
    return {"embed": embed, "layers": layers, "final_norm": final_norm, "lm_head": lm_head}


def frozen_layer_matmul_params(m):
    _, D, H, KV, Hd, F, _ = frozen_dims(m)
    return D * H * Hd + 2 * D * KV * Hd + H * Hd * D + 3 * D * F


def frozen_head_params(m):
    _, D, *_, V = frozen_dims(m)
    return D * V


def frozen_causal_pairs(n):
    return n * (n + 1) // 2


def frozen_attn_fwd_flops(m, n):
    L, _, H, _, Hd, _, _ = frozen_dims(m)
    return 4.0 * H * Hd * frozen_causal_pairs(n) * L


def frozen_prefill_flops(m, lengths):
    L = m["n_layers"]
    return float(sum(2.0 * L * frozen_layer_matmul_params(m) * P + 2.0 * frozen_head_params(m)
                     + frozen_attn_fwd_flops(m, P) for P in lengths))


def frozen_decode_token_flops(m, ctx):
    L, _, H, _, Hd, _, _ = frozen_dims(m)
    return 2.0 * (L * frozen_layer_matmul_params(m) + frozen_head_params(m)) + 4.0 * H * Hd * ctx * L


def frozen_train_step_flops(m, B, S):
    L = m["n_layers"]
    return 6.0 * (L * frozen_layer_matmul_params(m) + frozen_head_params(m)) * B * S \
        + 3.0 * frozen_attn_fwd_flops(m, S) * B


def frozen_k1_cost(h, kv, d, lengths, seg=True):
    T = int(sum(lengths))
    flops = 4.0 * d * h * sum(frozen_causal_pairs(int(P)) for P in lengths)
    nbytes = 2 * (2 * T * h * d + 2 * T * kv * d) + 4 * T * h + (4 * T if seg else 0)
    return flops, nbytes


def frozen_k3_cost(B, S, h, kv, d):
    pairs = B * h * frozen_causal_pairs(S)
    io = 2 * (B * S * h * d * 2 + B * S * kv * d * 2) + 2 * 4 * B * h * S
    return 6.0 * d * pairs, io + 2 * B * S * h * d


def frozen_k2_cost(B, S, h, kv, d):
    pairs = B * h * frozen_causal_pairs(S)
    io = 2 * (B * S * h * d * 2 + B * S * kv * d * 2) + 2 * 4 * B * h * S
    return 8.0 * d * pairs, io + 2 * 2 * B * S * kv * d


def frozen_k4_cost(h, kv, d, ctx_lengths, page_size):
    tokens = int(sum(ctx_lengths))
    B = len(ctx_lengths)
    pages = sum(math.ceil(n / page_size) for n in ctx_lengths)
    return 4.0 * h * d * tokens, 2 * tokens * kv * d * 2 + 2 * B * h * d * 2 + 4 * B + 4 * pages


# -- parity --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config", CONFIGS)
def test_weights_equal_the_frozen_dense_draw_bit_for_bit(config, dtype):
    cell = _cell_of(config)
    cell.config.update(TINY_MODEL)
    m = cell.model_kwargs()
    for seed in (1, 2**31 + 17, 987654321987):
        new = dict(weights.leaf_items(weights.make_params(cell.model().leaves(m), seed, dtype, "cpu")))
        old = dict(weights.leaf_items(frozen_make_params(m, seed, dtype, "cpu")))
        assert sorted(new) == sorted(old)
        for name, t in old.items():
            assert new[name].dtype == t.dtype and torch.equal(new[name], t), (config, seed, name)


LENGTHS = ([1], [7, 512, 1023, 2048], [256] * 16, [4096] * 8, list(range(1, 300, 7)))


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_counts_equal_the_frozen_dense_counts(config, tiny):
    cell = _cell_of(config)
    if tiny:
        cell.config.update(TINY_TRAIN)
    m, model = cell.model_kwargs(), cell.model()
    L, _, h, kv, d, _, _ = frozen_dims(m)
    assert model.dims(m) == frozen_dims(m)
    for lens in LENGTHS:
        assert _counts.prefill_flops(model, m, lens) == frozen_prefill_flops(m, lens)
        assert model.k1_cost(h, kv, d, lens) == frozen_k1_cost(h, kv, d, lens)
        assert model.k1_cost(h, kv, d, lens, seg=False) == frozen_k1_cost(h, kv, d, lens, seg=False)
        assert model.k1_bound(m, lens) == (L * _counts.bound_s(*frozen_k1_cost(h, kv, d, lens)), L)
        for ps in (16, 128):
            assert model.k4_cost(h, kv, d, lens, ps) == frozen_k4_cost(h, kv, d, lens, ps)
            steps = [[n + j + 1 for n in lens] for j in range(8)]
            old = sum(_counts.bound_s(*frozen_k4_cost(h, kv, d, ctx, ps)) for ctx in steps)
            assert model.k4_bound(m, steps, ps) == (L * old, L * 8)
    for ctx in (1, 17, 2048, 2560, 4097):
        assert _counts.decode_token_flops(model, m, ctx) == frozen_decode_token_flops(m, ctx)
    for B, S in ((16, 2048), (8, 4096), (4, 33), (1, 1)):
        assert _counts.train_step_flops(model, m, B, S) == frozen_train_step_flops(m, B, S)
        assert model.k3_cost(B, S, h, kv, d) == frozen_k3_cost(B, S, h, kv, d)
        assert model.k2_cost(B, S, h, kv, d) == frozen_k2_cost(B, S, h, kv, d)
        assert model.train_attn_bounds(m, B, S) == {
            "flash_fwd_kernel": _counts.bound_s(*frozen_k1_cost(h, kv, d, [S] * B, seg=False)),
            "flash_bwd_dq_kernel": _counts.bound_s(*frozen_k3_cost(B, S, h, kv, d)),
            "flash_bwd_dkv_kernel": _counts.bound_s(*frozen_k2_cost(B, S, h, kv, d))}


# -- refusals --------------------------------------------------------------------

def test_a_model_type_without_a_module_names_the_file_to_add():
    cell = _cell_of("lm-250m")
    cell.config["model_type"] = "mellum"
    with pytest.raises(FileNotFoundError, match="perfbench/models/mellum.py"):
        cell.model_kwargs()
    with pytest.raises(FileNotFoundError, match="perfbench/reference/mellum.py"):
        cell.reference()
    del cell.config["model_type"]
    with pytest.raises(ValueError, match="no model_type"):
        cell.model()


@pytest.mark.parametrize("extra", [
    {"num_experts": 64}, {"num_local_experts": 8}, {"num_experts_per_tok": 8},
    {"layer_types": ["sliding_attention", "full_attention"]}, {"sliding_window": 4096},
    {"head_dim": 128}, {"rope_scaling": {"type": "yarn", "factor": 16.0}}, {"rms_norm_eps": 1e-5},
    {"hidden_act": "gelu"}, {"tie_word_embeddings": True},
])
def test_the_mistral_module_refuses_what_it_cannot_express(extra):
    cell = _cell_of("lm-250m")  # head_dim 64 = 1024 / 16
    cell.config.update(extra)
    with pytest.raises(ValueError):
        cell.model_kwargs()


def test_the_mistral_module_takes_every_configuration_of_the_manifest():
    for name in CONFIGS:
        m = _cell_of(name).model_kwargs()
        assert "n_experts" not in m and m["d_model"] // m["n_heads"] == harness.load_json(
            harness.REPO / next(c["file"] for c in MAN["configs"] if c["name"] == name))["head_dim"]
