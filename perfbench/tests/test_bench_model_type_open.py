"""A second model type, added from new files alone: a tiny top-k MoE
(``model_type`` "toy_moe", the port's ``moe_ffn`` block) written into a
temporary directory with its configuration, traffic, limits and plain
reference, and found by the same lookup as the mistral cells. Its cell is
driven on the CPU through ``load_cell``, the weights, the counts, the
reference against the port, and a whole run of the harness (``run_cell``),
sound and with a fault planted."""
import contextlib
import json
import math
import time

import pytest
import torch

from perfbench import faults, harness, weights
from perfbench.entries import _common
from perfbench.metrics import _counts
from perfbench.run import run_cell

MODEL = '''"""model_type "toy_moe": the mistral block with every feed-forward a top-k
routed MoE (softmax router, the top k renormalised, no shared expert)."""
import math

from perfbench.models import mistral

EXPERT_KEYS = ("num_experts", "num_experts_per_tok")
dims = mistral.dims
head_params = mistral.head_params
attn_fwd_flops, decode_attn_flops = mistral.attn_fwd_flops, mistral.decode_attn_flops
k1_bound, k4_bound, train_attn_bounds = mistral.k1_bound, mistral.k4_bound, mistral.train_attn_bounds


def port_kwargs(config):
    m = mistral.port_kwargs({k: v for k, v in config.items() if k not in EXPERT_KEYS})
    return {**m, "n_experts": int(config["num_experts"]), "expert_top_k": int(config["num_experts_per_tok"])}


def leaves(m):
    L, D, H, KV, Hd, F, V = dims(m)
    E, proj = m["n_experts"], 1.0 / math.sqrt(D)
    return [("layers.attn_norm", (L, D), None), ("layers.wq", (L, D, H, Hd), proj),
            ("layers.wk", (L, D, KV, Hd), proj), ("layers.wv", (L, D, KV, Hd), proj),
            ("layers.wo", (L, H, Hd, D), 1.0 / math.sqrt(H * Hd)), ("layers.ffn_norm", (L, D), None),
            ("layers.router", (L, D, E), proj), ("layers.w_gate", (L, E, D, F), proj),
            ("layers.w_up", (L, E, D, F), proj), ("layers.w_down", (L, E, F, D), 1.0 / math.sqrt(F)),
            ("embed", (V, D), math.sqrt(D / V)), ("final_norm", (D,), None), ("lm_head", (D, V), proj)]


def matmul_params(m):
    """The active weights: attention, the router, and k experts' SwiGLU."""
    L, D, H, KV, Hd, F, V = dims(m)
    return L * (2 * D * H * Hd + 2 * D * KV * Hd + D * m["n_experts"] + m["expert_top_k"] * 3 * D * F)
'''

REFERENCE = '''"""The plain reference of model_type "toy_moe": every expert on every
token, each weighted by its renormalised top-k router probability, and the
Switch load-balance loss (0.01 of it, summed over layers) in the loss."""
import torch

from perfbench.reference import plain
from perfbench.reference.plain import attention, mm, rms_norm, rope


def layer(x, lp, m, fp8=False):
    """One block on x [R, S, D]: (x, this layer's load-balance loss)."""
    theta = m["rope_theta"]
    h = rms_norm(x, lp["attn_norm"])
    o = attention(rope(mm(h, lp["wq"], fp8), theta), rope(mm(h, lp["wk"], fp8), theta), mm(h, lp["wv"], fp8))
    x = x + mm(o.reshape(*o.shape[:2], -1), lp["wo"].reshape(-1, lp["wo"].shape[-1]), fp8)
    h = rms_norm(x, lp["ffn_norm"])
    E, K = m["n_experts"], m["expert_top_k"]
    probs = torch.softmax(mm(h, lp["router"], fp8), dim=-1)
    top_w, top_idx = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(E):
        w_e = (top_w * (top_idx == e)).sum(dim=-1, keepdim=True)
        y = mm(torch.nn.functional.silu(mm(h, lp["w_gate"][e], fp8)) * mm(h, lp["w_up"][e], fp8), lp["w_down"][e], fp8)
        out = out + w_e * y
    top1 = torch.nn.functional.one_hot(top_idx[..., 0], E).float()
    return x + out, E * (probs.mean(dim=(0, 1)) * top1.mean(dim=(0, 1))).sum()


def served_gaps(params, m, seqs, control=False):
    return plain.served_gaps(params, lambda x, lp, fp8: layer(x, lp, m, fp8)[0], seqs, control)


def train_steps(params0, m, batches, rows, fp8=False):
    """``rows`` covers the whole batch: the load-balance loss is of the batch."""
    def loss_sum(p, tokens, fp8):
        aux = []

        def block(x, lp, fp8):
            x, a = layer(x, lp, m, fp8)
            aux.append(a)
            return x

        nll = plain.nll_sum(p, tokens, block, fp8)
        return nll + 0.01 * sum(aux) * tokens.shape[0] * (tokens.shape[1] - 1)

    return plain.train_steps(params0, loss_sum, batches, rows, fp8)
'''

CONFIG = {"source": "https://arxiv.org/abs/2101.03961", "model_type": "toy_moe", "hidden_act": "silu",
          "hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256, "max_position_embeddings": 64,
          "rope_theta": 10000.0, "rms_norm_eps": 1e-06, "sliding_window": None, "tie_word_embeddings": False,
          "torch_dtype": "float32", "param_dtype": "float32", "remat": "dots", "num_experts": 8,
          "num_experts_per_tok": 2, "reduced": {}}
TRAFFIC = {"entry": "train_step", "batch": 4, "seq": 32, "ce_chunk": 0, "checked_steps": 3, "reference_rows": 4,
           "trace": {"start_frac": 0.4, "seconds": 1.0}}
CELL = "train.toy-moe.s32"


@pytest.fixture
def toy(tmp_path):
    """The new model type's files under a benchmark directory of their own,
    and a manifest naming its cell; nothing of perfbench/ is written."""
    root = tmp_path / "perfbench"
    for sub in ("models", "reference", "configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True)
    (root / "models" / "toy_moe.py").write_text(MODEL)
    (root / "reference" / "toy_moe.py").write_text(REFERENCE)
    (root / "configs" / "toy-moe.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "toy_pretrain.json").write_text(json.dumps(TRAFFIC))
    (root / "limits" / f"{CELL}.json").write_text((harness.HERE / "limits" / "train.lm250m.s2048.json").read_text())
    real = harness.manifest()
    metrics = lambda kind, names: [{**m, "workloads": [CELL]} for m in real[kind] if m["name"] in names]  # noqa: E731
    man = {"configs": [{"name": "toy-moe", "source": CONFIG["source"], "file": "perfbench/configs/toy-moe.json",
                        "reduced": [], "why": "a top-k MoE block"}],
           "workloads": [{"name": CELL, "config": "toy-moe", "traffic": "toy_pretrain", "chips": 1, "why": "MoE"}],
           "end_to_end": metrics("end_to_end", ("train_tok_s", "setup_s")),
           "per_layer": metrics("per_layer", ("train.mfu", "attn_roofline.train", "device.idle.train"))}
    cell = harness.load_cell(CELL, man, root=root)
    assert not (harness.HERE / "models" / "toy_moe.py").exists()
    return cell


def _port_cfg(m):
    from ray_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**_common.model_config(dict(m, remat=False)), attention_impl="reference")


def test_the_cell_loads_with_the_new_types_keywords_weights_and_counts(toy):
    from ray_tpu_torch.models.transformer import param_shapes

    m = toy.model_kwargs()
    assert (m["n_experts"], m["expert_top_k"], m["d_model"]) == (8, 2, 64)
    params = weights.make_params(toy.model().leaves(m), 11, torch.float32, "cpu")
    shapes = {n: tuple(t.shape) for n, t in weights.leaf_items(params)}
    assert shapes == {n: tuple(s) for n, s in weights.leaf_items(param_shapes(_port_cfg(m)))}
    again = weights.make_params(toy.model().leaves(m), 11, torch.float32, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(weights.leaf_items(params), weights.leaf_items(again)))
    # Active weights a token passes through: attention 2*64*64 + 2*64*32, router 64*8, 2 experts of 3*64*32.
    layer = 2 * 64 * 64 + 2 * 64 * 32 + 64 * 8 + 2 * 3 * 64 * 32
    attn = 4.0 * 64 * (32 * 33 // 2) * 2
    assert _counts.train_step_flops(toy.model(), m, 4, 32) == 6.0 * (2 * layer + 64 * 256) * 4 * 32 + 3.0 * attn * 4


def test_the_new_reference_equals_the_ports_moe_forward_and_train_step(toy):
    from ray_tpu_torch.models.transformer import forward, make_train_step

    m, ref = toy.model_kwargs(), toy.reference()
    cfg = _port_cfg(m)
    mine = weights.make_params(toy.model().leaves(m), 5, torch.float32, "cpu")
    tokens = torch.randint(0, 256, (1, 24), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port, _ = forward(mine, tokens, cfg)
        x = mine["embed"][tokens]
        for i in range(m["n_layers"]):
            x = ref.layer(x, {k: v[i] for k, v in mine["layers"].items()}, m)[0]
        logits = ref.mm(ref.rms_norm(x, mine["final_norm"]), mine["lm_head"])
    torch.testing.assert_close(port, logits, rtol=1e-4, atol=1e-4)

    init_state, train_step = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    prog = dict(weights.leaf_items(state["params"]))
    with torch.no_grad():
        for n, src in weights.leaf_items(mine):
            prog[n].copy_(src)
    g = torch.Generator().manual_seed(9)
    batches = [torch.randint(0, 256, (4, 17), generator=g) for _ in range(2)]
    losses = [float(train_step(state, {"tokens": b})["loss"]) for b in batches]
    expected = ref.train_steps(mine, m, batches, rows=4)
    assert losses == pytest.approx(expected["losses"], rel=1e-5)
    start = dict(weights.leaf_items(mine))
    for n in prog:
        change = float(torch.linalg.vector_norm(prog[n].detach() - start[n]))
        assert change == pytest.approx(expected["change_norms"][n], rel=1e-3, abs=1e-7), n


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_a_whole_run_of_the_new_cell_on_the_cpu(toy, fault):
    """The training entry runs on the CPU (the reference attention in place
    of K1-K3); the kernels' bounds and the card are left to a chip run."""
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        result = run_cell(toy, 2**31 + 99, 1.0, False, "cpu", t_start=time.perf_counter())
    assert result["correct"] is (fault is None), result["compared"]
    assert set(result["metrics"]) == {"train_tok_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert math.isfinite(result["metrics"]["train_tok_s"]["value"])
