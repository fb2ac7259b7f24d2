"""The plain reference, found through the cells' model type
(``reference/mistral.py``), against the port at a tiny size on the CPU, both
in float32: the same logits, and the same losses, gradients and AdamW steps."""
import dataclasses

import pytest
import torch

from perfbench import weights
from perfbench.entries import _common
from perfbench.reference import plain


def _port_cfg(cell, **kw):
    from ray_tpu_torch.models.transformer import TransformerConfig

    m = dict(cell.model_kwargs(), dtype="float32", param_dtype="float32", remat=False)
    return TransformerConfig(**_common.model_config(m), attention_impl="reference", **kw), m


def _ref_logits(ref, params, m, tokens):
    x = params["embed"][tokens][None]
    for i in range(m["n_layers"]):
        x = ref.layer(x, {k: v[i] for k, v in params["layers"].items()}, m)
    return plain.mm(plain.rms_norm(x, params["final_norm"]), params["lm_head"])[0]


def _params(cell, m, seed):
    return weights.make_params(cell.model().leaves(m), seed, torch.float32, "cpu")


def test_reference_logits_equal_the_ports_forward(tiny):
    from ray_tpu_torch.models.transformer import forward

    cell = tiny("serve.mistral7b.rag")
    cfg, m = _port_cfg(cell)
    params = _params(cell, m, 7)
    tokens = torch.randint(0, m["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port, _ = forward(params, tokens, cfg)
        ref = _ref_logits(cell.reference(), params, m, tokens[0])
    torch.testing.assert_close(port[0], ref, rtol=1e-4, atol=1e-4)


def test_served_gap_is_zero_for_the_references_own_greedy_tokens(tiny):
    cell = tiny("serve.mistral7b.rag")
    _, m = _port_cfg(cell)
    ref = cell.reference()
    params = _params(cell, m, 3)
    prompt = list(range(5, 30))
    seq, served = list(prompt), []
    with torch.no_grad():
        for _ in range(6):
            tok = int(_ref_logits(ref, params, m, torch.tensor(seq))[-1].argmax())
            served.append(tok)
            seq.append(tok)
    rec = ref.served_gaps(params, m, [(prompt, served)], control=True)[0]
    assert rec["gap"] == 0.0 and rec["tokens"] == 6 and rec["control_gap"] >= 0.0
    wrong = [(t + 1) % m["vocab_size"] for t in served]
    assert ref.served_gaps(params, m, [(prompt, wrong)])[0]["gap"] > 0.0


def test_reference_training_equals_the_ports_train_step(tiny):
    from ray_tpu_torch.models.transformer import make_train_step

    cell = tiny("train.lm250m.s2048")
    cfg, m = _port_cfg(cell)
    init_state, train_step = make_train_step(dataclasses.replace(cfg))
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    mine = _params(cell, m, 5)
    prog = dict(weights.leaf_items(state["params"]))
    with torch.no_grad():
        for n, src in weights.leaf_items(mine):
            prog[n].copy_(src)
    g = torch.Generator().manual_seed(9)
    batches = [torch.randint(0, m["vocab_size"], (4, 33), generator=g) for _ in range(2)]
    losses, grads = [], None
    for b in batches:
        losses.append(float(train_step(state, {"tokens": b})["loss"]))
        if grads is None:
            grads = {n: float(torch.linalg.vector_norm(state["opt"].state[p]["exp_avg"])) / 0.1
                     for n, p in prog.items()}
    ref = cell.reference().train_steps(mine, m, batches, rows=2)
    start = dict(weights.leaf_items(mine))
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for n in prog:
        assert grads[n] == pytest.approx(ref["grad_norms"][n], rel=1e-4), n
        change = float(torch.linalg.vector_norm(prog[n].detach() - start[n]))
        assert change == pytest.approx(ref["change_norms"][n], rel=1e-3, abs=1e-7), n


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    e8 = (plain.fake_fp8(x) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 4 * e16 > 0
