"""Mellum2's block in the port, on the CPU: the sliding window of the plain
versions of K1 and K4 against masks written out from the definition, YaRN's
frequencies against the formula, the routed experts' plain version against
a loop over the experts, and a tiny Mellum-shaped ``LLMEngine`` (4 layers in
the 3:1 sliding:full pattern, window 16, 8 experts top-2, head_dim 16 while
d_model / n_heads is 12) against ``perfbench/reference/mellum.py``'s full
forward on the same seeded weights: prefill, decode through the paged cache
past the window, a prefix-cache partial hit and a chunked prefill whose
chunks cross the window.

Everything runs in float32, so the engine and the reference differ only in
the order of their sums (and the reference's float64 frequencies): logits
are held to 1e-4, three orders of magnitude under the gaps the benchmark's
limits allow and far above float32 rounding over 4 layers.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.harness import HERE
from perfbench.models import mellum as mellum_model
from perfbench.reference import mellum as mellum_ref
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    make_train_step,
    yarn_inv_freq,
)
from ray_tpu_torch.ops import moe
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.ops.paged_attention import paged_attention_reference, paged_attention_split_reference

TOL = dict(rtol=1e-4, atol=1e-4)


def _brute_attention(q, k, v, window):
    """o[b, i, h] = softmax over keys j with i - window < j <= i, in float64."""
    B, S, H, D = q.shape
    group = H // k.shape[2]
    out = torch.zeros(B, S, H, D, dtype=torch.float64)
    for i in range(S):
        j = [x for x in range(S) if x <= i and (not window or x > i - window)]
        for h in range(H):
            s = torch.einsum("bd,bjd->bj", q[:, i, h].double(), k[:, j, h // group].double()) / math.sqrt(D)
            p = torch.softmax(s, dim=-1)
            out[:, i, h] = torch.einsum("bj,bjd->bd", p, v[:, j, h // group].double())
    return out


@pytest.mark.parametrize("window", [5, 24, 40])  # smaller than, equal to and larger than S
def test_k1_plain_window_against_a_brute_force_mask(window):
    g = torch.Generator().manual_seed(window)
    q = torch.randn(2, 24, 4, 8, generator=g)
    k = torch.randn(2, 24, 2, 8, generator=g)
    v = torch.randn(2, 24, 2, 8, generator=g)
    got = mha_reference(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.double(), _brute_attention(q, k, v, window), rtol=1e-5, atol=1e-5)
    if window >= 24:  # a window as long as the context changes nothing
        torch.testing.assert_close(got, mha_reference(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("window,pages_per_run", [(6, 1), (8, 2), (13, 1), (40, 2)])
def test_k4_plain_window_against_a_brute_force_mask(window, pages_per_run):
    """Lengths 0, under the window, on a page boundary, with the window's
    first key inside a page, and over several pages; page size 8."""
    g = torch.Generator().manual_seed(window)
    B, H, KV, D, ps, ppseq = 6, 8, 1, 8, 8, 5
    q = torch.randn(B, H, D, generator=g)
    kp = torch.randn(KV, 40, ps, D, generator=g)
    vp = torch.randn(KV, 40, ps, D, generator=g)
    table = torch.randperm(39, generator=g)[:B * ppseq].reshape(B, ppseq).int() + 1
    lengths = torch.tensor([0, 3, 16, 21, 29, 40], dtype=torch.int32)
    want = torch.zeros(B, H, D, dtype=torch.float64)
    for b in range(B):
        n = int(lengths[b])
        keys = [j for j in range(n) if j >= n - window]
        if not keys:
            continue
        kk = torch.stack([kp[0, table[b, j // ps], j % ps] for j in keys]).double()
        vv = torch.stack([vp[0, table[b, j // ps], j % ps] for j in keys]).double()
        p = torch.softmax(q[b].double() @ kk.T / math.sqrt(D), dim=-1)
        want[b] = p @ vv
    got = paged_attention_reference(q, kp, vp, lengths, table, window=window)
    split = paged_attention_split_reference(q, kp, vp, lengths, table, pages_per_run=pages_per_run, window=window)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(split.double(), want, rtol=1e-5, atol=1e-5)


def test_yarn_frequencies_at_the_published_parameters():
    """Mellum2's full layers: head_dim 128, theta 500000, factor 16 over an
    original 8192 positions, beta_fast 32, beta_slow 1."""
    p = {"rope_type": "yarn", "factor": 16, "original_max_position_embeddings": 8192, "beta_fast": 32,
         "beta_slow": 1, "attention_factor": 1.2772588722239782}
    d, theta = 128, 500000.0
    extra = [theta ** (-2 * i / d) for i in range(d // 2)]
    low = math.floor(d * math.log(8192 / (32 * 2 * math.pi)) / (2 * math.log(theta)))
    high = math.ceil(d * math.log(8192 / (1 * 2 * math.pi)) / (2 * math.log(theta)))
    assert (low, high) == (18, 35)  # 18.08 and 34.99 before rounding
    want = []
    for i, e in enumerate(extra):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(e / 16 * ramp + e * (1 - ramp))
    got = yarn_inv_freq(d, theta, p)
    torch.testing.assert_close(got.double(), torch.tensor(want, dtype=torch.float64), rtol=1e-6, atol=0)
    torch.testing.assert_close(mellum_ref.yarn_freqs(d, theta, p).double(), got.double(), rtol=1e-6, atol=0)


def test_routed_experts_plain_version_against_a_loop_over_experts():
    """8 experts, top 2, 10 tokens whose routing leaves experts 5 and 7
    without a row."""
    g = torch.Generator().manual_seed(0)
    T, D, F, E, k = 10, 16, 8, 8, 2
    x = torch.randn(T, D, generator=g)
    wg, wu = torch.randn(E, D, F, generator=g), torch.randn(E, D, F, generator=g)
    wd = torch.randn(E, F, D, generator=g)
    ids = torch.tensor([[0, 1], [2, 3], [4, 6], [1, 0], [3, 2], [6, 4], [0, 2], [1, 3], [4, 0], [6, 1]],
                       dtype=torch.int32)
    w = torch.softmax(torch.randn(T, k, generator=g), dim=-1)
    y, counts = moe.moe_experts(x, w, ids, wg, wu, wd)
    assert counts.tolist() == [4, 4, 3, 3, 3, 0, 3, 0]
    want = torch.zeros(T, D)
    for e in range(E):
        for t in range(T):
            for slot in range(k):
                if int(ids[t, slot]) == e:
                    h = torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
                    want[t] += w[t, slot] * (h @ wd[e])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # route(): an fp32 softmax, its top k renormalised
    router = torch.randn(D, E, generator=g)
    rw, rid = moe.route(x, router, k)
    top_w, top_i = torch.topk(torch.softmax(x @ router, dim=-1), k, dim=-1)
    torch.testing.assert_close(rw, top_w / top_w.sum(-1, keepdim=True))
    assert torch.equal(rid.long(), top_i)


def _tiny_config() -> dict:
    """Mellum2's configuration file cut to a CPU size, in its own keys."""
    cfg = json.loads((HERE / "configs" / "mellum2-12b-a2.5b.json").read_text())
    kinds = ["sliding_attention"] * 3 + ["full_attention"]
    cfg.update(hidden_size=48, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2, vocab_size=128,
               max_position_embeddings=128, sliding_window=16, layer_types=kinds, mlp_layer_types=["sparse"] * 4,
               torch_dtype="float32")
    cfg["rope_parameters"] = {
        "full_attention": {"rope_type": "yarn", "rope_theta": 10000.0, "factor": 4.0,
                           "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1,
                           "attention_factor": 1.1386},
        "sliding_attention": {"rope_type": "default", "rope_theta": 10000.0}}
    return cfg


@pytest.fixture(scope="module")
def tiny():
    m = mellum_model.port_kwargs(_tiny_config())
    cfg = TransformerConfig(**{**m, "dtype": torch.float32, "param_dtype": torch.float32})
    params = weights.make_params(mellum_model.leaves(m), 7, torch.float32, "cpu")
    return m, cfg, params


def _engine(cfg, params, **kw):
    ec = EngineConfig(kv_layout="paged", page_size=8, max_slots=2, max_seq=128, prefill_buckets=(32, 64),
                      decode_block=4, **kw)
    eng = LLMEngine(cfg, params=params, engine_config=ec, device="cpu")
    seen = []
    orig = eng._sample

    def sample(logits, *a):
        seen.append(logits.clone())
        return orig(logits, *a)

    eng._sample = sample
    return eng, seen


def _served_logits(eng, seen, prompt, max_tokens):
    """The engine's logits at each position that produced a token of a lone
    request (slot 0): its prefill's, then slot 0's row of each decode step."""
    seen.clear()
    toks = eng.generate(np.asarray(prompt, np.int32), max_tokens=max_tokens)["tokens"]
    rows = [seen[0][0]] + [s[0] for s in seen[1:]]
    return toks, torch.stack(rows[:len(toks)])


def _check(m, params, prompt, toks, logits):
    seq = list(prompt) + list(toks[:-1])
    want = mellum_ref.forward_logits(params, m, seq)[len(prompt) - 1:]
    torch.testing.assert_close(logits, want, **TOL)


def test_tiny_mellum_engine_against_the_plain_reference(tiny):
    m, cfg, params = tiny
    rng = np.random.default_rng(3)
    eng, seen = _engine(cfg, params, prefix_cache=True, chunked_prefill=16)
    assert eng.windows == [16, 16, 16, 0]
    # A: prefill of 14 tokens (under the window), decode to 44 positions:
    # past the window, across pages of 8.
    a = rng.integers(0, 128, 14)
    toks, logits = _served_logits(eng, seen, a, 30)
    _check(m, params, a, toks, logits)
    # B: a partial prefix hit on A's first 8 tokens (one cached page), then
    # a 3-page tail whose window reaches back into the cached page.
    b = np.concatenate([a[:8], rng.integers(0, 128, 18)])
    hits = eng.prefix_partial_hits
    toks, logits = _served_logits(eng, seen, b, 12)
    assert eng.prefix_partial_hits == hits + 1
    _check(m, params, b, toks, logits)
    # C: 45 fresh tokens chunked by 16: the second and third chunks' windows
    # cross into the chunks before them.
    c = rng.integers(0, 128, 45)
    steps = eng.prefill_groups
    toks, logits = _served_logits(eng, seen, c, 10)
    assert eng.prefill_groups == steps + 3
    _check(m, params, c, toks, logits)
    # The expert-load count holds every routed row of every layer.
    load = eng.expert_load()
    assert load.shape == (4, 8) and int(load[0].sum()) == int(load[3].sum()) > 0
    assert eng.counters()["moe_prefill_rows"] > 0 and eng.counters()["moe_decode_rows"] > 0


def test_tiny_mellum_dense_layout_and_the_ports_forward(tiny):
    """The dense KV layout's decode masks by window too; the port's own
    forward (reference attention, the dense-dispatch MoE) matches."""
    m, cfg, params = tiny
    prompt = np.random.default_rng(5).integers(0, 128, 20)
    eng = LLMEngine(cfg, params=params, engine_config=EngineConfig(max_slots=2, max_seq=64, prefill_buckets=(32,),
                                                                    decode_block=4), device="cpu")
    seen = []
    orig = eng._sample
    eng._sample = lambda logits, *a: (seen.append(logits.clone()), orig(logits, *a))[1]
    toks, logits = _served_logits(eng, seen, prompt, 12)
    _check(m, params, prompt, toks, logits)
    port, _ = forward(params, torch.tensor(np.asarray(list(prompt) + toks[:-1]))[None],
                      dataclasses.replace(cfg, attention_impl="reference"))
    want = mellum_ref.forward_logits(params, m, list(prompt) + toks[:-1])
    torch.testing.assert_close(port[0], want, **TOL)


def test_dense_configurations_are_unchanged_by_the_new_fields():
    """head_dim, layer_types, sliding_window and rope_scaling at their
    defaults leave a dense model's weights and outputs bit-identical to the
    same model with every layer spelled out as full."""
    base = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48,
                             max_seq_len=64, dtype=torch.float32, attention_impl="reference")
    spelled = dataclasses.replace(base, head_dim=8, layer_types=("full", "full"), sliding_window=0)
    assert base.head_dim == 8 and base.layer_window(0) == 0 and base.layer_rope(1) == (base.rope_theta, None)
    p0 = init_params(base, torch.Generator().manual_seed(1), device="cpu")
    p1 = init_params(spelled, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p0["layers"].values(), p1["layers"].values()))
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(2))
    assert torch.equal(forward(p0, tokens, base)[0], forward(p1, tokens, spelled)[0])


def test_training_a_windowed_model_is_refused(tiny):
    _, cfg, _ = tiny
    with pytest.raises(NotImplementedError, match="K3/K2"):
        make_train_step(cfg)
