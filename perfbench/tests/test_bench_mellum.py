"""The Mellum2 configuration and its cell: the leaves and counts of
``models/mellum.py`` against totals worked out by hand, the refusals of its
``port_kwargs``, a whole run of ``serve.mellum2.repo_offline`` on the CPU at
a tiny size (sound, then with a fault planted), and the fp8 control there.
The control at the cell's own size is a ``cuda`` test. ``routing_flips.py`` on the tiny cell: in float32 the
program routes as the reference does, the fp8 control does not."""
import json
import math
import time

import pytest
import torch

from perfbench import check, faults, harness, routing_flips, weights
from perfbench.metrics import _counts
from perfbench.models import mellum
from perfbench.run import run_cell

CELL = "serve.mellum2.repo_offline"
CONFIG = harness.load_json(harness.HERE / "configs" / "mellum2-12b-a2.5b.json")


def _cell():
    return harness.load_cell(CELL)


def _m():
    return mellum.port_kwargs(CONFIG)


def test_the_published_widths_reach_the_port():
    m = _m()
    assert (m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]) == (28, 2304, 32, 4, 128)
    assert (m["n_experts"], m["expert_top_k"], m["d_ff"], m["vocab_size"]) == (64, 8, 896, 98304)
    assert m["layer_types"] == ("sliding", "sliding", "sliding", "full") * 7 and m["sliding_window"] == 1024
    assert m["rope_theta"] == 500000.0 and m["rope_scaling"]["factor"] == 16
    assert m["rope_scaling"]["attention_factor"] == 1.2772588722239782
    assert CONFIG["max_position_embeddings"] == 8832 and list(CONFIG["reduced"]) == ["max_position_embeddings"]


def test_leaves_and_counts_against_hand_computed_totals():
    m = _m()
    total = sum(math.prod(shape) for _, shape, _ in mellum.leaves(m))
    # Per layer: q and o 2 x 2304 x 4096, k and v 2 x 2304 x 512, two norms,
    # the router 2304 x 64, 64 experts of 3 x 2304 x 896; embedding and head
    # 98304 x 2304 each; the final norm.
    layer = 2 * 2304 * 4096 + 2 * 2304 * 512 + 2 * 2304 + 2304 * 64 + 64 * 3 * 2304 * 896
    assert total == 28 * layer + 2 * 98304 * 2304 + 2304 == 12_149_915_904
    assert mellum.kv_bytes_per_token(m) == 28 * 2 * 4 * 128 * 2 == 57_344
    active = 28 * (2 * 2304 * 4096 + 2 * 2304 * 512 + 2304 * 64 + 8 * 3 * 2304 * 896)
    assert mellum.matmul_params(m) == active == 1_985_937_408
    assert mellum.head_params(m) == 98304 * 2304
    # 21 sliding layers see at most 1024 keys, 7 full layers every key.
    pairs = 21 * (1024 * 1025 // 2 + (4096 - 1024) * 1024) + 7 * 4096 * 4097 // 2
    assert mellum.attn_fwd_flops(m, 4096) == 4.0 * 32 * 128 * pairs
    assert mellum.decode_attn_flops(m, 3000) == 4.0 * 32 * 128 * (21 * 1024 + 7 * 3000)
    assert _counts.decode_token_flops(mellum, m, 10) == 2.0 * (active + 98304 * 2304) + 4.0 * 32 * 128 * 10 * 28
    # K6: 512 decode rows touch every expert; 8 rows at most 8 of them.
    weights_64 = 64 * 3 * 2304 * 896 * 2
    assert mellum.moe_bound(m, 512) == _counts.bound_s(2.0 * 512 * 3 * 2304 * 896, weights_64 + 2 * 512 * 2304 * 2)
    assert mellum.moe_bound(m, 8) == _counts.bound_s(2.0 * 8 * 3 * 2304 * 896, weights_64 // 8 + 2 * 8 * 2304 * 2)
    with pytest.raises(NotImplementedError, match="K3/K2"):
        mellum.train_attn_bounds(m, 8, 4096)


@pytest.mark.parametrize("change,match", [
    ({"qk_norm": True}, "cannot express"),
    ({"hidden_act": "gelu"}, "SwiGLU"),
    ({"attention_bias": True}, "bias-free"),
    ({"tie_word_embeddings": True}, "untied"),
    ({"rms_norm_eps": 1e-5}, "eps"),
    ({"mlp_layer_types": ["dense"] + ["sparse"] * 27}, "sparse in every layer"),
    ({"norm_topk_prob": False}, "renormalised"),
    ({"layer_types": ["chunked_attention"] * 28}, "layer_types"),
    ({"max_window_layers": 4}, "max_window_layers"),
    ({"rope_parameters": {"full_attention": {"rope_type": "llama3", "rope_theta": 500000},
                          "sliding_attention": {"rope_type": "default", "rope_theta": 500000}}}, "YaRN"),
    ({"rope_parameters": {"full_attention": CONFIG["rope_parameters"]["full_attention"],
                          "sliding_attention": {"rope_type": "linear", "factor": 2}}}, "plain"),
])
def test_port_kwargs_refuses_what_the_port_cannot_express(change, match):
    with pytest.raises(ValueError, match=match):
        mellum.port_kwargs({**CONFIG, **change})


def _tiny(cell):
    """The cell with the model cut to a CPU size in Mellum2's own keys (the
    3:1 layer pattern, window 16, 8 experts top 2, head_dim 16 while
    hidden / heads is 12) and the traffic cut to match. It computes in
    float32, as the tiny MoE cell of ``test_bench_model_type_open`` does: at
    48 wide a bfloat16 rounding flips a near-tie of the 8-way router often
    enough to move a logit by more than the limit set at the full width."""
    cell.config.update(hidden_size=48, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                       head_dim=16, moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
                       vocab_size=256, max_position_embeddings=256, sliding_window=16,
                       layer_types=["sliding_attention"] * 3 + ["full_attention"], mlp_layer_types=["sparse"] * 4,
                       torch_dtype="float32")
    t = cell.traffic
    t["engine"].update(page_size=16, max_slots=8, max_seq=256, total_pages=8 * 9 + 1, prefill_buckets=[32, 64, 128])
    t["warmup_buckets"] = [32, 64, 128]
    t["prompt_len"].update(min=20, max=100, median=48)
    t["output_len"].update(min=4, max=24)
    t["first_wave_output_len"].update(min=2, max=24)
    t.update(pool=2000, backlog=8)
    t["judge"]["min_tokens"] = 24
    return cell


@pytest.mark.parametrize("fault", [None, "altered_token"])
def test_a_whole_run_of_the_cell_on_the_cpu(fault):
    cell = _tiny(_cell())
    if fault is None:
        result = run_cell(cell, 2**31 + 23, 4.0, False, "cpu", t_start=time.perf_counter())
        assert result["correct"], result["compared"]
        assert set(result["metrics"]) == {"output_tok_s", "setup_s"}
        assert result["attempted"] > 0 and result["failed"] == 0
        return
    with faults.FAULTS[fault]():
        result = run_cell(cell, 2**31 + 23, 4.0, False, "cpu", t_start=time.perf_counter())
    assert not result["correct"], result["compared"]


def test_the_moe_bounds_are_recorded_only_under_the_profiler():
    """The entry's hooks add K6's bounds while the profiler runs (the traced
    slice), per layer of each prefill group and per layer and step of each
    decode block, and nothing otherwise."""
    cell = _tiny(_cell())
    entry = __import__("perfbench.entries.engine_backlog_moe", fromlist=["Entry"]).Entry(cell, "cpu")
    entry.build(7)
    entry._recording = True
    eng = entry.engine
    eng.add_request("a", list(range(30)), max_tokens=40)
    eng.step()
    assert entry.moe_bounds == []
    kw = {}
    try:  # the traced slice's profiler records all threads (perfbench/trace.py)
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw):
        eng.step()
    m = entry.m
    assert entry.moe_bounds and all(k == 4 for _, k in entry.moe_bounds)
    assert len(entry.moe_bounds) % m["n_layers"] == 0
    assert entry.moe_bounds[0][0] == mellum.moe_bound(m, m["expert_top_k"])


def test_control_reads_far_above_the_program_tiny():
    cell = _tiny(_cell())
    entry = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"]).Entry(cell, "cpu")
    seed = 424243
    entry.build(seed)
    out = entry.window(seed, 4.0)
    entry.free()
    r = entry.readings(seed, out["judged"], control=True)
    ok, compared = check.judge(r["program"], cell.limits)
    assert ok, compared
    assert r["control"]["max_logit_gap"] >= 3 * r["program"]["max_logit_gap"], (r["program"], r["control"])


def test_the_reference_imports_no_kernel_and_routes_by_itself():
    src = (harness.HERE / "reference" / "mellum.py").read_text()
    assert "ray_tpu_torch" not in src and "jax" not in src
    assert "exact_fp32" in src and "topk" in src
    m = mellum.port_kwargs({**CONFIG, "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
                            "num_key_value_heads": 2, "head_dim": 16, "moe_intermediate_size": 32,
                            "num_experts": 8, "num_experts_per_tok": 2, "vocab_size": 64, "sliding_window": 8,
                            "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
                            "mlp_layer_types": ["sparse"] * 4})
    params = weights.make_params(mellum.leaves(m), 3, torch.float32, "cpu")
    ref = __import__("perfbench.reference.mellum", fromlist=["forward_logits"])
    logits = ref.forward_logits(params, m, list(range(20)))
    assert logits.shape == (20, 64) and torch.isfinite(logits).all()
    assert json.dumps(m["rope_scaling"])  # plain data, as the configuration gives it


def test_routing_flips_on_the_tiny_cell():
    cell = _tiny(_cell())
    r = routing_flips.flips(cell, 2**31 + 7, 8.0, "cpu")
    prog = r["program"]
    assert len(prog["layers"]) == 4 and prog["tokens_flipped"] == 0.0
    assert prog["max_gap"] == prog["mean_gap"] == prog["not_first"] == 0.0
    assert all(row["rel_gap"] < 1e-5 for row in prog["layers"])
    assert r["fp8"]["tokens_flipped"] > 0.1 and r["fp8"]["mean_gap"] > 0.0
    assert set(r) >= {"one_bf16", "res_bf16", "mm_bf16", "fp8"}
