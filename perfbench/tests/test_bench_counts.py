"""The yardstick's arithmetic against hand-worked cases and PERF.md's
kernel-table bounds, through the cells' model type (``models/mistral.py``)."""
import math

import pytest

from perfbench import harness
from perfbench import trace as tracing
from perfbench.metrics import _counts as c

CELL = harness.load_cell("train.lm250m.s2048")
MODEL = CELL.model()
M250 = CELL.model_kwargs()
M7B = harness.load_cell("serve.mistral7b.rag").model_kwargs()
MPP8 = harness.load_cell("train.mistral7b-pp8.s4096").model_kwargs()


def test_matmul_weights_of_the_two_models():
    # 250M: per layer 1024*1024*2 (wq, wo) + 1024*256*2 (wk, wv) + 3*1024*4096
    assert MODEL.layer_matmul_params(M250) == 15_204_352
    assert MODEL.matmul_params(M250) + MODEL.head_params(M250) == 215_220_224
    # Mistral-7B: 4096^2 * 2 + 4096*1024*2 + 3*4096*14336, 32 layers, head 4096*32768
    assert MODEL.layer_matmul_params(M7B) == 218_103_808
    assert MODEL.matmul_params(M7B) + MODEL.head_params(M7B) == 7_113_539_584
    # One stage of eight: 4 of its layers, with the head
    assert MODEL.matmul_params(MPP8) + MODEL.head_params(MPP8) == 4 * 218_103_808 + 4096 * 32768


def test_parameter_count_of_the_pipeline_stage():
    n = sum(math.prod(shape) for _, shape, _ in MODEL.leaves(MPP8))
    # 4 layers of 218,103,808 and 2 norms of 4096, embedding and head of 4096 x 32768, the final norm
    assert n == 4 * (218_103_808 + 2 * 4096) + 2 * 4096 * 32768 + 4096 == 1_140_887_552


def test_train_step_flops_per_token():
    # 6 * 215.22M + 3 * 4 * 1024 * (2048 * 2049 / 2) * 12 / 2048 per token
    per_token = c.train_step_flops(MODEL, M250, 16, 2048) / (16 * 2048)
    assert per_token == pytest.approx(6 * 215_220_224 + 3 * 4 * 1024 * 2049 / 2 * 12, rel=1e-12)


def test_prefill_and_decode_flops_hand_worked():
    m = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_ff": 8, "vocab_size": 10}
    layer = 4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8  # 144
    assert MODEL.layer_matmul_params(m) == layer
    # two tokens: 2 * 144 * 2 + head once (2 * 40) + attention 4 * 4 * 3 pairs
    assert c.prefill_flops(MODEL, m, [2]) == 2 * layer * 2 + 2 * 40 + 4 * 4 * 3
    assert c.decode_token_flops(MODEL, m, 5) == 2 * (layer + 40) + 4 * 4 * 5


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table, D 64 training shape (B 16, S 2048, 16/4 heads):
    # K1 0.1390 ms, K3 0.2086 ms, K2 0.2781 ms, all bound by operations.
    bounds = MODEL.train_attn_bounds(M250, 16, 2048)
    assert bounds["flash_fwd_kernel"] * 1e3 == pytest.approx(0.1390, abs=5e-5)
    assert bounds["flash_bwd_dq_kernel"] * 1e3 == pytest.approx(0.2086, abs=5e-5)
    assert bounds["flash_bwd_dkv_kernel"] * 1e3 == pytest.approx(0.2781, abs=5e-5)
    # D 128 (8 x 4096, 32/8 heads): K1 1.1120 ms, K3 1.6680, K2 2.2240
    bounds = MODEL.train_attn_bounds(MPP8, 8, 4096)
    assert bounds["flash_fwd_kernel"] * 1e3 == pytest.approx(1.1120, abs=5e-5)
    assert bounds["flash_bwd_dq_kernel"] * 1e3 == pytest.approx(1.6680, abs=5e-5)
    assert bounds["flash_bwd_dkv_kernel"] * 1e3 == pytest.approx(2.2240, abs=5e-5)


def test_k4_cost_hand_worked():
    flops, nbytes = MODEL.k4_cost(2, 1, 4, [3, 5], 4)
    assert flops == 4 * 2 * 4 * 8
    assert nbytes == 2 * 8 * 1 * 4 * 2 + 2 * 2 * 2 * 4 * 2 + 4 * 2 + 4 * 3


def test_percentile_linear_and_missing():
    assert c.percentile([4, 1, 3, 2], 50) == 2.5
    assert c.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    assert c.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert c.percentile([1.0, math.inf, math.inf], 95) == math.inf


def test_trace_reduction_busy_idle_and_gap_names():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}  # noqa: E731
    events = [ev("user_annotation", tracing.OPEN, 0, 0), ev("user_annotation", tracing.CLOSE, 100, 0),
              ev("kernel", "k1", 10, 20), ev("kernel", "k2", 20, 20), ev("kernel", "k1", 60, 10),
              ev("kernel", "late", 95, 50), ev("cpu_op", "a", -5, 110), ev("user_annotation", "b", 40, 20)]
    s = tracing.summarize_events(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(45e-6)  # [10, 40] + [60, 70] + [95, 100]
    assert s.kernel_time("k1") == (2, pytest.approx(30e-6))
    assert dict((n, round(v * 1e6, 6)) for n, v in s.idle_gaps) == {"a": 35.0, "b": 20.0}
    assert s.device_ops[0][0] == "k1"
