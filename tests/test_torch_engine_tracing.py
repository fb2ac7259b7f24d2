"""The LLM engine's and server's own spans and counters, on the CPU.

``LLMEngine.step`` opens one ``tracing.phase`` per part of the step, and a
request that arrives under a trace (or while the in-process recorder runs)
records its queue wait, its prefill and its first token's wait. With no
recording, no trace and no profiler nothing is recorded at all. The work
counters are always on; the prefill ones give the share of launched prompt
tokens that are real. Spans stamped by ``tracing.now()`` share the
profiler's clock, and the server's ``serve.ttft_s`` runs from the call to
the hand-over, so it is never shorter than the engine's ``ttft_s``.
"""
import json
import time
import types

import pytest
import torch

from ray_tpu_torch.llm import LLMEngine, LLMServer
from ray_tpu_torch.llm.engine import EngineConfig
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.util import tracing

MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=128,
             dtype=torch.float32)
ENGINE = dict(max_slots=4, max_seq=128, prefill_buckets=(16, 32, 64), decode_block=2, kv_layout="paged",
              page_size=16)
TIMEOUT_S = 60.0
STEP_PARTS = {"llm.engine.admit", "llm.engine.prefill.dispatch", "llm.engine.prefill.fetch",
              "llm.engine.decode.dispatch", "llm.engine.decode.fetch", "llm.engine.emit"}
REQUEST_SPANS = ["llm.request.queue", "llm.request.prefill", "llm.request.first_token_wait"]


@pytest.fixture(scope="module")
def params():
    cfg = TransformerConfig(**MODEL)
    gen = torch.Generator().manual_seed(0)
    from ray_tpu_torch.models.transformer import init_params

    return init_params(cfg, gen, "cpu")


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    tracing.stop_recording()


def _engine(params, **kw):
    return LLMEngine(TransformerConfig(**MODEL), params=params, engine_config=EngineConfig(**{**ENGINE, **kw}),
                     device="cpu")


def _prompt(n, base=1):
    return [(base + j) % 60 + 1 for j in range(n)]


def _drain(eng, limit=200):
    for _ in range(limit):
        if not eng.has_work():
            return
        eng.step()
    raise AssertionError("the engine did not finish its requests")


def test_nothing_is_recorded_when_off(params, monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "_record_event", calls.append)
    assert not torch.autograd.profiler._is_profiler_enabled and tracing.current_trace() is None
    assert tracing.phase("llm.engine.step") is tracing.phase("llm.engine.emit")  # the shared no-op
    assert tracing.request_trace() is None
    eng = _engine(params)
    for i, n in enumerate((5, 12, 20)):
        eng.add_request(f"r{i}", _prompt(n), max_tokens=4)
    _drain(eng)
    llm = LLMServer(MODEL, ENGINE, params=params, device="cpu")
    try:
        assert len(llm.generate(_prompt(7), 3, timeout_s=TIMEOUT_S)["tokens"]) == 3
        assert sum(len(ev["new_tokens"]) for ev in llm.generate_stream(_prompt(9), 3, timeout_s=TIMEOUT_S)) == 3
    finally:
        llm.__raytpu_exit__()
    assert calls == []


def test_recording_gives_each_step_its_phases_and_each_request_its_spans(params, tmp_path):
    eng = _engine(params)
    lengths = (5, 12, 20, 33, 9, 40)  # six requests on four slots: two admission waves
    tracing.start_recording()
    for i, n in enumerate(lengths):
        eng.add_request(f"r{i}", _prompt(n, i), max_tokens=3 + i)
    _drain(eng)
    events = tracing.stop_recording()
    assert events and all(e["kind"] == "span" and e["dur"] >= 0 for e in events)
    by_id = {e["span_id"]: e for e in events}

    def inside(child, parent):
        return parent["ts"] <= child["ts"] and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]

    steps = [e for e in events if e["name"] == "llm.engine.step"]
    assert len(steps) == eng.counters()["steps"]
    for st in steps:
        assert st["parent_id"] == ""  # recording with no trace: each step is a root
        kids = [e for e in events if e["parent_id"] == st["span_id"]]
        names = [k["name"] for k in kids]
        assert set(names) <= STEP_PARTS and all(inside(k, st) for k in kids)
        assert names.count("llm.engine.admit") == 1 and names.count("llm.engine.emit") == 1
        assert names.count("llm.engine.prefill.dispatch") == names.count("llm.engine.prefill.fetch")
        assert names.count("llm.engine.decode.dispatch") == names.count("llm.engine.decode.fetch") <= 1
        assert all(k["trace_id"] == st["trace_id"] for k in kids)
    for s in (e for e in events if e["name"] == "llm.engine.sample"):
        parent = by_id[s["parent_id"]]
        assert parent["name"] in ("llm.engine.prefill.dispatch", "llm.engine.decode.dispatch")
        assert inside(s, parent)
    c = eng.counters()
    dispatches = [e for e in events if e["name"] == "llm.engine.prefill.dispatch"]
    decodes = [e for e in events if e["name"] == "llm.engine.decode.dispatch"]
    assert len(dispatches) == c["prefill_groups"]
    assert sum(e["attrs"]["real_tokens"] for e in dispatches) == c["prefill_real_tokens"] == sum(lengths)
    assert len(decodes) == c["decode_blocks"]
    assert sum(e["attrs"]["n"] for e in decodes) == c["decode_token_steps"]
    assert sum(e["attrs"]["admitted"] for e in steps) == len(lengths)

    # Each request: queue, prefill, first_token_wait, one after the other,
    # under a trace id of its own.
    for i in range(len(lengths)):
        spans = [e for e in events if e["name"].startswith("llm.request.") and e["attrs"]["request"] == f"r{i}"]
        assert [e["name"] for e in spans] == REQUEST_SPANS
        assert len({e["trace_id"] for e in spans}) == 1
        for a, b in zip(spans, spans[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1e-9
    assert len({e["trace_id"] for e in events if e["name"] == "llm.request.queue"}) == len(lengths)

    # The recorded list renders as a Chrome trace.
    path = tmp_path / "engine.json"
    assert tracing.render_timeline(events, str(path)) == len(events)
    assert {e["name"] for e in json.loads(path.read_text())["traceEvents"]} >= STEP_PARTS


def test_recorder_keeps_at_most_its_limit():
    tracing.start_recording(limit=3)
    for _ in range(5):
        with tracing.phase("llm.engine.step") as ph:
            ph.set(slots=1)
    events = tracing.stop_recording()
    assert [e["attrs"] for e in events] == [{"slots": 1}] * 3
    assert tracing.stop_recording() == []


def test_prefill_fill_counters_by_hand(params):
    eng = _engine(params)
    # Buckets 16/32/64: 5 and 12 share one group of 2 x 16, 20 takes 32, 33 takes 64.
    for i, n in enumerate((5, 12, 20, 33)):
        eng.add_request(f"r{i}", _prompt(n), max_tokens=4)
    c0 = eng.counters()
    eng.step()
    d = {k: v - c0[k] for k, v in eng.counters().items()}
    assert d["prefill_groups"] == 3
    assert d["prefill_real_tokens"] == 5 + 12 + 20 + 33 == 70
    assert d["prefill_launched_tokens"] == 2 * 16 + 32 + 64 == 128
    assert d["prefill_real_tokens"] / d["prefill_launched_tokens"] == pytest.approx(0.546875)
    assert d["steps"] == 1 and d["slot_steps"] == 4
    # Nothing waits and every slot has its first token: the full block.
    assert d["decode_blocks"] == 1 and d["decode_token_steps"] == eng.ec.decode_block
    _drain(eng)
    c = eng.counters()
    assert c["prefill_groups"] == 3 and c["decode_token_steps"] >= 3
    assert c["slot_steps"] <= 4 * c["steps"]


def test_traced_server_requests_join_the_callers_trace(params, monkeypatch):
    events = []
    monkeypatch.setattr(tracing, "_record_event", events.append)
    llm = LLMServer(MODEL, ENGINE, params=params, device="cpu")
    try:
        with tracing.span("client") as root:
            out = list(llm.generate_stream(_prompt(11), 4, timeout_s=TIMEOUT_S))
        assert out[-1]["finished"]
        with tracing.span("client") as root2:
            llm.generate(_prompt(6), 3, timeout_s=TIMEOUT_S)
    finally:
        llm.__raytpu_exit__()
    stream = [e for e in events if e["trace_id"] == root.trace_id]
    assert [e["name"] for e in stream] == REQUEST_SPANS + ["client"]
    assert all(e["parent_id"] == root.span_id for e in stream[:3])
    blocking = [e for e in events if e["trace_id"] == root2.trace_id]
    assert [e["name"] for e in blocking] == REQUEST_SPANS + ["llm.generate", "client"]
    assert all(e["parent_id"] == blocking[3]["span_id"] for e in blocking[:3])
    # The stepping thread's own phases ran outside any trace: none recorded.
    assert not [e for e in events if e["name"].startswith("llm.engine.")]


def test_phase_lies_on_the_profilers_clock(tmp_path):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.phase("llm.test.unrecorded"):
            pass  # the profiler alone: a range, no span
        tracing.start_recording()
        with tracing.phase("llm.test.clock"):
            time.sleep(0.01)
        spans = tracing.stop_recording()
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = {e["name"]: e for e in trace["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("llm.test.")}
    assert set(ranges) == {"llm.test.unrecorded", "llm.test.clock"}
    assert [s["name"] for s in spans] == ["llm.test.clock"]
    span, rng = spans[0], ranges["llm.test.clock"]
    assert abs((rng["ts"] + base_us) - span["ts"] * 1e6) < 1000.0
    assert abs((rng["ts"] + rng["dur"] + base_us) - (span["ts"] + span["dur"]) * 1e6) < 1000.0


def test_server_ttft_histogram_runs_from_submit_to_hand_over(params, monkeypatch):
    llm = LLMServer(MODEL, ENGINE, params=params, device="cpu")
    observed = []
    monkeypatch.setattr(llm, "_ttft_hist", types.SimpleNamespace(observe=observed.append))
    try:
        engine_ttft = []
        for i in range(4):  # one at a time, so the i-th observation is the i-th request's
            engine_ttft.append(llm.generate(_prompt(6 + 7 * i, i), 3, timeout_s=TIMEOUT_S)["ttft_s"])
        first = next(ev for ev in llm.generate_stream(_prompt(30), 4, timeout_s=TIMEOUT_S) if ev["new_tokens"])
        engine_ttft.append(first["ttft_s"])
    finally:
        llm.__raytpu_exit__()
    assert len(observed) == len(engine_ttft) == 5
    assert all(o >= e > 0 for o, e in zip(observed, engine_ttft))
    assert not llm._submitted
