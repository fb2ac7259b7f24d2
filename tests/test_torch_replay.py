"""The port's replay plane and run ledger: ``tests/test_replay.py``'s 21
cases on ``ray_tpu_torch.replay`` and ``ray_tpu_torch.obs.ledger``, then the
port held to ``ray_tpu``: the seed-0 day is byte-identical to the committed
trace and to the reference's synthesizer at several seeds and sizes, and
``ledger.gate``/``diff``/``render`` give the reference's results on the
committed ledger and on perturbed copies of it.

Replay plane: trace codec, seeded synthesizer, open-loop replayer,
chaos-timeline compilation, and the run-ledger report engine.

Everything here is offline or loopback-only (a stdlib no-op HTTP server
stands in for the serve proxy) — the full day_in_the_life scenario runs in
tests/test_chaos.py. The canonical-artifact tests pin the synthesizer to
the committed seed-0 trace: if the generator drifts, the byte-identity
contract (one seed -> one day) is broken and these fail first.
"""
from __future__ import annotations

import copy
import hashlib
import json
import pathlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ray_tpu_torch.chaos import plan as _plan
from ray_tpu_torch.chaos.plan import FaultRule, FaultSchedule
from ray_tpu_torch.obs import ledger as _ledger
from ray_tpu_torch.obs.slo import SloEngine, SloTracker, Objective
from ray_tpu_torch.replay import (CompiledTimeline, Replayer, Timeline,
                            TimelineDriver, default_params, dumps_trace,
                            envelope, phase_spans, read_trace, summarize,
                            synthesize, write_trace)

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(autouse=True)
def _chaos_clean():
    """The replayer's send path has a chaos gate — keep the plane disarmed
    around every test so an installed schedule never leaks."""
    _plan.uninstall()
    yield
    _plan.uninstall()


# ---------------------------------------------------------------------------
# trace codec + synthesizer
# ---------------------------------------------------------------------------

def test_trace_codec_roundtrip(tmp_path):
    header, records = synthesize(7, duration_s=4.0, base_rps=30.0)
    path = str(tmp_path / "t.jsonl")
    sha = write_trace(path, header, records)
    assert sha == hashlib.sha256(dumps_trace(header, records)).hexdigest()
    h2, r2 = read_trace(path)
    assert h2 == header
    assert r2 == records
    # re-serializing the parsed trace reproduces the original bytes
    assert dumps_trace(h2, r2) == dumps_trace(header, records)


def test_trace_read_validates(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"format": "something-else", "version": 1}\n')
    with pytest.raises(ValueError, match="not a raytpu-trace"):
        read_trace(str(bad))
    header, records = synthesize(1, duration_s=2.0, base_rps=20.0)
    records[0], records[1] = records[1], records[0]  # break arrival order
    shuffled = tmp_path / "shuffled.jsonl"
    shuffled.write_bytes(dumps_trace(header, records))
    with pytest.raises(ValueError, match="out of arrival order"):
        read_trace(str(shuffled))
    header2, records2 = synthesize(1, duration_s=2.0, base_rps=20.0)
    header2["requests"] += 1  # header promise vs body mismatch
    lying = tmp_path / "lying.jsonl"
    lying.write_bytes(dumps_trace(header2, records2))
    with pytest.raises(ValueError, match="promises"):
        read_trace(str(lying))


def test_synthesizer_byte_determinism():
    a = dumps_trace(*synthesize(42, duration_s=6.0, base_rps=25.0, tenants=3))
    b = dumps_trace(*synthesize(42, duration_s=6.0, base_rps=25.0, tenants=3))
    assert a == b
    c = dumps_trace(*synthesize(43, duration_s=6.0, base_rps=25.0, tenants=3))
    assert a != c


def test_synthesizer_matches_committed_artifact():
    """The committed seed-0 quick trace IS synthesize(0, quick params) —
    byte for byte. Generator drift = a broken replay contract."""
    committed = (DATA / "day_in_the_life_seed0.trace.jsonl").read_bytes()
    fresh = dumps_trace(*synthesize(0, **default_params(quick=True)))
    assert hashlib.sha256(fresh).hexdigest() == hashlib.sha256(committed).hexdigest()
    assert fresh == committed


def test_envelope_and_phase_spans():
    p = default_params(quick=True)
    # calm shoulders sit at 1.0, the spike mid-window at spike_mult
    assert envelope(0.1, p["spike_start"], p["spike_end"], p["spike_mult"]) == 1.0
    assert envelope(0.9, p["spike_start"], p["spike_end"], p["spike_mult"]) == 1.0
    mid = (p["spike_start"] + p["spike_end"]) / 2
    assert envelope(mid, p["spike_start"], p["spike_end"],
                    p["spike_mult"]) == pytest.approx(p["spike_mult"])
    spans = phase_spans(p)
    assert set(spans) == {"calm", "storm", "recovery"}
    assert spans["calm"][1] == spans["storm"][0]
    assert spans["storm"][1] == spans["recovery"][0]
    assert spans["recovery"][1] == p["duration_s"]


def test_synthesizer_class_and_tenant_mix():
    header, records = synthesize(5, duration_s=20.0, base_rps=40.0, tenants=4)
    assert header["requests"] == len(records) > 200
    assert set(header["classes"]) == {"interactive", "batch", "best_effort"}
    # Zipf skew: the head tenant dominates the tail tenant
    assert header["tenants"]["t0"] > header["tenants"]["t3"]


# ---------------------------------------------------------------------------
# FaultRule.skip — the hit-space window primitive the compiler targets
# ---------------------------------------------------------------------------

def test_fault_rule_skip_window():
    sched = FaultSchedule([FaultRule.from_spec(
        {"site": "worker.exec", "kind": "error", "skip": 3, "every": 2,
         "max_faults": 2})], seed=0)
    _plan.install(sched)
    fired = [_plan.maybe_inject("worker.exec") is not None for _ in range(10)]
    # hits 1..3 skipped; eligible hits 1.. start at hit 4 -> every=2 fires
    # at eligible 2, 4 == hits 5, 7; max_faults caps it there.
    assert fired == [False, False, False, False, True,
                     False, True, False, False, False]


def test_fault_rule_skip_spec_roundtrip():
    r = FaultRule.from_spec({"site": "worker.exec", "kind": "error",
                             "skip": 9, "every": 4, "max_faults": 2})
    spec = r.to_spec()
    assert spec["skip"] == 9
    assert FaultRule.from_spec(spec).skip == 9
    # zero skip stays off the wire (canonical spec minimalism)
    r0 = FaultRule.from_spec({"site": "worker.exec", "kind": "error", "nth": 1})
    assert "skip" not in r0.to_spec()


# ---------------------------------------------------------------------------
# timeline compilation
# ---------------------------------------------------------------------------

def _fake_records(ts):
    return [{"i": i, "t": t} for i, t in enumerate(ts)]


def test_timeline_compiles_windows_into_hit_space():
    spans = {"calm": (0.0, 4.0), "storm": (4.0, 8.0), "recovery": (8.0, 12.0)}
    # ten arrivals: 3 calm, 4 storm, 3 recovery
    records = _fake_records([0.5, 1.5, 2.5, 4.5, 5.5, 6.5, 7.5, 8.5, 9.5, 10.5])
    tl = Timeline(spans, [
        {"action": "slow_replica_window", "phase": "storm", "delay_s": 0.02,
         "deployment": "DayApp"},
        {"action": "client_flap", "phase": "calm", "every": 2},
        {"action": "tpu_preempt", "phase": "recovery", "offset_s": 1.0,
         "worker_id": "1", "grace_s": 0.3},
        {"action": "publish_weights", "phase": "recovery", "offset_s": 0.5,
         "channel": "w"},
    ])
    compiled = tl.compile(0, records, time_warp=2.0, heartbeat_s=0.5, lead_s=1.0)
    assert isinstance(compiled, CompiledTimeline)
    assert compiled.spans == spans
    by_site = {r["site"]: r for r in compiled.spec["rules"]}
    slow = by_site["serve.replica.slow"]
    assert slow["skip"] == 3              # the calm arrivals
    assert slow["max_faults"] == 4        # the storm arrivals
    assert slow["ctx"] == {"deployment": "DayApp"}
    flap = by_site["replay.request.send"]
    assert flap["skip"] == 0 and flap["every"] == 2
    assert flap["max_faults"] == 1        # 3 calm hits // every 2
    pre = by_site["tpu.preempt"]
    # wall anchor = lead 1.0 + (8.0 + 1.0)/warp 2.0 = 5.5s -> nth = 5.5/0.5
    assert pre["nth"] == 11
    assert pre["ctx"] == {"worker_id": "1"}
    # control actions stay off the fault spec and sort by trace time
    assert [a["action"] for _, a in compiled.control] == ["publish_weights"]
    assert compiled.control[0][0] == 8.5
    # the compiled spec installs cleanly (site/kind validation happened)
    FaultSchedule.from_spec(compiled.spec)


def test_timeline_rejects_unknown_action_and_phase():
    spans = {"calm": (0.0, 1.0)}
    with pytest.raises(ValueError, match="unknown timeline action"):
        Timeline(spans, [{"action": "meteor_strike", "phase": "calm"}])
    with pytest.raises(ValueError, match="unknown phase"):
        Timeline(spans, [{"action": "client_flap", "phase": "rush_hour"}])


def test_timeline_driver_executes_and_records_failures():
    fired = []
    driver = TimelineDriver(
        [(0.0, {"action": "publish_weights", "channel": "w"}),
         (0.2, {"action": "chaos_rule"})],
        {"publish_weights": lambda a: fired.append(a["channel"]) or "ok"},
        time_warp=2.0)
    log = driver.start().join(timeout=10)
    assert fired == ["w"]
    assert [(e["action"], e["ok"]) for e in log] == [
        ("publish_weights", True), ("chaos_rule", False)]
    assert "no handler" in log[1]["detail"]


# ---------------------------------------------------------------------------
# open-loop replayer against a no-op server
# ---------------------------------------------------------------------------

class _NoopHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length", 0)))
        body = b"ok"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def noop_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _NoopHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    srv.shutdown()


def test_open_loop_fidelity(noop_server):
    """Against an instant server the replayer must hit its schedule: every
    request lands, arrival error stays small, and the run takes roughly the
    warped trace duration (open loop = the trace sets the clock)."""
    header, records = synthesize(3, duration_s=4.0, base_rps=25.0, tenants=2)
    rp = Replayer(noop_server, time_warp=4.0, max_workers=16)
    t0 = time.perf_counter()
    outcomes = rp.run(header, records)
    elapsed = time.perf_counter() - t0
    assert len(outcomes) == len(records)
    assert all(o["code"] == 200 for o in outcomes)
    assert 0.7 <= elapsed <= 3.0  # ~1s of warped trace time + shutdown slack
    summ = summarize(outcomes, phase_spans(
        {"duration_s": 4.0, "spike_start": 0.35, "spike_end": 0.7}))
    tot = summ["total"]
    assert tot["n"] == len(records) and tot["goodput"] == 1.0
    assert tot["late_p99_s"] < 0.25  # open-loop scheduling error bound
    # streams got a TTFT; phases partition the traffic
    assert tot["ttft_p95_s"] is not None
    phase_n = sum(b["phases"][ph]["n"] for b in summ["classes"].values()
                  for ph in ("calm", "storm", "recovery"))
    assert phase_n == tot["n"]


def test_replayer_chaos_gate_drops_client_side(noop_server):
    """A seeded drop rule on replay.request.send loses the request before
    the wire: code 0 (client_dropped), nothing sent."""
    _plan.install(FaultSchedule([FaultRule.from_spec(
        {"site": "replay.request.send", "kind": "drop", "every": 1})], seed=0))
    rp = Replayer(noop_server)
    rec = {"i": 0, "t": 0.0, "cls": "interactive", "tenant": "t0",
           "route": "/", "size": 8, "stream": 0, "timeout_s": 1.0}
    out = rp._fire(rec, time.perf_counter())
    assert out["code"] == 0
    assert summarize([out])["total"]["client_dropped"] == 1


def test_summarize_buckets_outcomes():
    rows = [
        {"i": 0, "t": 0.1, "cls": "interactive", "tenant": "t0", "stream": 1,
         "code": 200, "latency_s": 0.05, "ttft_s": 0.01, "late_s": 0.001},
        {"i": 1, "t": 0.2, "cls": "interactive", "tenant": "t1", "stream": 0,
         "code": 429, "latency_s": 0.002, "ttft_s": None, "late_s": 0.001},
        {"i": 2, "t": 1.6, "cls": "batch", "tenant": "t0", "stream": 0,
         "code": 504, "latency_s": 0.9, "ttft_s": None, "late_s": 0.002},
        {"i": 3, "t": 1.7, "cls": "batch", "tenant": "t0", "stream": 0,
         "code": -1, "latency_s": 0.0, "ttft_s": None, "late_s": 0.002},
    ]
    s = summarize(rows, {"early": (0.0, 1.0), "late": (1.0, 2.0)})
    assert s["total"]["n"] == 4 and s["total"]["ok"] == 1
    assert s["total"]["shed"] == 1 and s["total"]["expired"] == 1
    assert s["total"]["errors"] == 1
    inter = s["classes"]["interactive"]
    assert inter["_total"]["goodput"] == 0.5
    assert inter["phases"]["early"]["n"] == 2
    assert inter["phases"]["late"]["n"] == 0
    assert set(inter["tenants"]) == {"t0", "t1"}
    assert s["classes"]["batch"]["phases"]["late"]["n"] == 2


# ---------------------------------------------------------------------------
# run ledger: build/gate/diff + the CLI exit codes
# ---------------------------------------------------------------------------

def _baseline_ledger():
    return _ledger.load(str(DATA / "day_in_the_life_seed0.ledger.json"))


def test_committed_ledger_passes_its_own_gates():
    led = _baseline_ledger()
    res = _ledger.gate(led)
    assert res["ok"], res
    assert {c["name"] for c in res["checks"]} >= {
        "interactive_storm_p99", "interactive_storm_goodput",
        "weight_swap_happened", "swap_blip_bounded",
        "burn_trajectory_per_objective"}
    # and it names the trace that produced it
    assert led["meta"]["trace_sha256"] == hashlib.sha256(
        (DATA / "day_in_the_life_seed0.trace.jsonl").read_bytes()).hexdigest()


def test_gate_fails_without_swap_or_on_slow_storm():
    led = _baseline_ledger()
    no_swap = copy.deepcopy(led)
    no_swap["counters"]["ckpt.publish.swaps_total"] = 0
    res = _ledger.gate(no_swap)
    assert not res["ok"]
    assert any(c["name"] == "weight_swap_happened" and not c["ok"]
               for c in res["checks"])
    slow = copy.deepcopy(led)
    slow["load"]["classes"]["interactive"]["phases"]["storm"]["p99_s"] = 9.0
    res = _ledger.gate(slow)
    assert any(c["name"] == "interactive_storm_p99" and not c["ok"]
               for c in res["checks"])


def test_report_diff_trips_on_p99_regression(tmp_path):
    base = _baseline_ledger()
    assert _ledger.diff(base, base)["ok"]  # self-diff is clean
    worse = copy.deepcopy(base)
    storm = worse["load"]["classes"]["interactive"]["phases"]["storm"]
    storm["p99_s"] = storm["p99_s"] * 2 + 0.2  # past both pct and abs margins
    res = _ledger.diff(base, worse)
    assert not res["ok"]
    assert any(r["metric"] == "p99_s" and r["bucket"] == "interactive/storm"
               for r in res["regressions"])
    # tiny wiggles below the absolute margin are NOT regressions
    wiggle = copy.deepcopy(base)
    tot = wiggle["load"]["total"]
    tot["p99_s"] = tot["p99_s"] + 0.01
    assert _ledger.diff(base, wiggle)["ok"]
    # goodput is judged on absolute drop
    starved = copy.deepcopy(base)
    starved["load"]["total"]["goodput"] = base["load"]["total"]["goodput"] - 0.2
    res = _ledger.diff(base, starved)
    assert any(r["metric"] == "goodput" for r in res["regressions"])


def test_report_cli_exit_codes(tmp_path, capsys):
    """`raytpu report diff` is the CI gate: exit 0 clean, 1 on regression."""
    from ray_tpu_torch.__main__ import main

    base_path = str(DATA / "day_in_the_life_seed0.ledger.json")
    worse = copy.deepcopy(_baseline_ledger())
    storm = worse["load"]["classes"]["interactive"]["phases"]["storm"]
    storm["p99_s"] = storm["p99_s"] * 2 + 0.2
    worse_path = str(tmp_path / "worse.json")
    _ledger.save(worse_path, worse)
    with pytest.raises(SystemExit) as e:
        main(["report", "diff", base_path, base_path])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        main(["report", "diff", base_path, worse_path])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "REGRESSION interactive/storm p99_s" in out
    # a tighter threshold flips a clean self... candidate comparison stays
    # clean, but loose overrides relax a tripped one
    with pytest.raises(SystemExit) as e:
        main(["report", "diff", base_path, worse_path,
              "--thresholds", '{"p99_latency_abs_s": 99}'])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        main(["report", "render", base_path])
    assert e.value.code in (0, None)
    rendered = capsys.readouterr().out
    assert "day_in_the_life" in rendered and "interactive/_total" in rendered
    with pytest.raises(SystemExit) as e:
        main(["report", "gate", base_path])
    assert e.value.code == 0


def test_ledger_build_and_roundtrip(tmp_path):
    led = _ledger.build(
        meta={"scenario": "unit", "seed": 1, "time_warp": 1.0, "requests": 2},
        spans={"calm": (0.0, 1.0)},
        load={"total": {"n": 2, "ok": 2, "goodput": 1.0},
              "classes": {}},
        counters={"ckpt.publish.swaps_total": 1.0})
    path = str(tmp_path / "led.json")
    _ledger.save(path, led)
    again = _ledger.load(path)
    assert again == json.loads(json.dumps(led))  # tuple/list normalization
    assert again["phases"]["calm"] == [0.0, 1.0]
    with pytest.raises(ValueError, match="not a raytpu-report"):
        bad = tmp_path / "bad.json"
        bad.write_text('{"format": "nope"}')
        _ledger.load(str(bad))


# ---------------------------------------------------------------------------
# SLO burn-trajectory history ring
# ---------------------------------------------------------------------------

def test_slo_history_ring_bounded_and_counted():
    tr = SloTracker(Objective(name="u", metric="availability",
                              fast_window_s=1.0, slow_window_s=5.0),
                    max_history=4)
    for i in range(7):
        tr.observe(float(i), good=90.0 + i, total=100.0 + i)
        tr.evaluate(float(i))
    rows = tr.history_rows()
    assert len(rows["points"]) == 4          # ring holds only the tail
    assert rows["dropped"] == 3              # counted trim, not silent
    assert rows["points"][-1]["ts"] == 6.0
    assert {"ts", "burn_fast", "burn_slow", "state"} <= set(rows["points"][0])


def test_slo_engine_history_shape():
    eng = SloEngine()
    eng.register({"name": "avail", "metric": "availability",
                  "fast_window_s": 1.0, "slow_window_s": 5.0})
    series = [
        {"name": "serve.request.latency_s", "tags": {}, "n": 100,
         "buckets": [1.0], "counts": [100]},
        {"name": "serve.request.shed_total", "tags": {}, "value": 50.0},
    ]
    for i in range(3):
        eng.ingest(float(i), series)
    hist = eng.history()
    assert set(hist) == {"avail"}
    assert len(hist["avail"]["points"]) == 3
    assert hist["avail"]["dropped"] == 0


# ---------------------------------------------------------------------------
# the port held to ray_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,params", [
    (0, None), (1, None), (7, {"duration_s": 4.0, "base_rps": 30.0}),
    (3, {"duration_s": 4.0, "base_rps": 25.0, "tenants": 2}),
])
def test_synthesizer_matches_ray_tpu(seed, params):
    from ray_tpu import replay as ref

    kw = default_params(quick=True) if params is None else params
    assert kw == (ref.default_params(quick=True) if params is None else params)
    mine = dumps_trace(*synthesize(seed, **kw))
    theirs = ref.dumps_trace(*ref.synthesize(seed, **kw))
    assert mine == theirs
    if seed == 0 and params is None:
        assert mine == (DATA / "day_in_the_life_seed0.trace.jsonl").read_bytes()


def _perturbed_ledgers():
    base = _baseline_ledger()
    out = {"base": base}
    out["no_swap"] = copy.deepcopy(base)
    out["no_swap"]["counters"]["ckpt.publish.swaps_total"] = 0
    out["slow_storm"] = copy.deepcopy(base)
    out["slow_storm"]["load"]["classes"]["interactive"]["phases"]["storm"]["p99_s"] = 9.0
    out["starved"] = copy.deepcopy(base)
    out["starved"]["load"]["total"]["goodput"] -= 0.2
    out["wiggle"] = copy.deepcopy(base)
    out["wiggle"]["load"]["total"]["p99_s"] += 0.01
    return out


def test_ledger_gate_diff_render_match_ray_tpu(capsys):
    from ray_tpu.obs import ledger as ref

    leds = _perturbed_ledgers()
    base = leds["base"]
    assert _ledger.load(str(DATA / "day_in_the_life_seed0.ledger.json")) == ref.load(
        str(DATA / "day_in_the_life_seed0.ledger.json"))
    for name, led in leds.items():
        assert _ledger.gate(led) == ref.gate(led), name
        assert _ledger.diff(base, led) == ref.diff(base, led), name
        assert _ledger.diff(led, base) == ref.diff(led, base), name
        assert _ledger.render(led) == ref.render(led), name
    thr = {"p99_latency_abs_s": 99}
    assert _ledger.diff(base, leds["slow_storm"], thr) == ref.diff(base, leds["slow_storm"], thr)
    led = _ledger.build(meta={"scenario": "unit", "seed": 1}, spans={"calm": (0.0, 1.0)},
                        load={"total": {"n": 1, "ok": 1, "goodput": 1.0}, "classes": {}},
                        counters={"x": 1.0})
    assert json.dumps(led, sort_keys=True) == json.dumps(ref.build(
        meta={"scenario": "unit", "seed": 1}, spans={"calm": (0.0, 1.0)},
        load={"total": {"n": 1, "ok": 1, "goodput": 1.0}, "classes": {}},
        counters={"x": 1.0}), sort_keys=True)
