"""The port's observability plane (flight recorder, SLOs, autopsy, loop lag):
the cases of ``tests/test_obs_plane.py`` on port clusters.

Production observability plane: flight recorder, SLO burn
rates, critical-path autopsy, loop-lag probe.

Layers, cheapest first:
  * pure units (no cluster): ring bounds + counted evictions, dump file
    round trip, the closed dump-trigger catalog (AST cross-check, same
    pattern as the chaos site catalog), burn-rate window math on synthetic
    cumulative series, the multi-window alert FSM, autopsy hop arithmetic
    on a synthetic trace, the daemon harvest path, controller registries;
  * one live serve cluster: autopsy on a real proxy->replica request
    (hop-sum vs wall), trace reassembly from live recorders, SLO
    register/evaluate/unregister round trip through the serve API.
"""
from __future__ import annotations

import ast
import asyncio
import json
import os
import time
import types
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.obs import autopsy as obs_autopsy
from ray_tpu_torch.obs import flight as obs_flight
from ray_tpu_torch.obs import health as obs_health
from ray_tpu_torch.obs import slo as obs_slo
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


# ---------------------------------------------------------------------------
# flight recorder: ring semantics + dump files (no cluster)
# ---------------------------------------------------------------------------

def test_ring_bounds_and_counted_evictions():
    rec = obs_flight.FlightRecorder(capacity=16)
    for i in range(40):
        rec.record("unit.tick", i=i)
    st = rec.stats()
    assert st["len"] == 16 and st["capacity"] == 16
    assert st["events_evicted"] == 24  # every displaced event is counted
    # The survivors are the NEWEST 16, each stamped with the shared clock.
    held = rec.snapshot()
    assert [e["i"] for e in held] == list(range(24, 40))
    assert all(e["ts"] > 0 for e in held)


def test_configure_shrink_counts_evictions():
    rec = obs_flight.FlightRecorder(capacity=64)
    for i in range(64):
        rec.record("unit.tick", i=i)
    rec.configure(capacity=16)
    st = rec.stats()
    assert st["len"] == 16 and st["events_evicted"] == 48


def test_dump_roundtrip_and_autopsy(tmp_path):
    rec = obs_flight.FlightRecorder(capacity=64)
    rec.configure(proc_id="unitproc", dump_dir=str(tmp_path))
    seen_hook = []
    rec.set_dump_hook(lambda path, trigger: seen_hook.append((path, trigger)))
    # One finished task and one task the process "died" holding.
    t = 100.0
    rec.absorb({"ts": t + 0.0, "kind": "task_submitted", "task_id": "t-done", "attempt": 0})
    rec.absorb({"ts": t + 0.1, "kind": "task_exec_start", "task_id": "t-done", "attempt": 0})
    rec.absorb({"ts": t + 0.2, "kind": "task_finished", "task_id": "t-done", "attempt": 0})
    rec.absorb({"ts": t + 0.3, "kind": "task_submitted", "task_id": "t-kill", "attempt": 1})
    rec.absorb({"ts": t + 0.4, "kind": "task_exec_start", "task_id": "t-kill", "attempt": 1})
    path = rec.dump("manual", reason="unit round trip")
    assert path and os.path.dirname(path) == str(tmp_path)
    assert seen_hook == [(path, "manual")]

    header, events = obs_flight.load_dump(path)
    assert header["magic"] == obs_flight.DUMP_MAGIC
    assert header["version"] == obs_flight.DUMP_VERSION
    assert header["proc_id"] == "unitproc"
    assert header["trigger"] == "manual" and header["reason"] == "unit round trip"
    assert header["events"] == 5 and len(events) == 5

    aut = obs_flight.dump_autopsy(events)
    assert aut["tasks"] == 2 and aut["terminal"] == 1
    running = [r for r in aut["in_flight"] if r.get("state") == "RUNNING"]
    assert [r["task_id"] for r in running] == ["t-kill"]
    assert aut["event_counts"]["task_exec_start"] == 2

    # Determinism form: ids/timestamps stripped, kinds kept in order.
    norm = obs_flight.normalize_dump(events)
    assert [k for k, _ in norm] == ["task_submitted", "task_exec_start",
                                    "task_finished", "task_submitted",
                                    "task_exec_start"]


def test_dump_rate_limit_and_unknown_trigger(tmp_path):
    rec = obs_flight.FlightRecorder(capacity=16)
    rec.configure(proc_id="ratelim", dump_dir=str(tmp_path))
    rec.record("unit.tick")
    first = rec.dump("tpu.preempt", reason="a")
    assert first is not None
    # Same trigger inside the rate-limit window: suppressed.
    assert rec.dump("tpu.preempt", reason="b") is None
    # "manual" is exempt — an operator asking twice means it twice.
    assert rec.dump("manual") is not None
    assert rec.dump("manual") is not None
    with pytest.raises(ValueError, match="unknown flight dump trigger"):
        rec.dump("made.up.trigger")
    # Disabled recorder records nothing and dumps nothing.
    rec.enabled = False
    rec.record("unit.after")
    assert rec.dump("manual") is None
    assert all(e.get("kind") != "unit.after" for e in rec.snapshot())


def test_truncated_dump_fails_to_parse(tmp_path):
    rec = obs_flight.FlightRecorder(capacity=16)
    rec.configure(proc_id="trunc", dump_dir=str(tmp_path))
    for i in range(4):
        rec.record("unit.tick", i=i)
    path = rec.dump("manual")
    lines = open(path).read().splitlines()
    open(path, "w").write("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        obs_flight.load_dump(path)


def test_dump_timeline_renders_through_shared_renderer(tmp_path):
    """Dumps render through the SAME chrome-trace path as export_timeline —
    one renderer for live clusters and black boxes."""
    rec = obs_flight.FlightRecorder(capacity=16)
    rec.configure(proc_id="tl", dump_dir=str(tmp_path))
    rec.absorb({"ts": 10.0, "kind": "span", "name": "unit.span", "dur": 0.5,
                "trace_id": "tr1", "span_id": "s1", "parent_id": "",
                "worker": "w1"})
    path = rec.dump("manual")
    out = str(tmp_path / "timeline.json")
    n = obs_flight.export_dump_timeline(path, out)
    assert n >= 1
    data = json.load(open(out))
    assert any(e.get("name") == "unit.span" for e in data["traceEvents"])


def test_dump_trigger_catalog():
    """The closed-catalog cross-check the flight.py docstring promises: every
    `*.dump("<literal>")` call site in the tree uses a registered trigger,
    and every registered trigger has at least one call site. Same two-way
    discipline as the chaos site catalog (test_graftlint.py)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(obs_flight.__file__)))
    used: dict[str, set] = {}
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".") and d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "dump"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                # Only flight-recorder receivers: the conventional aliases
                # (`flight.dump`, `_flight.dump`) plus the recorder's own
                # `self.dump`. pickle.dump(obj, f) never passes a str first.
                recv = node.func.value
                if not (isinstance(recv, ast.Name)
                        and recv.id in ("flight", "_flight", "self")):
                    continue
                used.setdefault(node.args[0].value, set()).add(
                    os.path.relpath(path, pkg_root))
    unknown = set(used) - set(obs_flight.TRIGGERS)
    assert not unknown, (
        f"dump call sites use unregistered triggers {sorted(unknown)} "
        f"(sites: { {t: sorted(used[t]) for t in unknown} }); "
        "register them in obs.flight.TRIGGERS")
    unused = set(obs_flight.TRIGGERS) - set(used)
    assert not unused, (
        f"TRIGGERS entries with no call site anywhere in the tree: "
        f"{sorted(unused)} — dead catalog entries are lies")


def test_deadline_storm_detector_dumps_once(tmp_path):
    rec = obs_flight.FlightRecorder(capacity=64)
    rec.configure(proc_id="storm", dump_dir=str(tmp_path),
                  storm_expiries=5, storm_window_s=60.0)
    for _ in range(5):
        rec.note_expiry()
    assert rec.dumps_written == 1  # 5th expiry inside the window tripped it
    # The burst continues: the per-trigger rate limit holds it to one dump.
    for _ in range(5):
        rec.note_expiry()
    assert rec.dumps_written == 1


# ---------------------------------------------------------------------------
# daemon harvest round trip (the dump-on-kill path, minus the cluster; the
# live end-to-end is the tier-1 chaos smoke test_chaos.py::worker_kill)
# ---------------------------------------------------------------------------

def _offline_controller():
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.controller import Controller

    return Controller(Config())


def test_dump_on_kill_harvest_roundtrip(tmp_path):
    """A dying worker's last-gasp worker.death dump lands in
    <log_dir>/flight; the daemon harvest picks it up exactly once and the
    controller registry + dump autopsy attribute the in-flight task."""
    from ray_tpu_torch.core.node import NodeDaemon

    worker_id = "deadbeefcafe0123"
    fdir = tmp_path / "flight"
    rec = obs_flight.FlightRecorder(capacity=64)
    rec.configure(proc_id=worker_id[:12], dump_dir=str(fdir))
    rec.absorb({"ts": 50.0, "kind": "task_submitted", "task_id": "t-kill", "attempt": 0})
    rec.absorb({"ts": 50.1, "kind": "task_exec_start", "task_id": "t-kill", "attempt": 0})
    path = rec.dump("worker.death", reason="chaos kill")
    assert path and os.path.dirname(path) == str(fdir)

    daemon = types.SimpleNamespace(log_dir=str(tmp_path), _flight_reported=set())
    harvested = NodeDaemon._harvest_flight_dumps(daemon, worker_id)
    assert harvested == [path]
    # Idempotent: the same file is never reported twice.
    assert NodeDaemon._harvest_flight_dumps(daemon, worker_id) == []

    ctl = _offline_controller()
    ctl.handle_report_flight_dump(None, {
        "proc": worker_id[:12], "path": harvested[0],
        "trigger": "worker.death", "reason": "worker process died"})
    out = ctl.handle_list_flight_dumps(None, {})
    assert out["dropped"] == 0
    assert out["dumps"][0]["path"] == path
    assert out["dumps"][0]["trigger"] == "worker.death"
    # The controller event log points at the same artifact (/api/events).
    assert any(e["kind"] == "flight_dump" and e.get("path") == path
               for e in ctl.events)

    header, events = obs_flight.load_dump(out["dumps"][0]["path"])
    assert header["trigger"] == "worker.death"
    aut = obs_flight.dump_autopsy(events)
    running = [r for r in aut["in_flight"] if r.get("state") == "RUNNING"]
    assert [r["task_id"] for r in running] == ["t-kill"]


def test_flight_dump_registry_bounded():
    ctl = _offline_controller()
    ctl.MAX_FLIGHT_DUMPS = 3
    for i in range(5):
        ctl.handle_report_flight_dump(None, {
            "proc": f"p{i}", "path": f"/tmp/d{i}.jsonl", "trigger": "manual"})
    assert len(ctl.flight_dumps) == 3
    assert ctl.flight_dumps_dropped == 2  # counted trim, newest kept
    out = ctl.handle_list_flight_dumps(None, {})
    assert out["dropped"] == 2
    assert [d["proc"] for d in out["dumps"]] == ["p4", "p3", "p2"]


def test_trace_eviction_names_victims():
    """Index overflow logs WHICH trace_ids were lost — a later 'trace not
    found' can then distinguish evicted-but-recoverable from never-existed."""
    ctl = _offline_controller()
    ctl.MAX_TRACES = 4
    for i in range(6):
        ctl._index_trace_event(f"tr{i}", {
            "ts": float(i), "kind": "span", "name": "serve.request",
            "trace_id": f"tr{i}", "span_id": f"s{i}", "parent_id": "",
            "worker": "w", "dur": 0.1})
    assert ctl.traces_evicted == 2
    evs = [e for e in ctl.events if e["kind"] == "trace_evicted"]
    assert [e["trace_id"] for e in evs] == ["tr0", "tr1"]
    assert all(e["name"] == "serve.request" for e in evs)
    assert set(ctl.traces) == {"tr2", "tr3", "tr4", "tr5"}


# ---------------------------------------------------------------------------
# SLO burn-rate math (synthetic cumulative series; no cluster)
# ---------------------------------------------------------------------------

def test_burn_rate_window_math():
    br = obs_slo.burn_rate
    assert br([], now=10.0, window_s=5.0, budget=0.01) is None
    # 10% bad over the window at a 1% budget: burn 10.
    samples = [(0.0, 0.0, 0.0), (10.0, 90.0, 100.0)]
    assert br(samples, now=10.0, window_s=10.0, budget=0.01) == pytest.approx(10.0)
    # No traffic inside the window (cumulative counters flat): None, not 0 —
    # an idle deployment is not violating its SLO.
    flat = [(0.0, 90.0, 100.0), (10.0, 90.0, 100.0)]
    assert br(flat, now=10.0, window_s=5.0, budget=0.01) is None
    # Baseline selection: the last sample AT/BEFORE the window start, so the
    # delta covers exactly the window. Bad burst before the window start
    # must not leak in.
    samples = [
        (0.0, 0.0, 0.0),
        (5.0, 50.0, 100.0),   # 50 bad, all before the window
        (10.0, 150.0, 200.0),  # window [5, 10]: 100 good / 100 total
    ]
    assert br(samples, now=10.0, window_s=5.0, budget=0.01) == pytest.approx(0.0)
    # ...and with bad traffic only inside the window: full attribution.
    samples = [(0.0, 0.0, 0.0), (5.0, 100.0, 100.0), (10.0, 150.0, 200.0)]
    assert br(samples, now=10.0, window_s=5.0, budget=0.1) == pytest.approx(5.0)


def test_multi_window_alert_fsm():
    """SRE-workbook shape: a fresh burst trips the fast window first
    (BURNING), sustained burn trips both (ALERT), recovery returns to OK.
    1 Hz samples, availability budget 5%, threshold 5, windows 4s/10s."""
    o = obs_slo.Objective(name="fsm", metric="availability", budget=0.05,
                          fast_window_s=4.0, slow_window_s=10.0,
                          burn_threshold=5.0)
    tr = obs_slo.SloTracker(o)
    good = total = 0.0
    states = {}
    for t in range(0, 22):
        if t <= 6:
            good += 10.0
            total += 10.0     # healthy: 10 good/s
        elif t <= 12:
            good += 5.0
            total += 10.0     # outage: 50% bad => burn 10 at 5% budget
        else:
            good += 10.0
            total += 10.0     # recovered
        tr.observe(float(t), good, total)
        states[t] = tr.evaluate(float(t))["state"]
    # t=8: fast window [4,8] is half-bad (burn 10 >= 5) but the slow window
    # still averages mostly-healthy traffic => BURNING, not yet ALERT.
    assert states[8] == obs_slo.BURNING
    # t=12: both windows over threshold => ALERT, counted once.
    assert states[12] == obs_slo.ALERT
    assert tr.alerts_fired == 1
    # Recovery: the fast window goes clean well before the slow one.
    assert states[21] == obs_slo.OK
    # Re-judging a steady state does not refire the alert.
    assert tr.alerts_fired == 1


def test_objective_validation_and_budget_fraction():
    with pytest.raises(ValueError, match="metric"):
        obs_slo.Objective(name="x", metric="throughput")
    with pytest.raises(ValueError, match="needs a name"):
        obs_slo.Objective(name="")
    with pytest.raises(ValueError, match="fast window"):
        obs_slo.Objective(name="x", fast_window_s=300.0, slow_window_s=60.0)
    # latency budget derives from the compliance quantile; availability
    # defaults to 0.1% unless given explicitly.
    assert obs_slo.Objective(name="l", quantile=0.99).budget_fraction == pytest.approx(0.01)
    assert obs_slo.Objective(name="a", metric="availability").budget_fraction == pytest.approx(0.001)
    assert obs_slo.Objective(name="b", metric="availability",
                             budget=0.05).budget_fraction == pytest.approx(0.05)


def _hist(name, tags, buckets, counts, n):
    return {"name": name, "kind": "histogram", "tags": tags,
            "buckets": buckets, "counts": counts, "n": n,
            "value": 0.0, "ts": 0.0}


def _ctr(name, tags, value):
    return {"name": name, "kind": "counter", "tags": tags,
            "value": value, "ts": 0.0}


def test_slo_engine_extract_and_gauges():
    eng = obs_slo.SloEngine()
    eng.register({"name": "lat", "metric": "latency", "target": 0.1,
                  "quantile": 0.9, "deployment": "D",
                  "fast_window_s": 5.0, "slow_window_s": 30.0,
                  "burn_threshold": 2.0})
    eng.register({"name": "avail", "metric": "availability", "budget": 0.1,
                  "fast_window_s": 5.0, "slow_window_s": 30.0,
                  "burn_threshold": 2.0})
    buckets = [0.01, 0.1, 1.0]

    def series(n_fast, n_slow, shed):
        return [
            # In scope for "lat": deployment D; 0.1s boundary counts as good.
            _hist("serve.request.latency_s", {"app": "a", "deployment": "D"},
                  buckets, [n_fast // 2, n_fast - n_fast // 2, n_slow], n_fast + n_slow),
            # Out of scope for "lat" (other deployment), still availability-good.
            _hist("serve.request.latency_s", {"app": "a", "deployment": "E"},
                  buckets, [5, 0, 0], 5),
            _ctr("serve.request.shed_total", {"reason": "q", "class": "batch"}, shed),
        ]

    t0 = 100.0
    assert eng.ingest(t0, series(0, 0, 0)) == []  # no traffic: no changes
    # 20 requests on D, every one over the 0.1s target; 10% budget => the
    # latency objective burns 10x; availability sees 25 good vs 8 shed.
    changes = eng.ingest(t0 + 1.0, series(0, 20, 8))
    changed_names = {c["objective"]["name"] for c in changes}
    assert "lat" in changed_names and "avail" in changed_names
    by_name = {r["objective"]["name"]: r for r in eng.status()}
    assert by_name["lat"]["state"] == obs_slo.ALERT
    assert by_name["lat"]["burn_fast"] == pytest.approx(10.0)
    assert by_name["avail"]["state"] == obs_slo.ALERT
    # window delta vs the baseline sample: 20 new good, 8 new shed => bad
    # fraction 8/28 at a 10% budget
    assert by_name["avail"]["burn_fast"] == pytest.approx((8 / 28) / 0.1)

    gauges = eng.gauges(t0 + 1.0)
    names = {(g["name"], g["tags"].get("objective"), g["tags"].get("window"))
             for g in gauges}
    assert ("slo.burn_rate", "lat", "fast") in names
    assert ("slo.state", "lat", None) in names
    state_vals = {g["tags"]["objective"]: g["value"] for g in gauges
                  if g["name"] == "slo.state"}
    assert state_vals == {"lat": 2.0, "avail": 2.0}

    summ = eng.summary()
    assert summ["total"] == 2 and set(summ["alert"]) == {"lat", "avail"}
    assert eng.unregister("lat") and not eng.unregister("lat")
    assert [r["objective"]["name"] for r in eng.status()] == ["avail"]


# ---------------------------------------------------------------------------
# autopsy hop arithmetic (synthetic trace; no cluster)
# ---------------------------------------------------------------------------

def _synthetic_trace():
    t0 = 100.0
    return [
        {"ts": t0, "kind": "span", "name": "serve.request", "dur": 1.0,
         "trace_id": "tr", "span_id": "root", "parent_id": "", "worker": "proxy"},
        # handle began waiting at t0+0.10, admitted at t0+0.25 (waited 0.15)
        {"ts": t0 + 0.25, "kind": "event", "name": "qos.admitted",
         "attrs": {"waited_s": 0.15}, "trace_id": "tr", "worker": "proxy"},
        {"ts": t0 + 0.30, "kind": "task_submitted", "task_id": "t1",
         "trace_id": "tr", "worker": "proxy"},
        {"ts": t0 + 0.35, "kind": "task_dispatched", "task_id": "t1",
         "trace_id": "tr", "worker": "proxy"},
        {"ts": t0 + 0.40, "kind": "task_exec_start", "task_id": "t1",
         "trace_id": "tr", "span_id": "exec", "parent_id": "root",
         "worker": "replica"},
        {"ts": t0 + 0.40, "kind": "span", "name": "serve.replica.Pinger",
         "dur": 0.5, "trace_id": "tr", "span_id": "rep", "parent_id": "root",
         "worker": "replica"},
    ]


def test_autopsy_synthetic_hops_sum_to_wall():
    a = obs_autopsy.autopsy(_synthetic_trace())
    assert a["root"] == "serve.request" and a["deployment"] == "Pinger"
    assert a["total_s"] == pytest.approx(1.0)
    hops = {h["hop"]: h["dur_s"] for h in a["hops"]}
    assert hops == {
        "proxy": pytest.approx(0.10), "admission": pytest.approx(0.15),
        "dispatch": pytest.approx(0.05), "wire": pytest.approx(0.05),
        "exec": pytest.approx(0.50), "drain": pytest.approx(0.10),
    }
    assert set(hops) == set(obs_autopsy.HOPS)
    assert a["attributed_s"] == pytest.approx(0.95)
    assert a["unattributed_s"] == pytest.approx(0.05)
    # hop-sum + residue == wall, exactly: the decomposition never invents time.
    assert a["attributed_s"] + a["unattributed_s"] == pytest.approx(a["total_s"])
    assert all(a["anchors"].values())


def test_autopsy_tolerates_partial_traces():
    events = [e for e in _synthetic_trace()
              if e.get("kind") not in ("task_submitted", "task_dispatched")]
    a = obs_autopsy.autopsy(events)
    hop_names = [h["hop"] for h in a["hops"]]
    # Missing anchors drop their hops (no guessing); the rest survive.
    assert "dispatch" not in hop_names and "wire" not in hop_names
    assert {"proxy", "admission", "exec", "drain"} <= set(hop_names)
    assert not a["anchors"]["submitted"] and a["anchors"]["replica_span"]
    assert obs_autopsy.autopsy([]) == {"error": "no spans in trace",
                                       "hops": [], "total_s": 0.0}


def test_autopsy_aggregate_shares():
    auts = [obs_autopsy.autopsy(_synthetic_trace()) for _ in range(3)]
    agg = obs_autopsy.aggregate(auts)
    assert set(agg) == {"Pinger"}
    p = agg["Pinger"]
    assert p["requests"] == 3 and p["total_s"] == pytest.approx(3.0)
    assert p["hops"]["exec"]["total_s"] == pytest.approx(1.5)
    assert p["hops"]["exec"]["share"] == pytest.approx(0.5)
    assert p["hops"]["exec"]["max_s"] == pytest.approx(0.5)
    assert p["unattributed_s"] == pytest.approx(0.15)


# ---------------------------------------------------------------------------
# loop-lag probe: injected stall -> spike event with thread dump
# ---------------------------------------------------------------------------

def test_loop_lag_probe_fires_on_stall():
    probe = obs_health.LoopLagProbe("obs-test-loop", interval_s=0.05,
                                    spike_s=0.2)
    loop = asyncio.new_event_loop()
    try:
        # A sync callback that blocks the loop: every probe sleep in flight
        # overshoots by the stall length.
        loop.call_later(0.1, lambda: time.sleep(0.5))

        async def run_probe():
            task = asyncio.ensure_future(probe.run())
            await asyncio.sleep(0.9)
            task.cancel()

        loop.run_until_complete(run_probe())
    finally:
        loop.close()
    assert probe.spikes >= 1
    spikes = [e for e in obs_flight.recorder().snapshot()
              if e.get("kind") == "loop.lag_spike"
              and e.get("loop") == "obs-test-loop"]
    assert spikes, "no lag-spike event reached the flight recorder"
    assert spikes[-1]["lag_s"] >= 0.2
    assert spikes[-1]["threads"] and all("stack" in t for t in spikes[-1]["threads"])
    # The lag histogram reports through the standard metrics pipeline.
    from ray_tpu_torch.util import metrics as _metrics

    recs = [r for r in _metrics.snapshot()
            if r["name"] == "runtime.loop.lag_s"
            and r["tags"].get("loop") == "obs-test-loop"]
    assert recs and recs[0]["n"] >= 1


# ---------------------------------------------------------------------------
# live cluster: autopsy on a real request, trace reassembly, SLO round trip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_serve_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=True)

    @serve.deployment
    class Pinger:
        def __call__(self, request):
            time.sleep(0.05)
            return {"pong": True}

    serve.run(Pinger.bind(), name="obs_app", route_prefix="/obs")
    yield serve.http_port()
    serve.shutdown()
    rt.shutdown()


def _get(port, traced=False):
    headers = {"x-trace": "1"} if traced else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}/obs", headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def _controller_call(method, payload):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    return core._run(core.controller.call(method, payload))


def test_autopsy_on_real_request_and_reassembly(obs_serve_cluster):
    port = obs_serve_cluster
    assert _get(port, traced=True) == {"pong": True}

    # Find the request's trace by its root span name.
    deadline = time.time() + 45
    trace_id = None
    while time.time() < deadline and trace_id is None:
        traces = _controller_call("list_traces", {"q": "serve.request"})
        if traces:
            trace_id = traces[0]["trace_id"]
            break
        time.sleep(0.5)
    assert trace_id, "no serve.request trace was indexed"

    # All the autopsy anchors flush on their own reporter ticks.
    def anchored(evs):
        kinds = {e.get("kind") for e in evs}
        return ("task_exec_start" in kinds
                and any(str(e.get("name", "")).startswith("serve.replica.")
                        for e in evs)
                and any(e.get("name") == "qos.admitted" for e in evs))

    deadline = time.time() + 90
    while time.time() < deadline:
        events = _controller_call("get_trace", {"trace_id": trace_id})
        if anchored(events):
            break
        time.sleep(0.5)
    assert anchored(events), f"anchors never landed: {sorted({e.get('kind') for e in events})}"

    from ray_tpu_torch import obs

    a = obs.trace_autopsy(trace_id)
    assert not a.get("error"), a
    assert a["deployment"] == "Pinger"
    hops = {h["hop"]: h["dur_s"] for h in a["hops"]}
    assert "exec" in hops and hops["exec"] >= 0.04  # the handler's sleep
    assert set(hops) <= set(obs_autopsy.HOPS)
    assert a["total_s"] >= hops["exec"]
    # Hop-sum ~= wall: attribution never exceeds the request's wall time by
    # more than clock-skew noise, and the residue closes the books.
    assert a["attributed_s"] <= a["total_s"] + 0.05
    assert a["attributed_s"] + a["unattributed_s"] == pytest.approx(a["total_s"], abs=0.06)
    assert a["anchors"]["replica_span"] and a["anchors"]["exec_start"]

    # Per-deployment rollup sees the same request.
    summary = obs.autopsy_summary()
    assert "Pinger" in summary
    assert summary["Pinger"]["requests"] >= 1
    assert summary["Pinger"]["hops"]["exec"]["share"] > 0

    # Full-trace reassembly from live flight recorders: at least one live
    # ring still holds the story, merged with the surviving index slice.
    res = obs.collect_flight_trace(trace_id)
    assert res["indexed"] and not res["evicted"]
    assert res["sources"] >= 1, res
    assert any(e.get("name") == "serve.request" and e.get("kind") == "span"
               for e in res["events"])
    assert res["events"] == sorted(res["events"], key=lambda e: e.get("ts", 0.0))


def test_slo_register_roundtrip_on_live_cluster(obs_serve_cluster):
    port = obs_serve_cluster
    spec = {"name": "obs-lat", "metric": "latency", "target": 5.0,
            "quantile": 0.5, "deployment": "Pinger",
            "fast_window_s": 5.0, "slow_window_s": 30.0,
            "burn_threshold": 10.0}
    obj = serve.register_slo(spec)
    assert obj["name"] == "obs-lat" and obj["deployment"] == "Pinger"
    with pytest.raises(ValueError, match="metric"):
        serve.register_slo({"name": "bad", "metric": "nope"})
    try:
        # Let the evaluator take a baseline sample, then add traffic so the
        # windows see a cumulative delta.
        time.sleep(1.5)
        for _ in range(5):
            assert _get(port) == {"pong": True}
        deadline = time.time() + 30
        row = None
        while time.time() < deadline:
            rows = serve.slo_status()
            row = next((r for r in rows if r["objective"]["name"] == "obs-lat"), None)
            if row and row["burn_fast"] is not None:
                break
            time.sleep(0.3)
        assert row, "objective vanished from slo_status"
        assert row["burn_fast"] is not None, \
            "evaluator never saw the deployment's traffic (scope extraction broke)"
        # 50ms handlers against a 5s target: zero budget burn, state ok.
        assert row["burn_fast"] == pytest.approx(0.0)
        assert row["state"] == obs_slo.OK and row["alerts_fired"] == 0

        # The engine's gauges ride the standard merged metrics pipeline.
        series = _controller_call("get_metrics", {})
        states = [r for r in series if r["name"] == "slo.state"
                  and r["tags"].get("objective") == "obs-lat"]
        assert states and states[0]["value"] == 0.0
        assert states[0]["tags"].get("reporter") == "controller"

        summ = _controller_call("slo_summary", {})
        assert summ["total"] >= 1 and "obs-lat" not in summ["alert"]
        evs = _controller_call("get_events", {"limit": 2000})
        assert any(e.get("kind") == "slo_registered"
                   and e.get("objective") == "obs-lat" for e in evs)
    finally:
        assert serve.unregister_slo("obs-lat") is True
    assert all(r["objective"]["name"] != "obs-lat" for r in serve.slo_status())
