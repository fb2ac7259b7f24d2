"""Chaos plane in the port (``ray_tpu_torch.chaos``): seeded deterministic
fault injection + scenario runner; ``tests/test_chaos.py`` against the port.

Reference analogue: the nightly chaos_test suites (kill raylets/workers on a
wall-clock schedule). Here every fault is a pure function of
(seed, rule, hit-counter), so these tests can assert REPLAY: the same seed
reproduces the identical injection sequence, diffed across two real runs.

Tier-1 keeps the unit layer + one fast seeded worker-kill smoke scenario +
the replay-diff; the full five-scenario battery is the `-m slow` soak.

One fixture more than the reference's file: ``clean_plan`` starts a test
from an empty injection log (``uninstall`` leaves the log of an earlier
schedule in place), so the disabled-gate case does not depend on which
tests ran before it in the process.
"""
from __future__ import annotations

import json

import pytest

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401
from ray_tpu_torch.chaos import plan as _plan
from ray_tpu_torch.chaos.plan import ChaosError, FaultRule, FaultSchedule
from ray_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario


@pytest.fixture(autouse=True)
def _chaos_clean():
    """Every test starts and ends with the chaos plane disarmed — an armed
    schedule leaking out of a test would inject faults into later modules."""
    _plan.uninstall()
    yield
    _plan.uninstall()


@pytest.fixture
def clean_plan():
    """An empty injection log and no schedule: installing an empty schedule
    clears the log, and uninstalling it disarms the gate."""
    _plan.install(FaultSchedule([], seed=0))
    _plan.uninstall()


def _schedule(rules, seed=0):
    return FaultSchedule([FaultRule.from_spec(r) for r in rules], seed=seed)


# ---------------------------------------------------------------------------
# the gate + schedule mechanics (no cluster)
# ---------------------------------------------------------------------------

def test_gate_disabled_path_returns_none(clean_plan):
    assert _plan.active() is None
    assert _plan.maybe_inject("rpc.frame.send") is None
    assert _plan.injection_log() == []


def test_nth_hit_fires_exactly_once():
    _plan.install(_schedule([{"site": "rpc.frame.send", "kind": "drop", "nth": 3}]))
    fired = [_plan.maybe_inject("rpc.frame.send") for _ in range(6)]
    assert [f.kind if f else None for f in fired] == [None, None, "drop", None, None, None]
    assert _plan.injection_log(normalize=True) == [
        {"site": "rpc.frame.send", "kind": "drop", "rule": 0, "hit": 3}
    ]


def test_every_and_max_faults():
    _plan.install(_schedule([
        {"site": "worker.exec", "kind": "error", "every": 2, "max_faults": 2}
    ]))
    fired = [_plan.maybe_inject("worker.exec") is not None for _ in range(8)]
    assert fired == [False, True, False, True, False, False, False, False]


def test_pattern_and_ctx_matching():
    _plan.install(_schedule([
        {"site": "node.*", "kind": "error", "ctx": {"source": "nodeB"}},
    ]))
    assert _plan.maybe_inject("node.pull.source", source="nodeA") is None
    assert _plan.maybe_inject("rpc.frame.send", source="nodeB") is None  # pattern miss
    f = _plan.maybe_inject("node.pull.source", source="nodeB")
    assert f is not None and f.kind == "error"
    # ctx-filtered misses do not consume the rule's hit counter
    assert f.hit == 1


def test_probability_is_seed_deterministic():
    def decisions(seed):
        _plan.install(_schedule(
            # wildcard pattern: synthetic sites validate only when concrete
            [{"site": "s.p*", "kind": "drop", "p": 0.5}], seed=seed
        ))
        return [
            _plan.maybe_inject("s.p") is not None
            for _ in range(200)
        ]

    a, b, c = decisions(42), decisions(42), decisions(7)
    assert a == b, "same seed must replay the identical decision sequence"
    assert a != c, "different seeds must differ (2^-200 false-failure odds)"
    assert 40 < sum(a) < 160, "p=0.5 should fire roughly half the time"


def test_first_matching_rule_wins_and_counters_are_per_rule():
    _plan.install(_schedule([
        {"site": "a.*", "kind": "drop", "nth": 2},
        {"site": "a.x*", "kind": "error"},
    ]))
    f1 = _plan.maybe_inject("a.x")  # rule0 hit1 (no fire), rule1 hit1 fires
    f2 = _plan.maybe_inject("a.x")  # rule0 hit2 fires first
    assert (f1.rule_index, f1.kind) == (1, "error")
    assert (f2.rule_index, f2.kind) == (0, "drop")


def test_schedule_validation_rejects_typos():
    with pytest.raises(ValueError, match="unknown chaos site"):
        _schedule([{"site": "rpc.frame.snd", "kind": "drop"}])
    with pytest.raises(ValueError, match="does not support kind"):
        _schedule([{"site": "rpc.frame.send", "kind": "evict"}])
    with pytest.raises(ValueError, match="unknown fault-rule keys"):
        _schedule([{"site": "rpc.frame.send", "kind": "drop", "nthh": 1}])
    # wildcards validate at runtime, not compile time
    _schedule([{"site": "rpc.*", "kind": "drop"}])


def test_install_from_json_is_idempotent_for_identical_spec():
    spec = json.dumps({"seed": 5, "rules": [{"site": "worker.exec", "kind": "error", "nth": 1}]})
    _plan.install_from_json(spec)
    assert _plan.maybe_inject("worker.exec") is not None
    _plan.install_from_json(spec)  # re-registration path: must NOT reset counters
    assert len(_plan.injection_log()) == 1
    assert _plan.active().rules[0].hits == 1
    # a DIFFERENT spec is a fresh scenario: counters and log reset
    _plan.install_from_json(json.dumps(
        {"seed": 6, "rules": [{"site": "worker.exec", "kind": "error", "nth": 1}]}
    ))
    assert _plan.injection_log() == [] and _plan.active().rules[0].hits == 0


def test_fault_error_carries_site_and_hit():
    _plan.install(_schedule([{"site": "worker.exec", "kind": "error"}]))
    f = _plan.maybe_inject("worker.exec")
    err = f.error("task foo")
    assert isinstance(err, ChaosError)
    assert "worker.exec#1" in str(err) and "task foo" in str(err)


def test_metrics_series_counts_by_site_and_kind():
    _plan.install(_schedule([{"site": "s.*", "kind": "drop"}]))
    for _ in range(3):
        _plan.maybe_inject("s.a")
    _plan.maybe_inject("s.b")
    series = {(r["tags"]["site"], r["tags"]["kind"]): r["value"]
              for r in _plan.metrics_series() if r["name"] == "chaos.injected_total"}
    assert series == {("s.a", "drop"): 3.0, ("s.b", "drop"): 1.0}


def test_schedule_spec_roundtrip():
    spec = {"seed": 9, "rules": [
        {"site": "node.chunk.serve", "kind": "evict", "nth": 2,
         "ctx": {"oid": "ab"}, "delay_s": 0.2},
        {"site": "rpc.frame.send", "kind": "drop", "every": 4, "p": 0.5, "max_faults": 3},
    ]}
    sched = FaultSchedule.from_spec(json.dumps(spec))
    again = FaultSchedule.from_spec(sched.to_json())
    assert again.to_spec() == sched.to_spec() == spec


# ---------------------------------------------------------------------------
# scenario runner (real clusters)
# ---------------------------------------------------------------------------

def test_worker_kill_scenario_smoke():
    """The tier-1 chaos smoke: one seeded worker-kill scenario, CPU-only —
    retried tasks complete, and every cluster invariant holds afterward."""
    report = run_scenario("worker_kill", seed=3, quick=True)
    assert report["ok"], report
    assert report["invariants"]["no_stuck_tasks"]["ok"]
    assert report["details"]["retried_attempts"] >= 1
    # Observability acceptance: the kill left a black box behind —
    # the dying worker dumped its flight ring, the daemon harvested it, and
    # the dump's autopsy attributes the in-flight task the kill interrupted.
    fd = report["details"]["flight_dump"]
    assert fd["trigger"] == "worker.death"
    assert fd["events"] >= 1
    assert fd["in_flight"], "post-mortem failed to attribute the killed task"


def test_day_in_the_life_scenario_smoke():
    """Tier-1 replay smoke: the quick-mode day_in_the_life run — a seeded
    trace replayed open-loop through a compiled chaos timeline, judged by
    the run ledger's own gates. The full-length run rides the `-m slow`
    scenario battery. Seed 0 is the canonical seed: the trace it produces
    must match the committed tests/data artifact byte for byte."""
    import hashlib
    import pathlib

    report = run_scenario("day_in_the_life", seed=0, quick=True)
    assert report["ok"], report
    d = report["details"]
    committed = (pathlib.Path(__file__).parent / "data"
                 / "day_in_the_life_seed0.trace.jsonl").read_bytes()
    assert d["trace_sha256"] == hashlib.sha256(committed).hexdigest()
    assert d["gate"]["ok"], d["gate"]
    # the mid-run weight publication landed and both replicas swapped to it
    assert any(e["action"] == "publish_weights" and e["ok"]
               for e in d["timeline"])
    assert report["injections"], "timeline compiled no driver-side faults"


@pytest.mark.slow  # heavy battery; kept out of the tier-1 budget
def test_overload_storm_scenario_smoke():
    """The QoS acceptance scenario: ~3x overload with chaos-injected replica
    slowness — interactive goodput holds (p99 bounded), every shed/expiry is
    visible on /metrics with exact accounting, and no deadline-expired
    request ever reaches user code."""
    report = run_scenario("overload_storm", seed=5, quick=True)
    assert report["ok"], report
    assert report["details"]["shed"] >= 1
    assert report["details"]["invoked"] > 0
    assert report["invariants"]["faults_visible_in_metrics"]["ok"]


@pytest.mark.slow  # heavy battery; kept out of the tier-1 budget
def test_autoscale_flap_scenario_smoke():
    """The scale-plane acceptance scenario: chaos-delayed replica startup
    (site scale.replica.start) under sustained load — the policy upscales,
    the replica set grows, and the applied decision sequence contains no
    direction flip inside the cooldown window."""
    report = run_scenario("autoscale_flap", seed=11, quick=True)
    assert report["ok"], report
    assert report["details"]["replicas"] >= 2
    assert any(d["action"] == "upscale"
               for d in report["details"]["applied_decisions"])


@pytest.mark.slow  # heavy battery; kept out of the tier-1 budget
def test_ring_link_loss_scenario_smoke():
    """The collective-plane acceptance scenario: ring frames dropped and
    corrupted in flight — every rank fails with a typed CollectiveError
    inside the step deadline (never a hang), the same gang completes a
    clean round afterward, and the coordinator's payload-byte counter
    stays at zero throughout."""
    report = run_scenario("ring_link_loss", seed=9, quick=True)
    assert report["ok"], report
    rounds = report["details"]["rounds"]
    assert [r["round"] for r in rounds] == ["drop", "corrupt", "clean"]
    assert all(r["elapsed_s"] < 25 for r in rounds)
    assert report["details"]["coordinator_stats"] == {
        "payload_in": 0, "payload_out": 0}
    assert report["invariants"]["faults_visible_in_metrics"]["ok"]


def test_same_seed_replays_identical_injection_sequence():
    """The replay contract, asserted on two REAL runs: identical seed +
    schedule + workload => byte-identical normalized injection logs."""
    r1 = run_scenario("pull_source_death", seed=1234, quick=True)
    assert r1["ok"], r1
    r2 = run_scenario("pull_source_death", seed=1234, quick=True)
    assert r2["ok"], r2
    assert r1["injections"], "scenario injected nothing — vacuous replay"
    assert r1["injections"] == r2["injections"]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_battery(name):
    """The full five-scenario soak (worker kill, pull-source death,
    controller restart under live submissions, MAC-corrupt storm,
    TPU-preemption drain) — all invariants green."""
    report = run_scenario(name, seed=17)
    assert report["ok"], report


@pytest.mark.slow
def test_multi_fault_soak():
    """Several fault families armed at once over a mixed workload — the
    long-haul shape of the nightly chaos suites."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.chaos import invariants as _inv
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.api import Cluster, init
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.metrics_report_interval_s = 0.5
    cfg.chaos_spec = json.dumps({"seed": 99, "rules": [
        {"site": "worker.exec", "kind": "error", "every": 7},
        {"site": "worker.task.dispatch", "kind": "error", "every": 11},
        {"site": "controller.lease.grant", "kind": "delay", "every": 5, "delay_s": 0.02},
        {"site": "rpc.recv.dispatch", "kind": "delay", "every": 40, "delay_s": 0.05},
    ]})
    _plan.install_from_json(cfg.chaos_spec)
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    try:
        @rt.remote(max_retries=8)
        def work(i):
            return i * i

        for _wave in range(4):
            refs = [work.remote(i) for i in range(10)]
            out = []
            for i, r in enumerate(refs):
                try:
                    out.append(rt.get(r, timeout=240))
                except Exception:
                    out.append(i * i)  # injected app-level errors are expected
            assert all(isinstance(v, int) for v in out)
        core = api._require_worker()
        inv = _inv.check_all(core, cluster, min_injections=3)
        assert inv["ok"], inv
    finally:
        api.shutdown()
        cluster.shutdown()
