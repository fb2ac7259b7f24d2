"""Invariant-checked chaos scenarios: start a cluster, arm a seeded fault
schedule, drive a workload, assert the cluster converged clean.

``python -m ray_tpu_torch chaos run <scenario> [--seed N]`` runs one scenario in
an in-process cluster (this command never connects to a live cluster — a
chaos run is a destructive experiment, not an operator query) and prints a
JSON report. Re-running with the same seed replays the same per-rule
injection sequence (see plan.py); the report embeds the normalized
injection log so a failure is replayable from its own output.

Reference analogue: the nightly ``chaos_test`` suites (kill raylets/workers
on a schedule, assert the workload completes) — with wall-clock killers
replaced by seeded nth-hit schedules and the pass condition widened from
"workload finished" to the cluster invariants in invariants.py.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional

from ray_tpu_torch.chaos import plan as _plan
from ray_tpu_torch.chaos import invariants as _inv
from ray_tpu_torch.obs import flight as _flight


class ScenarioFailure(AssertionError):
    pass


# The scenario's in-process Cluster, registered at creation so the runner's
# finally can tear it down even when the scenario raises mid-build (an
# address-connected driver's shutdown() does NOT stop the cluster it dialed).
_ACTIVE: dict = {"cluster": None}


def _register_cluster(cluster):
    _ACTIVE["cluster"] = cluster
    return cluster


def _require(cond: bool, why: str):
    if not cond:
        raise ScenarioFailure(why)


def _fresh_config():
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    # Scenario clusters are short-lived: tight reporter/flush ticks so the
    # metrics/state invariants observe injections without long waits.
    cfg.metrics_report_interval_s = 0.5
    return cfg


def _teardown():
    from ray_tpu_torch.core import api

    try:
        api.shutdown()
    finally:
        cluster, _ACTIVE["cluster"] = _ACTIVE["cluster"], None
        try:
            if cluster is not None:
                cluster.shutdown()
        finally:
            _plan.uninstall()


def _drain_retries(refs, timeout: float):
    import ray_tpu_torch as rt

    return [rt.get(r, timeout=timeout) for r in refs]


def _metric_sum(series, name, tag=None):
    """Sum one counter across a merged /metrics snapshot (optionally
    filtered to a tag subset)."""
    return sum(
        rec.get("value", 0.0) for rec in series
        if rec.get("name") == name
        and (tag is None or all(rec.get("tags", {}).get(k) == v for k, v in tag.items()))
    )

# The process-global counters scenario accounting reads. Chaos counters are
# reset by plan.install(), but these live in serve/qos/ckpt Counter objects
# that survive across sessions in one process — a replay in a long-lived
# process (test suite, repeated CLI runs) inherits their counts.
_BASELINE_NAMES = (
    "serve.request.shed_total",
    "serve.request.expired_total",
    "qos.exec.expired_total",
    "ckpt.publish.swaps_total",
    "ckpt.publish.failures_total",
    "chaos.injected_total",
)


def _baseline_counters(core, names=_BASELINE_NAMES) -> dict:
    """Snapshot the counters BEFORE driving load so every scenario asserts
    on DELTAS (exact-accounting checks against absolute values
    pass alone and fail under `pytest tests/`)."""
    core._run(core._report_metrics())
    series = core._run(core.controller.call("get_metrics", {}))
    return {n: _metric_sum(series, n) for n in names}


def _counter_deltas(core, baseline: dict) -> dict:
    """Current merged-view value minus the baseline, per counter."""
    core._run(core._report_metrics())
    series = core._run(core.controller.call("get_metrics", {}))
    return {n: _metric_sum(series, n) - v for n, v in baseline.items()}


# ---------------------------------------------------------------------------
# Scenarios. Each returns {"details": ..., "min_injections": int,
# "min_metric_injections": int | None} and leaves the driver connected for
# the invariant battery; the runner handles teardown.
# ---------------------------------------------------------------------------


def _scn_worker_kill(seed: int, quick: bool) -> dict:
    """Kill a worker mid-task on its Nth execution (hard os._exit, the
    SIGKILL shape): retriable tasks must all complete on replacement
    workers. The tier-1 smoke scenario — CPU-only, single node."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [{"site": "worker.exec", "kind": "kill", "nth": 3}],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    n = 4 if quick else 8

    @rt.remote(max_retries=5)
    def work(i):
        time.sleep(0.02)
        return i * 2

    # Waves of (worker-pool size): dispatches stay singletons, so a killed
    # worker loses ONE task, not a whole batch — with every fresh worker
    # also dying on ITS 3rd exec, a lost >=3-task batch would re-lose a
    # member on every retry by construction (correlated-failure artifact of
    # the deterministic schedule, not a recovery bug).
    got = []
    for base in range(0, n, 2):
        refs = [work.remote(i) for i in range(base, min(base + 2, n))]
        got.extend(_drain_retries(refs, timeout=180))
    _require(got == [i * 2 for i in range(n)], f"wrong results: {got}")
    # Evidence the kill really happened: at least one attempt was retried
    # (the killed worker's task re-ran as attempt >= 1). The injecting
    # process died with its own fault, so the metric counter legitimately
    # reads zero — the retry IS the observable.
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    out = core._run(core.controller.call("list_tasks", {"fn": "work", "limit": 200}))
    retried = [t for t in out.get("tasks", []) if t.get("attempt", 0) > 0]
    _require(bool(retried), "no retried attempt in the task index — the kill never landed")
    # Observability invariant: every injected kill leaves a black box. The
    # dying worker dumps its flight ring before os._exit, the daemon
    # harvests the file when it reaps the process, and the controller
    # indexes the path — so the scenario can load the post-mortem and
    # demand it attributes the in-flight task the kill took down.
    dumps: list = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not dumps:
        out = core._run(core.controller.call("list_flight_dumps", {}))
        dumps = [d for d in out.get("dumps", []) if d.get("trigger") == "worker.death"]
        if not dumps:
            time.sleep(0.25)
    _require(bool(dumps), "worker.exec kill left no flight dump behind")
    header, events = _flight.load_dump(dumps[0]["path"])
    _require(header.get("trigger") == "worker.death",
             f"dump carries the wrong trigger: {header.get('trigger')!r}")
    _require(bool(events), "flight dump parsed empty — the black box recorded nothing")
    aut = _flight.dump_autopsy(events)
    running = [t for t in aut["in_flight"] if t.get("state") == "RUNNING"]
    _require(bool(running),
             "dump autopsy shows no in-flight RUNNING task — the post-mortem "
             "cannot attribute what the kill interrupted")
    return {
        "cluster": cluster,
        "details": {
            "tasks": n,
            "retried_attempts": len(retried),
            "flight_dump": {
                "trigger": header.get("trigger"),
                "events": len(events),
                "in_flight": [t.get("task_id", "")[:8] for t in running],
                # Replay-diff form: two same-seed runs must produce an
                # identical normalized event sequence (determinism check).
                "normalized": _flight.normalize_dump(events),
            },
        },
        "min_injections": 0,
        "min_metric_injections": 0,
    }


def _scn_pull_source_death(seed: int, quick: bool) -> dict:
    """A pull source fails mid-object (chunk fetch + chunk serve faults):
    the windowed pull must fail over to the alternate replica and deliver a
    value-correct object."""
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cfg.pull_chunk_size = 1024 * 1024  # multi-chunk objects at test sizes
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [
            {"site": "node.pull.source", "kind": "error", "nth": 2},
            {"site": "node.chunk.serve", "kind": "error", "nth": 5},
        ],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=2)  # head/driver node
    cluster.add_node(num_cpus=2, resources={"srcA": 2.0})
    cluster.add_node(num_cpus=2, resources={"srcB": 2.0})
    init(address=cluster.address, config=cfg)
    mb = 4 if quick else 6

    @rt.remote(resources={"srcA": 1.0}, max_retries=2)
    def make():
        return np.arange((mb << 20) // 8, dtype=np.int64)

    @rt.remote(resources={"srcB": 1.0}, max_retries=2)
    def replicate(arr):
        return int(arr[-1])  # pulling onto srcB leaves a second replica there

    ref = make.remote()
    last = rt.get(replicate.remote(ref), timeout=180)
    _require(last == (mb << 20) // 8 - 1, f"replicate saw wrong tail {last}")
    got = rt.get(ref, timeout=180)  # head pulls, striped across both replicas
    _require(int(got[0]) == 0 and int(got[-1]) == last and got.shape == ((mb << 20) // 8,),
             "pulled object is not value-correct")
    retried = sum(d.pull_manager.chunks_retried for d in cluster.daemons)
    _require(retried >= 1, "no chunk ever retried — the faults never bit a transfer")
    del got
    return {
        "cluster": cluster,
        "details": {"object_mb": mb, "chunks_retried": retried},
        "min_injections": 1,
        "min_metric_injections": 1,
    }


def _scn_controller_restart(seed: int, quick: bool) -> dict:
    """Controller crash + restart while submissions are live: in-flight
    lease requests fail over the reconnect, every task still completes, and
    the restored control plane's task index ends all-terminal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [
            {"site": "controller.lease.grant", "kind": "delay",
             "every": 2, "delay_s": 0.05},
        ],
    })
    _plan.install_from_json(cfg.chaos_spec)
    snap = os.path.join(tempfile.mkdtemp(prefix="raytpu_chaos_"), "controller.snap")
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg, persist_path=snap))
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    n = 6 if quick else 10

    @rt.remote(max_retries=5)
    def work(i):
        time.sleep(0.05)
        return i + 100

    wave1 = [work.remote(i) for i in range(n)]
    got1 = _drain_retries(wave1, timeout=180)
    time.sleep(1.2)  # snapshot tick persists registrations
    # Live submissions straddling the restart: fire wave2, kill the
    # controller before collecting anything.
    wave2 = [work.remote(i) for i in range(n)]
    cluster.restart_controller()
    wave3 = [work.remote(i) for i in range(n)]
    got2 = _drain_retries(wave2, timeout=240)
    got3 = _drain_retries(wave3, timeout=240)
    expect = [i + 100 for i in range(n)]
    _require(got1 == expect and got2 == expect and got3 == expect,
             "lost or wrong results across the controller restart")
    return {
        "cluster": cluster,
        "details": {"waves": 3, "tasks_per_wave": n},
        "min_injections": 1,
        "min_metric_injections": 1,
    }


def _scn_mac_corrupt_storm(seed: int, quick: bool) -> dict:
    """Storm of MAC-corrupted frames on the session's live connections: each
    corrupted frame makes the receiving peer drop the connection (fail-loud
    auth contract); retries + persistent redial must carry every task to a
    correct result. Armed AFTER init so cluster bring-up itself is clean —
    the storm tests the steady-state recovery paths."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    _require(bool(cfg.auth_token), "storm scenario needs the authed wire (auto-mint is on by default)")
    storm = 3 if quick else 6
    _plan.install(_plan.FaultSchedule.from_spec({
        "seed": seed,
        # Frame coalescing makes envelopes scarce (one per burst, not per
        # call): a short cadence is needed for a storm of useful size.
        "rules": [{"site": "rpc.frame.send", "kind": "corrupt_mac",
                   "every": 5, "max_faults": storm}],
    }))
    n = 8 if quick else 12

    @rt.remote(max_retries=8)
    def work(i):
        return i * 3

    results = []
    for _wave in range(3):
        refs = [work.remote(i) for i in range(n)]
        results.append(_drain_retries(refs, timeout=240))
    injected = len(_plan.injection_log())
    _plan.uninstall()  # storm over; the invariant battery runs on a clean wire
    expect = [i * 3 for i in range(n)]
    _require(all(r == expect for r in results), f"storm corrupted results: {results}")
    # One clean wave after the storm: the session fully recovered.
    refs = [work.remote(i) for i in range(n)]
    _require(_drain_retries(refs, timeout=180) == expect, "post-storm wave failed")
    _require(injected >= storm, f"storm under-fired: {injected} < {storm}")
    return {
        "cluster": cluster,
        "details": {"frames_corrupted": injected, "waves": 4},
        "min_injections": storm,
        "min_metric_injections": storm,
    }


def _scn_tpu_preempt_drain(seed: int, quick: bool) -> dict:
    """Injected preemption notice on one GPU slice host: the node drains,
    then drops off the cluster after its grace window; the actor living
    there restarts once the autoscaler replaces the preempted host."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.accel.gpu import TPU_SLICE_NAME_LABEL, TPU_WORKER_ID_LABEL
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cfg.heartbeat_interval_s = 0.2
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=2)  # head/driver node, no GPUs
    victim = cluster.add_node(
        num_cpus=2, resources={"GPU": 4.0},
        labels={TPU_SLICE_NAME_LABEL: "slice-a", TPU_WORKER_ID_LABEL: "1"},
    )
    init(address=cluster.address, config=cfg)

    @rt.remote(resources={"GPU": 1.0}, max_restarts=3, max_task_retries=3)
    class Replica:
        def pid(self):
            return os.getpid()

    a = Replica.remote()
    pid1 = rt.get(a.pid.remote(), timeout=120)
    provider = LocalNodeProvider(cluster)
    scaler = Autoscaler(
        [NodeType("gpu-host", {"GPU": 4.0},
                  labels={TPU_SLICE_NAME_LABEL: "slice-b", TPU_WORKER_ID_LABEL: "1"})],
        provider, idle_timeout_s=3600.0,
    )
    # Arm AFTER the actor is placed: the preemption notice must strike a
    # host that is actually running gang work. In-process daemons consult
    # the shared plan immediately; nth=1 = the victim's next heartbeat.
    _plan.install(_plan.FaultSchedule.from_spec({
        "seed": seed,
        "rules": [{"site": "tpu.preempt", "kind": "preempt", "nth": 1,
                   "delay_s": 0.3, "ctx": {"worker_id": "1", "slice": "slice-a"}}],
    }))
    deadline = time.monotonic() + 60
    from ray_tpu_torch.core import api

    core = api._require_worker()
    while time.monotonic() < deadline:
        nodes = core._run(core.controller.call("get_cluster_state", {}))["nodes"]
        if nodes.get(victim.node_id, {}).get("state") == "DEAD":
            break
        time.sleep(0.2)
    else:
        raise ScenarioFailure("preempted node never died")
    # Replacement capacity: the autoscaler sees the pending (restarting)
    # actor's demand and launches a fresh slice host.
    pid2 = None
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        scaler.update()
        try:
            pid2 = rt.get(a.pid.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.3)
    _require(pid2 is not None and pid2 != pid1,
             f"actor never restarted on a replacement host (pid1={pid1}, pid2={pid2})")
    drained = any(e.get("kind") == "node_draining"
                  for e in core._run(core.controller.call("get_events", {"limit": 500})))
    _require(drained, "no drain event recorded before the preemption death")
    return {
        "cluster": cluster,
        "details": {"pid_before": pid1, "pid_after": pid2},
        "min_injections": 1,
        "min_metric_injections": 1,
    }


def _scn_overload_storm(seed: int, quick: bool) -> dict:
    """Sustained ~3x overload against a capacity-bounded serve app whose
    per-request exec delay is chaos-injected (site serve.replica.slow): the
    QoS plane must hold interactive goodput while shedding/expiring the
    background classes. Invariants pinned here, beyond the standard battery:

    * interactive goodput stays high (>= 90% success) and its p99 bounded;
    * EVERY rejection is visible — observed 429s == the proxy's
      serve.request.shed_total, observed 504s == serve.request.expired_total
      (both read from the controller's merged /metrics view);
    * NO deadline-expired request ever reached user code: the deployment's
      own invocation count equals the number of 200s, and the
      qos.exec.expired_total tripwire is zero.
    """
    import threading
    import urllib.error
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    # This scenario asserts the burn-alert -> incident-flamegraph chain, so
    # samplers must be armed even where the harness disarms them by default
    # (tests/conftest.py sets RAYTPU_PROFILE_HZ=0 for unrelated suites).
    cfg.profile_hz = 19.0
    # Tight AIMD knobs so the limit converges inside the scenario window.
    cfg.qos_target_delay_s = 0.08
    cfg.qos_min_concurrency = 2
    cfg.qos_initial_concurrency = 8
    cfg.qos_adapt_interval_s = 0.25
    # Fast SLO evaluation ticks: the burn-rate alert must fire INSIDE the
    # storm window (the objective below uses storm-sized windows to match).
    cfg.slo_eval_interval_s = 0.25
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [{"site": "serve.replica.slow", "kind": "delay",
                   "delay_s": 0.04, "ctx": {"deployment": "Slowpoke"}}],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=4)
    init(address=cluster.address, config=cfg)
    from ray_tpu_torch import serve

    @serve.deployment(name="Slowpoke", max_ongoing_requests=2)
    class Slowpoke:
        def __init__(self):
            self._lock = threading.Lock()
            self.invoked = 0

        def __call__(self, request):
            with self._lock:
                self.invoked += 1
            return "ok"

        def count(self):
            with self._lock:
                return self.invoked

    serve.run(Slowpoke.bind(), name="storm", route_prefix="/storm")
    port = serve.http_port()

    # SLO plane under fire: an availability objective scoped to this app,
    # with storm-sized burn windows. The quiet path (pre-flood) must sit at
    # "ok"; the storm must drive a multi-window burn-rate ALERT.
    serve.register_slo({
        "name": "storm-availability", "metric": "availability",
        "app": "storm", "deployment": "Slowpoke",
        "fast_window_s": 1.0, "slow_window_s": 3.0, "burn_threshold": 2.0,
    })
    time.sleep(1.0)  # a few idle evaluation ticks
    rows = serve.slo_status()
    row = next(r for r in rows if r["objective"]["name"] == "storm-availability")
    _require(row["state"] == "ok" and row["alerts_fired"] == 0,
             f"SLO alerted on an idle deployment (quiet path not alert-free): {row}")

    # Baseline the QoS counters BEFORE the load (shared helper — see
    # _baseline_counters): the exact-accounting assertions below are DELTAS.
    from ray_tpu_torch.core import api

    core = api._require_worker()
    base = _baseline_counters(core)
    shed0 = base["serve.request.shed_total"]
    expired0 = base["serve.request.expired_total"]
    tripwire0 = base["qos.exec.expired_total"]

    duration = 4.0 if quick else 7.0
    stop_at = time.monotonic() + duration
    lock = threading.Lock()
    stats: dict = {}  # class -> {status -> n}
    lat: dict = {"interactive": []}

    def hit(klass: str, tenant: str, timeout_s: float):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/storm", data=b"{}", method="POST",
            headers={"x-priority": klass, "x-tenant": tenant,
                     "x-request-timeout-s": str(timeout_s)},
        )
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                code = resp.status
                resp.read()
        except urllib.error.HTTPError as e:
            code = e.code
            e.read()
        except Exception:
            code = -1
        elapsed = time.perf_counter() - t0
        with lock:
            per = stats.setdefault(klass, {})
            per[code] = per.get(code, 0) + 1
            if klass == "interactive":
                lat["interactive"].append(elapsed)

    def flood(klass: str, tenant: str, timeout_s: float, think_s: float):
        while time.monotonic() < stop_at:
            hit(klass, tenant, timeout_s)
            if think_s:
                time.sleep(think_s)

    threads = (
        # Background: two tenants of best_effort flood + one batch lane —
        # the overload the plane must shed.
        [threading.Thread(target=flood, args=("best_effort", f"bg{i % 2}", 1.0, 0.0))
         for i in range(6)]
        + [threading.Thread(target=flood, args=("batch", "etl", 1.5, 0.0))
           for _ in range(2)]
        # Foreground: the interactive trickle whose goodput is protected.
        + [threading.Thread(target=flood, args=("interactive", "user", 2.0, 0.05))
           for _ in range(2)]
    )
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 60)
    _require(all(not t.is_alive() for t in threads), "load threads wedged")

    inter = stats.get("interactive", {})
    n_inter = sum(inter.values())
    ok_inter = inter.get(200, 0)
    _require(n_inter > 0, "no interactive request ever completed a round trip")
    _require(ok_inter / n_inter >= 0.9,
             f"interactive goodput collapsed under overload: {inter}")
    lats = sorted(lat["interactive"])
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    _require(p99 < 1.5, f"interactive p99 unbounded: {p99:.3f}s")
    shed_observed = sum(per.get(429, 0) for per in stats.values())
    expired_observed = sum(per.get(504, 0) for per in stats.values())
    _require(shed_observed >= 1,
             f"overload never shed anything — the admission controller is dead: {stats}")
    _require(sum(per.get(-1, 0) + per.get(500, 0) for per in stats.values()) == 0,
             f"hard failures under overload: {stats}")

    # -- exact shed/expiry accounting on the merged /metrics view ---------
    deadline = time.monotonic() + 12
    shed_metric = expired_metric = tripwire = -1.0
    while time.monotonic() < deadline:
        core._run(core._report_metrics())
        series = core._run(core.controller.call("get_metrics", {}))
        shed_metric = _metric_sum(series, "serve.request.shed_total") - shed0
        expired_metric = _metric_sum(series, "serve.request.expired_total") - expired0
        tripwire = _metric_sum(series, "qos.exec.expired_total") - tripwire0
        if shed_metric >= shed_observed and expired_metric >= expired_observed:
            break
        time.sleep(0.4)
    _require(shed_metric == shed_observed,
             f"shed accounting broken: {shed_metric} on /metrics vs {shed_observed} observed 429s")
    _require(expired_metric == expired_observed,
             f"expiry accounting broken: {expired_metric} on /metrics vs {expired_observed} observed 504s")
    _require(tripwire == 0.0,
             f"{tripwire:.0f} expired requests began executing — a deadline gate was bypassed")

    # -- no expired/shed request ever reached user code -------------------
    h = serve.get_deployment_handle("Slowpoke", "storm")
    invoked = h.options(method_name="count").remote().result(timeout=30)
    total_200 = sum(per.get(200, 0) for per in stats.values())
    _require(invoked == total_200,
             f"replica invoked user code {invoked}x but only {total_200} requests "
             "succeeded — a shed or expired request reached the callable")

    # -- the storm must have driven the SLO objective into alert ----------
    row = next(r for r in serve.slo_status()
               if r["objective"]["name"] == "storm-availability")
    _require(row["alerts_fired"] >= 1,
             f"sustained overload never fired the burn-rate alert: {row}")
    slo_events = [
        e for e in core._run(core.controller.call("get_events", {"limit": 4000}))
        if e.get("kind") == "slo_state" and e.get("objective") == "storm-availability"
    ]
    _require(any(e.get("state") == "alert" for e in slo_events),
             f"no slo_state=alert event in the controller log: {slo_events}")

    # -- the burn alert must have snapshotted an incident profile ---------
    # (alert-triggered capture — the merged cluster flamegraph
    # lands in the controller's registry, same data /api/profile?incidents=1
    # serves, so the incident dump carries its own "what was burning".)
    deadline = time.monotonic() + 20
    incidents: list = []
    got: dict = {}
    while time.monotonic() < deadline:
        got = core._run(core.controller.call("profile_incidents", {}))
        incidents = [i for i in got.get("incidents", [])
                     if i.get("objective") == "storm-availability"]
        if incidents:
            break
        time.sleep(0.4)
    _require(bool(incidents),
             "burn alert never snapshotted an incident profile "
             f"(suppressed={got.get('suppressed')}, dropped={got.get('dropped')})")
    prof = incidents[0]["profile"]
    _require(prof.get("samples", 0) > 0 and prof.get("stacks"),
             f"incident flamegraph is empty: {prof.get('samples', 0)} samples")
    _require(len(prof.get("procs") or []) >= 2,
             f"not a merged cluster fold: procs={prof.get('procs')}")
    # The storm's cost is attributable: sampled stacks cross the serve plane
    # (proxy/replica frames render as ray_tpu_torch/serve/... via the shared
    # formatter — the hot path names the machinery under fire).
    _require(any("ray_tpu_torch/serve/" in s for s in prof["stacks"]),
             "no serve-plane frames in the storm's merged flamegraph: "
             f"planes={prof.get('planes')}")
    from ray_tpu_torch.serve.handle import _reset_registry

    _reset_registry()  # park router threads before the invariant battery
    return {
        "cluster": cluster,
        "details": {
            "stats": {k: {str(c): n for c, n in per.items()} for k, per in stats.items()},
            "interactive_p99_s": round(p99, 3),
            "shed": shed_observed, "expired": expired_observed,
            "invoked": invoked,
            "slo": {"state": row["state"], "alerts_fired": row["alerts_fired"],
                    "burn_fast": row["burn_fast"], "burn_slow": row["burn_slow"]},
        },
        # Every invocation rode one injected serve.replica.slow delay.
        "min_injections": 0,  # injections happen in the REPLICA process, not here
        "min_metric_injections": 1,
    }


def _scn_autoscale_flap(seed: int, quick: bool) -> dict:
    """Scale plane under slow capacity arrival: every replica start is
    chaos-delayed (site scale.replica.start) while sustained load drives the
    autoscaler up from min_replicas. Invariants pinned here, beyond the
    standard battery:

    * the policy upscales (an applied upscale decision exists and the
      replica set actually grows past min_replicas) — the QoS/demand
      signals really request capacity;
    * NO FLAP: the applied decision sequence contains no
      upscale->downscale (or reverse) pair closer than the policy's
      cooldown window — a replica being slow to arrive must not read as
      satisfied demand and oscillate the target;
    * requests keep succeeding across the scale-out (no hard failures).
    """
    import threading
    import urllib.error
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cooldown_s = 2.0
    cfg = _fresh_config()
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        # Every replica start stalls ~1s: the upscale's capacity arrives
        # late, exactly the window a flapping policy would reverse itself in.
        "rules": [{"site": "scale.replica.start", "kind": "delay",
                   "delay_s": 1.0}],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=6)
    init(address=cluster.address, config=cfg)
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.config import AutoscalingConfig

    @serve.deployment(name="Slowstart", max_ongoing_requests=2,
                      autoscaling_config=AutoscalingConfig(
                          min_replicas=1, max_replicas=3,
                          target_ongoing_requests=1.0,
                          upscale_delay_s=0.3, downscale_delay_s=0.6,
                          cooldown_s=cooldown_s))
    class Slowstart:
        def __call__(self, request):
            time.sleep(0.05)  # per-request service time: load builds depth
            return "ok"

    serve.run(Slowstart.bind(), name="flap", route_prefix="/flap")
    port = serve.http_port()
    ctl = rt.get_actor("__serve_controller__", namespace="serve")

    duration = 6.0 if quick else 10.0
    stop_at = time.monotonic() + duration
    lock = threading.Lock()
    codes: dict = {}

    def flood():
        while time.monotonic() < stop_at:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/flap", data=b"{}", method="POST",
                headers={"x-priority": "interactive", "x-tenant": "user",
                         "x-request-timeout-s": "5"})
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    code = resp.status
                    resp.read()
            except urllib.error.HTTPError as e:
                code = e.code
                e.read()
            except Exception:
                code = -1
            with lock:
                codes[code] = codes.get(code, 0) + 1

    threads = [threading.Thread(target=flood) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 120)
    _require(all(not t.is_alive() for t in threads), "load threads wedged")
    # Let the reconcile loop catch up with the final target.
    deadline = time.monotonic() + 30
    state = {}
    while time.monotonic() < deadline:
        state = rt.get(ctl.get_serve_state.remote(), timeout=30)
        dep = state["apps"]["flap"]["Slowstart"]
        if len(dep["replicas"]) >= dep["target"]:
            break
        time.sleep(0.3)
    dep = state["apps"]["flap"]["Slowstart"]
    decisions = dep["decisions"]
    applied = [d for d in decisions if d.get("applied")]
    ups = [d for d in applied if d["action"] == "upscale"]
    _require(bool(ups), f"no applied upscale under sustained load: {decisions}")
    _require(len(dep["replicas"]) >= 2,
             f"replica set never grew past min_replicas: {dep}")
    # The flap assertion: consecutive applied decisions never reverse
    # direction inside the cooldown window.
    for a, b in zip(applied, applied[1:]):
        if a["action"] != b["action"]:
            gap = b["ts"] - a["ts"]
            _require(gap >= cooldown_s,
                     f"policy flapped {a['action']}->{b['action']} after "
                     f"{gap:.2f}s < cooldown {cooldown_s}s: {applied}")
    _require(codes.get(200, 0) > 0, f"no request ever succeeded: {codes}")
    _require(codes.get(-1, 0) + codes.get(500, 0) == 0,
             f"hard failures during scale-out: {codes}")
    from ray_tpu_torch.serve.handle import _reset_registry

    _reset_registry()  # park router threads before the invariant battery
    return {
        "cluster": cluster,
        "details": {
            "codes": {str(c): n for c, n in codes.items()},
            "replicas": len(dep["replicas"]),
            "target": dep["target"],
            "applied_decisions": [
                {"action": d["action"], "to": d["to"], "reason": d["reason"]}
                for d in applied
            ],
        },
        # Replica starts happen in the ServeController's worker process:
        # its injections reach /metrics via the reporter, not this driver.
        "min_injections": 0,
        "min_metric_injections": 1,
    }


def _scn_ckpt_kill_mid_save(seed: int, quick: bool) -> dict:
    """Checkpoint plane under fire: a worker dies mid sharded save, a chunk
    write fails in a later attempt, and the publish swap is delayed. The
    core invariant battery, beyond the standard one: a committed manifest
    is always fully restorable (byte-identical, same-mesh AND resharded); an
    uncommitted one is never visible (manifest listing, state API, channel
    pointer); chunk refcounts balance after top-K eviction (no orphaned and
    no missing chunks)."""
    import numpy as np
    import ray_tpu_torch as rt  # noqa: F401 — session-scoped driver for the battery
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [
            # nth counts (rank, array) gate hits: 4/step with 2 ranks x 2
            # arrays -> rank 0 dies at the start of step 1's save.
            {"site": "ckpt.worker.kill_mid_save", "kind": "kill", "nth": 5},
            # nth counts NEW chunk writes (dedup hits never reach the gate):
            # lands on a hot chunk a few steps later, aborting that attempt.
            {"site": "ckpt.chunk.write", "kind": "error", "nth": 6},
            {"site": "ckpt.publish.swap", "kind": "delay", "nth": 1, "delay_s": 0.05},
        ],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    from ray_tpu_torch import ckpt as _ckpt
    from ray_tpu_torch import state as _state

    storage = tempfile.mkdtemp(prefix="raytpu_ckpt_chaos_")
    store = _ckpt.ChunkStore(storage, chunk_size=8192)
    manifests = _ckpt.ManifestStore(storage, num_to_keep=2, chunk_store=store)
    workers, rows = 2, 64
    steps = 5 if quick else 8
    rng = np.random.default_rng(seed + 1)
    frozen = rng.standard_normal((rows, 64)).astype(np.float32)  # dedup fodder
    committed: dict = {}  # ckpt_id -> reference arrays for byte-compare
    aborted = 0
    last_committed = None
    for step in range(steps):
        hot = np.full((rows, 48), float(step + 1), np.float32)
        ckpt_id = _ckpt.new_ckpt_id(step)
        half = rows // workers
        parts = []
        partial: set = set()  # new digests as they land (dead-rank cleanup)
        for rank in range(workers):
            lo, hi = rank * half, (rank + 1) * half
            snap = {
                "model/frozen": {"dtype": "float32", "shape": [rows, 64],
                                 "shards": [([[lo, hi], [0, 64]], frozen[lo:hi])]},
                "model/hot": {"dtype": "float32", "shape": [rows, 48],
                              "shards": [([[lo, hi], [0, 48]], hot[lo:hi])]},
            }
            try:
                parts.append(_ckpt.write_part(store, snap, rank=rank, step=step,
                                              new_out=partial))
            except Exception:
                pass  # this rank died mid-save: it never acks
        try:
            m = _ckpt.commit_parts(manifests, ckpt_id, step, parts, workers,
                                   channel="chaos", meta={"step": step})
            _ckpt.publish_checkpoint(m, "chaos")
            committed[m["ckpt_id"]] = {"model/frozen": frozen.copy(),
                                       "model/hot": hot.copy()}
            last_committed = m["ckpt_id"]
        except _ckpt.CommitAborted:
            aborted += 1
            # Reclaim the dead rank's partial writes too (commit_parts only
            # sees acked parts' chunk sets).
            manifests.abort(ckpt_id, partial)
            _ckpt.register_manifest({"ckpt_id": ckpt_id, "step": step,
                                     "channel": "chaos", "status": "aborted"})
    _require(aborted >= 2, f"faults never aborted an attempt (aborted={aborted})")
    _require(last_committed is not None, "no attempt ever committed")

    # -- invariant: an uncommitted manifest is never visible ---------------
    listed = manifests.list_ids()
    _require(set(listed) <= set(committed),
             f"uncommitted manifest visible in the store listing: {listed}")
    api_rows = _state.list_checkpoints(channel="chaos", limit=100)
    api_committed = {c["ckpt_id"] for c in api_rows["checkpoints"]
                     if c["status"] == "committed"}
    _require(api_committed <= set(committed),
             f"state API lists an uncommitted manifest as committed: {api_committed}")
    _require(api_rows["channels"].get("chaos") == last_committed,
             "publication channel does not point at the last committed manifest")

    # -- invariant: every committed manifest restores byte-identically -----
    for ckpt_id in listed:
        m = manifests.load(ckpt_id)
        full = _ckpt.restore(m, store)
        for path, want in committed[ckpt_id].items():
            _require(full[path].tobytes() == want.tobytes(),
                     f"{ckpt_id}:{path} same-mesh restore not byte-identical")
        # Resharded (2 source hosts -> 3 uneven target hosts): reassembled
        # target shards must equal the same-mesh restore bytes.
        for path, want in committed[ckpt_id].items():
            cuts = [0, 10, 37, rows]
            got = np.concatenate([
                _ckpt.restore(m, store, target_indices={
                    path: [[cuts[i], cuts[i + 1]], [0, want.shape[1]]]})[path]
                for i in range(3)
            ])
            _require(got.tobytes() == want.tobytes(),
                     f"{ckpt_id}:{path} resharded restore diverged from same-mesh")

    # -- invariant: refcounts balance after top-K eviction -----------------
    _require(len(listed) <= 2, f"top-K retention kept {len(listed)} manifests")
    ver = manifests.verify()
    _require(ver["ok"], f"chunk refcounts out of balance after eviction: {ver}")

    # -- publication: delayed swap still lands, weights verified -----------
    swapped: dict = {}
    sub = _ckpt.WeightSubscriber(
        "chaos", lambda tree, s: swapped.update(version=s["ckpt_id"], tree=tree),
        poll_interval_s=0.2, auto_start=False)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and swapped.get("version") != last_committed:
        sub.check_once()
        time.sleep(0.1)
    _require(swapped.get("version") == last_committed,
             f"subscriber never swapped to {last_committed}: {sub.last_error}")
    want = committed[last_committed]["model/hot"]
    _require(swapped["tree"]["model"]["hot"].tobytes() == want.tobytes(),
             "swapped weights differ from the committed checkpoint")
    sub.stop()
    return {
        "cluster": cluster,
        "details": {"steps": steps, "committed": len(committed),
                    "aborted": aborted, "retained": listed,
                    "chunks_on_disk": ver["chunks"]},
        "min_injections": 3,  # kill + chunk-write error + swap delay
        "min_metric_injections": 3,
    }


def _scn_ring_link_loss(seed: int, quick: bool) -> dict:
    """Ring-collective frames lost in flight: round 1 drops every rank's
    2nd send (the frame never reaches the wire), round 2 corrupts the 3rd
    (poisoned key — the discarded-after-integrity-failure shape). Both
    rounds must fail on EVERY rank with a typed CollectiveError inside the
    step deadline — never a hang — via the abort fan-out, round 3 must
    complete cleanly on the same gang (per-op state fully reaped), and the
    coordinator's payload-byte counter must stay at zero throughout (the
    ring path carries no tensor byte through the coordinator even while
    failing)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import Cluster, init

    cfg = _fresh_config()
    # Tight step deadline: a lost frame must surface typed in ~2s.
    cfg.collective_ring_step_timeout_s = 2.0
    cfg.chaos_spec = json.dumps({
        "seed": seed,
        "rules": [
            # Per-process counters: every rank drops its own 2nd ring send
            # (reduce-scatter step 1 of round 1)...
            {"site": "collective.ring.send", "kind": "drop", "nth": 2},
            # ...and corrupts its 3rd counted-by-this-rule send (reduce-
            # scatter step 1 of round 2; rule order matters — the drop rule
            # consumes its firing hit before this one counts it).
            {"site": "collective.ring.send", "kind": "corrupt", "nth": 3},
        ],
    })
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=4)
    init(address=cluster.address, config=cfg)
    from ray_tpu_torch import collective as col

    n = 8192 if quick else 65536
    world = 3

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def round(self, rank, n):
            import numpy as np
            from ray_tpu_torch import collective as c

            try:
                out = c.allreduce(np.full((n,), rank + 1.0, np.float32),
                                  group_name="ring_chaos", timeout=30.0)
                return ("ok", float(out[0]))
            except c.CollectiveError as e:
                return ("collective_error", str(e)[:120])
            except Exception as e:  # noqa: BLE001 - anything else is a finding
                return ("unexpected", f"{type(e).__name__}: {e}"[:160])

    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, list(range(world)),
                                group_name="ring_chaos")
    rounds = []
    for rnd, want in (("drop", "collective_error"),
                      ("corrupt", "collective_error"),
                      ("clean", "ok")):
        t0 = time.monotonic()
        outs = rt.get([m.round.remote(i, n) for i, m in enumerate(members)],
                      timeout=60)
        elapsed = time.monotonic() - t0
        rounds.append({"round": rnd, "outs": outs,
                       "elapsed_s": round(elapsed, 2)})
        _require(all(kind == want for kind, _ in outs),
                 f"round {rnd!r}: expected every rank {want}, got {outs}")
        _require(elapsed < 25,
                 f"round {rnd!r} took {elapsed:.1f}s — a timed-out wait is a "
                 "hang in disguise (step timeout is 2s)")
    _require(rounds[-1]["outs"][0][1] == 6.0,  # 1+2+3
             f"clean round produced a wrong sum: {rounds[-1]['outs']}")
    from ray_tpu_torch.collective.collective import _GROUP_PREFIX

    stats = rt.get(rt.get_actor(_GROUP_PREFIX + "ring_chaos").get_stats.remote(),
                   timeout=15)
    _require(stats == {"payload_in": 0, "payload_out": 0},
             f"coordinator carried tensor payload on the ring path: {stats}")
    col.destroy_collective_group("ring_chaos")
    return {
        "cluster": cluster,
        "details": {"rounds": rounds, "coordinator_stats": stats},
        # The driver process injects nothing (ranks are actor processes);
        # each of the 3 ranks drops once and corrupts once, and survives.
        "min_injections": 0,
        "min_metric_injections": 2 * world,
    }


# ---------------------------------------------------------------------------
# elastic_preempt: the elastic train plane's acceptance scenario
# ---------------------------------------------------------------------------

# Module-level train fn (pickled to workers). Deterministic SPMD step:
# identical per-step batches on every rank, adam via ShardedOptimizerStep
# (per-rank m/v windows — the state a live reshard actually has to move).
# Every step reports (loss, digest-of-full-state) and registers the state
# both ways: keep_live() for the elastic plane AND a rank-0 full-state
# checkpoint (optimizer windows allgathered first) for the control arm's
# disk round-trip. DISK_READS counts every byte the resume path reads back
# — the live arm's counting shim must stay at zero.
_ELASTIC_D = 192  # params per run (2 buckets at the 1 KiB bucket cut)


def _elastic_preempt_fn(config):
    import hashlib as _hl

    import numpy as np

    import ray_tpu_torch.train as train

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    steps, barrier_step = config["steps"], config["barrier_step"]
    start_world = config["start_world"]
    opt = ctx.sharded_optimizer("adam", lr=0.05, bucket_bytes=1024)
    disk_reads = 0

    def batch(i):
        return np.random.default_rng(1000 + i).normal(
            size=_ELASTIC_D).astype(np.float32)

    resumed = train.live_resume()
    if resumed is not None:
        params = np.array(resumed["state"]["params"], copy=True)
        opt.adopt_shards(resumed["sharded"], t=resumed["meta"]["t"])
        start = resumed["meta"]["step"] + 1
        resume_kind = "live"
    elif train.get_checkpoint() is not None:
        with train.get_checkpoint().as_directory() as d:
            blob = open(os.path.join(d, "full.npz"), "rb").read()
            disk_reads += len(blob)
            import io

            data = np.load(io.BytesIO(blob), allow_pickle=False)
            params = np.array(data["params"], copy=True)
            t = int(data["t"])
            start = int(data["step"]) + 1
            # The disk round-trip reshard: restore FULL optimizer state,
            # slice this rank's window under the NEW world size.
            sharded = {}
            for key in data.files:
                if not key.startswith("opt."):
                    continue
                full = data[key]
                n = full.size
                shard = -(-n // world)
                lo = min(n, rank * shard)
                hi = min(n, lo + shard)
                sharded[key] = (full[lo:hi], lo, n)
            opt.adopt_shards(sharded, t=t)
        resume_kind = "ckpt"
    else:
        params = np.zeros(_ELASTIC_D, dtype=np.float32)
        start = 0
        resume_kind = "fresh"

    def digest(p, full):
        h = _hl.blake2b(digest_size=12)
        h.update(np.ascontiguousarray(p).tobytes())
        for key in sorted(full):
            h.update(key.encode())
            h.update(np.ascontiguousarray(full[key]).tobytes())
        return h.hexdigest()

    if resumed is not None or resume_kind == "ckpt":
        # Prove the resumed state is byte-identical to the parked boundary:
        # reassemble the FULL optimizer state on the new mesh and digest it
        # with the params — must equal the digest reported at the boundary.
        train.report({"resume_digest": digest(params, opt.full_state()),
                      "resume_kind": resume_kind, "resume_step": start - 1,
                      "disk_reads": disk_reads, "world_size": world})

    for i in range(start, steps):
        grads = {"params": params - batch(i)}
        params = opt.step({"params": params}, grads)["params"]
        loss = float(0.5 * np.sum((params - batch(i)) ** 2))
        full = opt.full_state()  # all ranks: collective allgather
        if rank == 0:
            d = tempfile.mkdtemp()
            arrays = {"params": params, "t": np.int64(opt._t),
                      "step": np.int64(i)}
            arrays.update(full)
            np.savez(os.path.join(d, "full.npz"), **arrays)
            from ray_tpu_torch.train import Checkpoint

            train.report({"step": i, "loss": repr(loss),
                          "digest": digest(params, full),
                          "world_size": world, "disk_reads": disk_reads},
                         checkpoint=Checkpoint.from_directory(d))
        else:
            train.report({"step": i, "loss": repr(loss),
                          "digest": digest(params, full),
                          "world_size": world, "disk_reads": disk_reads})
        train.keep_live({"params": params},
                        sharded=opt.live_shards(),
                        meta={"step": i, "t": opt._t})
        marker = config.get("marker")
        if marker and i >= 1 and rank == 0:
            open(marker, "w").close()
        if i == barrier_step and world == start_world:
            # Deterministic resize point: park at this boundary until the
            # controller stops the gang (live reshard) or the preempted
            # host dies (control arm's failure restart). Without this the
            # ranks could stop at different boundaries and the reshard
            # would (correctly) refuse the inconsistent cut.
            while not ctx.should_stop():
                time.sleep(0.05)
            raise RuntimeError("stopped at resize barrier")


def _run_elastic_arm(seed: int, live: bool, steps: int, tmp: str) -> dict:
    """One arm of the A/B: a 3-worker gang on 3 single-CPU hosts, a host
    preemption notice on worker_id=1 mid-run, resume at world 2. Returns
    the arm's per-step records + controller stats; leaves NOTHING running
    (its cluster is torn down here) — except the live arm, whose cluster
    stays up for the invariant battery."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.accel.gpu import TPU_SLICE_NAME_LABEL, TPU_WORKER_ID_LABEL
    from ray_tpu_torch.core.api import Cluster, init
    from ray_tpu_torch.train import (
        ElasticScalingPolicy,
        FailureConfig,
        RunConfig,
        ScalingConfig,
        TrainController,
    )

    cfg = _fresh_config()
    cfg.heartbeat_interval_s = 0.2
    cfg.elastic_transfer_timeout_s = 10.0
    rules = [{"site": "tpu.preempt", "kind": "preempt", "nth": 1,
              "delay_s": 6.0, "ctx": {"worker_id": "1"}}]
    if live:
        # Exercise the transfer site under the same seed: a small injected
        # delay on every 3rd reshard frame (byte-identity must survive it).
        rules.append({"site": "elastic.reshard.transfer", "kind": "delay",
                      "delay_s": 0.02, "every": 3})
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=0)  # head: driver only, no gang capacity
    for wid in range(3):
        cluster.add_node(
            num_cpus=1,
            labels={TPU_SLICE_NAME_LABEL: "slice-a",
                    TPU_WORKER_ID_LABEL: str(wid)},
        )
    init(address=cluster.address, config=cfg)
    marker = os.path.join(tmp, f"progress-{'live' if live else 'ctrl'}")
    scaling = ScalingConfig(num_workers=3, resources_per_worker={"CPU": 1})
    controller = TrainController(
        _elastic_preempt_fn,
        {"steps": steps, "barrier_step": 3, "start_world": 3,
         "marker": marker},
        scaling,
        RunConfig(
            name=f"elastic-{'live' if live else 'ctrl'}",
            storage_path=os.path.join(tmp, "live" if live else "ctrl"),
            failure_config=FailureConfig(max_failures=2),
            elastic_live=live,
        ),
        settle_period_s=3.0,
        scaling_policy=ElasticScalingPolicy(
            scaling, min_workers=2, max_workers=3,
            resize_cooldown_s=3600.0,  # growth disabled: shrink-only arm
        ),
    )

    import threading

    def arm_when_progressing():
        deadline = time.time() + 120
        while not os.path.exists(marker) and time.time() < deadline:
            time.sleep(0.1)
        # Mid-epoch, deterministically: ranks are at/behind the barrier
        # step (they park there), the victim's next heartbeat (0.2s) gets
        # the preemption notice, and the grace window (6s) covers the
        # live transfer.
        _plan.install(_plan.FaultSchedule.from_spec(
            {"seed": seed, "rules": rules}))

    t = threading.Thread(target=arm_when_progressing, daemon=True)
    t.start()
    result = controller.run()
    t.join()
    _require(result.error is None,
             f"{'live' if live else 'control'} arm failed: {result.error}")
    out = {
        "metrics": result.metrics_history,
        "state": controller.get_state(),
        "reshard": getattr(controller, "last_live_resize", None),
    }
    if not live:
        # Control cluster makes way for the live arm (same process).
        from ray_tpu_torch.core import api

        api.shutdown()
        cluster.shutdown()
        _ACTIVE["cluster"] = None
        _plan.uninstall()
    return out


def _scn_elastic_preempt(seed: int, quick: bool) -> dict:
    """Host preemption mid-epoch under a seeded schedule, resolved two ways
    on identical 3->2 runs: (A) checkpoint-restore control — the classic
    blob-store round trip; (B) the elastic plane's live reshard — optimizer
    windows and params move host-to-host over the raw lane during the drain
    grace window. Invariants pinned:

    * byte-identical loss trajectory: every (step -> loss, state-digest)
      record agrees across the arms, including the resumed boundary digest;
    * the live arm's counting shim proves ZERO disk/blob reads on its
      resume path, while the control arm's restore reads > 0;
    * redistribution throughput is reported (wire bytes > 0, MB/s > 0) and
      the gang coordinator re-keyed (train:<exp>:w3 -> w2).
    """
    steps = 7 if quick else 10
    tmp = tempfile.mkdtemp(prefix="elastic_preempt_")
    ctrl = _run_elastic_arm(seed, live=False, steps=steps, tmp=tmp)
    live = _run_elastic_arm(seed, live=True, steps=steps, tmp=tmp)

    def fold(arm):
        by_step: dict = {}
        resume = None
        for m in arm["metrics"]:
            if "resume_digest" in m:
                resume = m
            elif "step" in m:
                # Later reports of the same step (absorbed across a restart)
                # must agree with the earlier ones.
                prev = by_step.get(m["step"])
                if prev is not None:
                    _require(
                        (prev["loss"], prev["digest"]) == (m["loss"], m["digest"]),
                        f"step {m['step']} disagrees with its own replay: "
                        f"{prev} vs {m}")
                by_step[m["step"]] = m
        return by_step, resume

    c_steps, c_resume = fold(ctrl)
    l_steps, l_resume = fold(live)
    _require(set(c_steps) == set(l_steps) == set(range(steps)),
             f"step coverage differs: ctrl={sorted(c_steps)} live={sorted(l_steps)}")
    for i in range(steps):
        _require(
            (c_steps[i]["loss"], c_steps[i]["digest"])
            == (l_steps[i]["loss"], l_steps[i]["digest"]),
            f"trajectory diverged at step {i}: control "
            f"{c_steps[i]['loss']}/{c_steps[i]['digest']} vs live "
            f"{l_steps[i]['loss']}/{l_steps[i]['digest']}")
    # Both arms really resized 3 -> 2 at the barrier.
    for name, st in (("control", c_steps), ("live", l_steps)):
        sizes = [st[i]["world_size"] for i in range(steps)]
        _require(sizes[0] == 3 and sizes[-1] == 2, f"{name} sizes: {sizes}")
    # Both arms resumed from the SAME boundary, byte-identically.
    for name, (resume, st) in (("control", (c_resume, c_steps)),
                               ("live", (l_resume, l_steps))):
        _require(resume is not None, f"{name} arm never reported its resume")
        bstep = resume["resume_step"]
        _require(resume["resume_digest"] == st[bstep]["digest"],
                 f"{name} resumed state != step-{bstep} state")
    _require(c_resume["resume_kind"] == "ckpt" and l_resume["resume_kind"] == "live",
             f"wrong resume paths: {c_resume['resume_kind']}/{l_resume['resume_kind']}")
    # Counting shims: zero disk reads on the live reshard path; the control
    # round trip read its full state back.
    live_reads = max(m.get("disk_reads", 0) for m in l_steps.values())
    ctrl_reads = c_resume["disk_reads"]
    _require(live_reads == 0, f"live arm read {live_reads} checkpoint bytes")
    _require(ctrl_reads > 0, "control arm resumed without reading its checkpoint")
    # Redistribution really moved bytes over the wire, and is reported.
    reshard = live["reshard"]
    _require(reshard is not None, "live arm recorded no reshard stats")
    _require(reshard["wire_bytes"] > 0 and reshard["mb_s"] > 0,
             f"no wire redistribution: {reshard}")
    _require(live["state"]["live_resizes"] == 1 and live["state"]["resize_epoch"] >= 1,
             f"live resize bookkeeping wrong: {live['state']}")
    _require(ctrl["state"]["live_resizes"] == 0, "control arm live-resized")
    return {
        "cluster": _ACTIVE["cluster"],
        "details": {
            "steps": steps,
            "reshard_mb_s": round(reshard["mb_s"], 2),
            "reshard_wire_bytes": reshard["wire_bytes"],
            "control_restore_bytes": ctrl_reads,
            "final_loss": l_steps[steps - 1]["loss"],
        },
        # The injection log resets when the live arm installs its schedule
        # (install() starts a fresh replayable log), so the floor counts
        # only the live arm: its tpu.preempt, plus any transfer delays
        # (site elastic.reshard.transfer, every=3).
        "min_injections": 1,
        "min_metric_injections": 1,
    }


def _scn_day_in_the_life(seed: int, quick: bool) -> dict:
    """Trace-driven day-in-the-life replay (ROADMAP item 2): a seeded
    multi-tenant workload trace (diurnal calm->storm->recovery envelope,
    Zipf tenant skew, streaming/batch blend) replayed open-loop against a
    live autoscaled serve app, under a declarative chaos timeline — slow
    replicas through the storm, a client-network flap in the calm phase, a
    host preemption notice and a live weight publication in recovery — and
    every observability surface folded into ONE run ledger that must pass
    its own gates. Everything replays from the seed: the trace bytes, the
    fault rules (hit-space projection), and the timeline's action order.

    Pinned here, beyond the standard battery:

    * the preempted slice host drains and dies (the timeline's
      control-free preemption notice really landed);
    * the mid-run weight publication hot-swaps into serving replicas
      (version visible through the handle) without an error blip;
    * the ledger's own gates hold: interactive storm-phase p99/goodput,
      bounded swap blip, and a burn-rate trajectory for every objective.
    """
    import hashlib
    import threading

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import replay as _replay
    from ray_tpu_torch.accel.gpu import TPU_SLICE_NAME_LABEL, TPU_WORKER_ID_LABEL
    from ray_tpu_torch.core.api import Cluster, init
    from ray_tpu_torch.obs import ledger as _ledger

    params = _replay.default_params(quick=quick)
    time_warp = 2.0 if quick else 1.5
    header, records = _replay.synthesize(seed, **params)
    trace_sha = hashlib.sha256(_replay.dumps_trace(header, records)).hexdigest()
    spans = _replay.phase_spans(params)
    heartbeat_s = 0.25
    timeline = _replay.Timeline(spans, [
        # Storm phase: every replica request drags an injected exec delay.
        {"action": "slow_replica_window", "phase": "storm", "delay_s": 0.04,
         "deployment": "DayApp"},
        # Calm phase: client-side network flap (replayer-side delays).
        {"action": "client_flap", "phase": "calm", "offset_s": 1.0,
         "kind": "delay", "delay_s": 0.03, "every": 9},
        # Recovery: the slice host gets its preemption notice...
        {"action": "tpu_preempt", "phase": "recovery", "offset_s": 0.6,
         "worker_id": "1", "slice": "slice-a", "grace_s": 0.3},
        # ...and new weights go live mid-traffic, with the swap chaos-delayed.
        {"action": "chaos_rule", "rule": {"site": "ckpt.publish.swap",
                                          "kind": "delay", "nth": 1,
                                          "delay_s": 0.05}},
        {"action": "publish_weights", "phase": "recovery", "offset_s": 0.3,
         "channel": "day-weights", "step": 1},
    ])
    # lead_s is a CONSTANT estimate (victim-host add -> replay start): the
    # compiled nth must not depend on measured wall time or two same-seed
    # runs would emit different injection logs.
    compiled = timeline.compile(seed, records, time_warp=time_warp,
                                heartbeat_s=heartbeat_s, lead_s=1.0)

    cfg = _fresh_config()
    cfg.heartbeat_interval_s = heartbeat_s
    # overload_storm's AIMD/SLO knobs: converge inside the storm window.
    cfg.qos_target_delay_s = 0.08
    cfg.qos_min_concurrency = 2
    cfg.qos_initial_concurrency = 8
    cfg.qos_adapt_interval_s = 0.25
    cfg.slo_eval_interval_s = 0.25
    cfg.chaos_spec = json.dumps(compiled.spec)
    _plan.install_from_json(cfg.chaos_spec)
    cluster = _register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=8)
    init(address=cluster.address, config=cfg)
    from ray_tpu_torch import ckpt as _ckpt
    from ray_tpu_torch import obs as _obs
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.config import AutoscalingConfig

    @serve.deployment(name="DayApp", max_ongoing_requests=2,
                      # 2 CPUs/replica: replicas can never land on the
                      # 1-CPU slice host the timeline preempts.
                      ray_actor_options={"num_cpus": 2.0},
                      autoscaling_config=AutoscalingConfig(
                          min_replicas=1, max_replicas=2,
                          target_ongoing_requests=1.0,
                          upscale_delay_s=0.3, downscale_delay_s=0.6,
                          cooldown_s=2.0))
    class DayApp:
        def __init__(self):
            self._lock = threading.Lock()
            self._version = "v0"
            self._sub = _ckpt.WeightSubscriber("day-weights", self._swap,
                                               poll_interval_s=0.25)

        def _swap(self, tree, summary):
            with self._lock:
                self._version = summary["ckpt_id"]

        def __call__(self, request):
            if request.headers.get("x-stream") == "1":
                def tokens():
                    yield "data: tok0\n\n"
                    time.sleep(0.004)
                    yield "data: tok1\n\n"
                return tokens()
            time.sleep(0.004)
            with self._lock:
                return self._version

        def version(self):
            with self._lock:
                return self._version

    serve.run(DayApp.bind(), name="day", route_prefix="/day")
    port = serve.http_port()
    for spec in (
        {"name": "day-availability", "metric": "availability",
         "app": "day", "deployment": "DayApp",
         "fast_window_s": 1.0, "slow_window_s": 3.0, "burn_threshold": 2.0},
        {"name": "day-latency", "metric": "latency", "target": 0.5,
         "quantile": 0.95, "app": "day", "deployment": "DayApp",
         "fast_window_s": 1.0, "slow_window_s": 3.0, "burn_threshold": 2.0},
    ):
        serve.register_slo(spec)

    # Checkpoint plumbing for the timeline's publish_weights action.
    storage = tempfile.mkdtemp(prefix="raytpu_day_ckpt_")
    store = _ckpt.ChunkStore(storage, chunk_size=8192)
    manifests = _ckpt.ManifestStore(storage, num_to_keep=2, chunk_store=store)

    def _publish(action):
        step = int(action.get("step", 1))
        w = np.full((8, 8), float(step), np.float32)
        snap = {"model/w": {"dtype": "float32", "shape": [8, 8],
                            "shards": [([[0, 8], [0, 8]], w)]}}
        part = _ckpt.write_part(store, snap, rank=0, step=step)
        m = _ckpt.commit_parts(manifests, _ckpt.new_ckpt_id(step), step,
                               [part], 1, channel=action["channel"],
                               meta={"step": step})
        _ckpt.publish_checkpoint(m, action["channel"])
        return {"ckpt_id": m["ckpt_id"]}

    from ray_tpu_torch.core import api

    core = api._require_worker()
    base = _baseline_counters(core)
    # The bystander slice host joins only after the serve control plane is
    # placed (its actors must not land on the node the timeline preempts).
    victim = cluster.add_node(num_cpus=1, resources={"GPU": 4.0},
                              labels={TPU_SLICE_NAME_LABEL: "slice-a",
                                      TPU_WORKER_ID_LABEL: "1"})

    driver = _replay.TimelineDriver(
        compiled.control, {"publish_weights": _publish},
        time_warp=time_warp).start()
    outcomes = _replay.Replayer(port, time_warp=time_warp,
                                max_workers=32).run(header, records)
    tl_log = driver.join(timeout=120)

    # -- the preemption notice really took the slice host down -------------
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        nodes = core._run(core.controller.call("get_cluster_state", {}))["nodes"]
        if nodes.get(victim.node_id, {}).get("state") == "DEAD":
            break
        time.sleep(0.2)
    else:
        raise ScenarioFailure("timeline preemption never took the slice host down")

    # -- the published weights went live in serving replicas ---------------
    published = next((e["detail"]["ckpt_id"] for e in tl_log
                      if e["action"] == "publish_weights" and e.get("ok")), None)
    _require(published is not None,
             f"timeline weight publication failed: {tl_log}")
    h = serve.get_deployment_handle("DayApp", "day")
    ver = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        ver = h.options(method_name="version").remote().result(timeout=30)
        if ver == published:
            break
        time.sleep(0.25)
    _require(ver == published,
             f"replica never hot-swapped to {published} (still at {ver})")

    # -- fold everything into the run ledger and judge it ------------------
    deltas = {}
    deadline = time.monotonic() + 10  # replica reporters tick at 0.5s
    while time.monotonic() < deadline:
        deltas = _counter_deltas(core, base)
        if deltas.get("ckpt.publish.swaps_total", 0) >= 1:
            break
        time.sleep(0.4)
    ctl = rt.get_actor("__serve_controller__", namespace="serve")
    dep = rt.get(ctl.get_serve_state.remote(), timeout=30)["apps"]["day"]["DayApp"]
    ledger = _ledger.build(
        meta={"scenario": "day_in_the_life", "seed": seed,
              "quick": bool(quick), "time_warp": time_warp,
              "requests": header["requests"], "trace_sha256": trace_sha},
        spans=spans,
        load=_replay.summarize(outcomes, phases=spans),
        slo={"status": serve.slo_status(), "history": _obs.slo_history()},
        counters=deltas,
        autoscaler={"decisions": dep["decisions"],
                    "dropped": dep["decisions_dropped"]},
        autopsy=_obs.autopsy_summary(),
        chaos={"injections": _plan.injection_log(normalize=True),
               "count": int(deltas.get("chaos.injected_total", 0))},
        timeline=tl_log,
    )
    rundir = tempfile.mkdtemp(prefix="raytpu_day_run_")
    trace_path = os.path.join(rundir, "trace.jsonl")
    _replay.write_trace(trace_path, header, records)
    ledger_path = os.path.join(rundir, "ledger.json")
    _ledger.save(ledger_path, ledger)
    gate_res = _ledger.gate(ledger)
    _require(gate_res["ok"], f"run ledger failed its gates: {gate_res['checks']}")
    from ray_tpu_torch.serve.handle import _reset_registry

    _reset_registry()  # park router threads before the invariant battery
    return {
        "cluster": cluster,
        "details": {
            "trace_sha256": trace_sha, "trace_path": trace_path,
            "ledger_path": ledger_path, "gate": gate_res,
            "total": ledger["load"]["total"], "swap_version": published,
            "timeline": tl_log,
        },
        # Driver-side deterministic fires: the calm-phase client flap
        # (fixed hit window over a fixed record count) + the preemption
        # notice (fixed nth). Replica-side fires (slow window, swap delay)
        # reach /metrics via the reporters.
        "min_injections": 2,
        "min_metric_injections": 3,
    }


SCENARIOS: dict = {
    "worker_kill": _scn_worker_kill,
    "day_in_the_life": _scn_day_in_the_life,
    "elastic_preempt": _scn_elastic_preempt,
    "pull_source_death": _scn_pull_source_death,
    "controller_restart": _scn_controller_restart,
    "mac_corrupt_storm": _scn_mac_corrupt_storm,
    "tpu_preempt_drain": _scn_tpu_preempt_drain,
    "ring_link_loss": _scn_ring_link_loss,
    "overload_storm": _scn_overload_storm,
    "autoscale_flap": _scn_autoscale_flap,
    "ckpt_kill_mid_save": _scn_ckpt_kill_mid_save,
}


def run_scenario(name: str, seed: int = 0, quick: bool = False) -> dict:
    """Run one scenario end to end. Returns the report dict; report["ok"]
    is the pass verdict (workload asserts AND the invariant battery)."""
    fn: Optional[Callable] = SCENARIOS.get(name)
    if fn is None:
        raise ValueError(f"unknown scenario {name!r} (have: {sorted(SCENARIOS)})")
    from ray_tpu_torch.core import api

    if api.is_initialized():
        raise RuntimeError("chaos scenarios need a fresh process-level session "
                           "(ray_tpu_torch is already initialized)")
    t0 = time.monotonic()
    report: dict = {"scenario": name, "seed": seed, "ok": False}
    try:
        out = fn(seed, quick)
        cluster = out.pop("cluster")
        core = api._require_worker()
        inv = _inv.check_all(
            core, cluster,
            min_injections=out.get("min_injections", 1),
            min_metric_injections=out.get("min_metric_injections"),
        )
        report["details"] = out.get("details", {})
        report["invariants"] = inv
        report["injections"] = _plan.injection_log(normalize=True)
        report["ok"] = inv["ok"]
        if not inv["ok"]:
            report["flight_dump"] = _flight.dump(
                "chaos.invariant", reason=f"{name}: invariant battery failed")
    except ScenarioFailure as e:
        report["error"] = str(e)
        report["injections"] = _plan.injection_log(normalize=True)
        # A failed chaos invariant is exactly the moment the driver-side
        # ring is worth keeping: dump it next to the report.
        report["flight_dump"] = _flight.dump(
            "chaos.invariant", reason=f"{name}: {e}")
    except Exception as e:  # noqa: BLE001 - a lost task surfaces as GetTimeoutError etc.
        # The MOST interesting chaos outcome is an unexpected exception (a
        # get timeout IS the lost-task symptom this plane hunts): it must
        # land in the report with the injection log — the replay recipe —
        # not escape as a raw traceback that aborts the rest of the battery.
        report["error"] = f"{type(e).__name__}: {e}"
        report["injections"] = _plan.injection_log(normalize=True)
    finally:
        report["elapsed_s"] = round(time.monotonic() - t0, 2)
        _teardown()
    return report


# ---------------------------------------------------------------------------
# CLI (python -m ray_tpu_torch chaos ...)
# ---------------------------------------------------------------------------


def add_chaos_parser(sub) -> None:
    cp = sub.add_parser("chaos", help="seeded fault-injection scenario runner")
    csub = cp.add_subparsers(dest="chaos_cmd", required=True)
    crun = csub.add_parser("run", help="run one scenario in a fresh in-process cluster")
    crun.add_argument("scenario", choices=sorted(SCENARIOS) + ["all"])
    crun.add_argument("--seed", type=int, default=0)
    crun.add_argument("--quick", action="store_true", help="smaller workloads")
    csub.add_parser("list", help="scenarios + the fault-site catalog")


def cmd_chaos(args) -> int:
    if args.chaos_cmd == "list":
        from ray_tpu_torch.chaos.sites import catalog

        print("scenarios:")
        for name in sorted(SCENARIOS):
            print(f"  {name:22s} {(SCENARIOS[name].__doc__ or '').strip().splitlines()[0]}")
        print("\nfault sites (schedule rules name these):")
        for row in catalog():
            print(f"  {row['site']:24s} [{row['layer']}] kinds={','.join(row['kinds'])}")
            print(f"  {'':24s} {row['desc']}")
        return 0
    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    failed = 0
    for name in names:
        report = run_scenario(name, seed=args.seed, quick=args.quick)
        print(json.dumps(report, default=str))
        if not report["ok"]:
            failed += 1
    return 1 if failed else 0
