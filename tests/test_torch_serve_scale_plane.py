"""The port's serve scale plane (``ray_tpu_torch.scale`` and serve's use of
it): the serve cases of ``tests/test_scale_plane.py`` on the port. Its
chunked-prefill engine cases are held against ``ray_tpu`` in
``tests/test_torch_chunked_prefill.py``.

Layers covered:
  * unit — DemandEstimator folding synthetic QoS telemetry (handle demand,
    replica depths, per-class delay minima, AIMD slope, shed/expiry rates);
    ScalePolicy hysteresis + flip-cooldown edges; the AffinityMap's counted
    LRU and release-on-death semantics; prefix-key derivation.
  * router — the handle's prefix->affinity->p2c pick order: hit, capacity
    fallback, pin release when a replica leaves the membership.
  * cluster — replica death under prefix routing (pins release, requests
    re-route, nothing routes to the dead replica), and the e2e scale-out:
    the AUTOSCALER (not a static replica count) grows a deployment to 3
    replicas under an overload_storm-style mix and goodput scales with it.
"""
from __future__ import annotations

import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.scale import AffinityMap, DemandEstimator, ScalePolicy, prefix_key_for_body
from ray_tpu_torch.scale.signals import DemandEstimate
from ray_tpu_torch.util import metrics as _metrics


def _counter_value(name: str, **tags) -> float:
    return sum(
        rec["value"] for rec in _metrics.snapshot()
        if rec["name"] == name
        and all(rec["tags"].get(k) == v for k, v in tags.items())
    )


# ---------------------------------------------------------------------------
# signals: folding synthetic QoS telemetry
# ---------------------------------------------------------------------------

def test_estimator_folds_handle_demand_and_replica_depths():
    est = DemandEstimator().fold(
        handle_demand=[(3.0, 100.0), (2.0, 100.0), (9.0, 1.0)],  # last: stale
        replica_depths=[(1.0, 100.0), (2.0, 100.0)],
        qos_reports=[],
        now=100.0,
    )
    assert est.demand == 5.0
    assert est.replica_depth == 3.0
    assert est.effective_demand == 5.0  # max of the two views
    assert not est.overloaded and est.reasons == ()


def test_estimator_standing_queue_and_aimd_backoff_signal_overload():
    def report(requests):
        return {
            "delay_min_by_class": {"best_effort": 0.4, "interactive": 0.0},
            "target_delay_s": 0.1, "limit_trend": -3.0,
            "sheds_total": 0.0, "expired_total": 0.0,
            "requests_total": requests,
        }

    e = DemandEstimator()
    e.fold([], [], [("p1", report(10.0), 100.0)], now=100.0)  # baseline
    est = e.fold([], [], [("p1", report(20.0), 101.0)], now=101.0)
    assert est.overloaded
    assert "standing_queue" in est.reasons and "aimd_backoff" in est.reasons
    assert est.worst_delay_min == 0.4 and est.limit_trend == -3.0


def test_estimator_idle_deployment_ignores_proxy_global_overload():
    """The delay minima / AIMD slope are proxy-global: a deployment with NO
    recent traffic through the proxy must not ride another deployment's
    overload (it would escalate to max_replicas for nothing)."""
    def report(requests):
        return {
            "delay_min_by_class": {"best_effort": 0.9},
            "target_delay_s": 0.1, "limit_trend": -5.0,
            "sheds_total": 0.0, "expired_total": 0.0,
            "requests_total": requests,
        }

    e = DemandEstimator()
    e.fold([], [], [("p1", report(10.0), 100.0)], now=100.0)
    # No request delta for this deployment: global signals gated off.
    est = e.fold([], [], [("p1", report(10.0), 101.0)], now=101.0)
    assert not est.overloaded and est.worst_delay_min == 0.0
    assert est.limit_trend == 0.0


def test_estimator_differentiates_shed_counters_into_rates():
    e = DemandEstimator()
    mk = lambda sheds, expired: {  # noqa: E731
        "delay_min_by_class": {}, "target_delay_s": 0.1, "limit_trend": 0.0,
        "sheds_total": sheds, "expired_total": expired,
    }
    first = e.fold([], [], [("p1", mk(10.0, 0.0), 100.0)], now=100.0)
    assert first.shed_rate == 0.0  # first sample only sets the baseline
    second = e.fold([], [], [("p1", mk(30.0, 4.0), 102.0)], now=102.0)
    assert second.shed_rate == pytest.approx(10.0)   # 20 sheds / 2s
    assert second.expired_rate == pytest.approx(2.0)
    assert second.overloaded and "shedding" in second.reasons
    # A restarted reporter (counters reset) never yields a negative rate.
    third = e.fold([], [], [("p1", mk(0.0, 0.0), 104.0)], now=104.0)
    assert third.shed_rate == 0.0 and third.expired_rate == 0.0


def test_estimator_expires_stale_qos_reports():
    report = {"delay_min_by_class": {"interactive": 9.0}, "target_delay_s": 0.1,
              "limit_trend": -1.0, "sheds_total": 100.0, "expired_total": 0.0}
    est = DemandEstimator().fold([], [], [("p1", report, 10.0)], now=100.0)
    assert not est.overloaded and est.worst_delay_min == 0.0


# ---------------------------------------------------------------------------
# policy: hysteresis + cooldown edges
# ---------------------------------------------------------------------------

def _est(demand=0.0, overloaded=False):
    e = DemandEstimate(demand=demand, overloaded=overloaded)
    if overloaded:
        e.reasons = ("shedding",)
    return e


def test_policy_overload_requests_capacity_beyond_demand_math():
    p = ScalePolicy(min_replicas=1, max_replicas=8, target_ongoing_requests=4.0,
                    upscale_delay_s=0.0)
    # Demand math alone says 1 replica suffices — but the QoS plane is
    # shedding, so the ask is current+1 (shed demand appears in no queue).
    d = p.decide(_est(demand=2.0, overloaded=True), current=2, now=100.0)
    assert d.applied and d.action == "upscale" and d.target == 3
    assert d.reason == "overload"


def test_policy_hysteresis_holds_until_delay_window_elapses():
    p = ScalePolicy(min_replicas=1, max_replicas=4, target_ongoing_requests=1.0,
                    upscale_delay_s=1.0, downscale_delay_s=2.0, cooldown_s=0.0)
    assert not p.decide(_est(demand=4.0), 1, now=100.0).applied   # window opens
    assert p.decide(_est(demand=4.0), 1, now=100.5).reason == "pending"
    d = p.decide(_est(demand=4.0), 1, now=101.01)
    assert d.applied and d.target == 4
    # A desire that flips direction mid-window restarts the timer.
    assert not p.decide(_est(demand=1.0), 4, now=101.5).applied
    assert not p.decide(_est(demand=1.0), 4, now=103.0).applied   # 1.5s < 2s
    assert p.decide(_est(demand=1.0), 4, now=103.6).applied


def test_policy_cooldown_suppresses_direction_flip():
    p = ScalePolicy(min_replicas=1, max_replicas=4, target_ongoing_requests=1.0,
                    upscale_delay_s=0.0, downscale_delay_s=0.0, cooldown_s=5.0)
    up = p.decide(_est(demand=3.0), 1, now=100.0)
    assert up.applied and up.target == 3
    # Demand evaporates immediately (the slow-replica-arrival illusion):
    # the downscale is SUPPRESSED inside the cooldown window…
    d = p.decide(_est(demand=0.0), 3, now=102.0)
    assert not d.applied and d.reason == "cooldown"
    # …and applies cleanly after it.
    d2 = p.decide(_est(demand=0.0), 3, now=105.1)
    assert d2.applied and d2.action == "downscale" and d2.target == 1
    # Same-direction escalation is never cooldown-blocked: a second
    # upscale right after an applied upscale goes through.
    p2 = ScalePolicy(min_replicas=1, max_replicas=4, target_ongoing_requests=1.0,
                     upscale_delay_s=0.0, downscale_delay_s=0.0, cooldown_s=5.0)
    assert p2.decide(_est(demand=2.0), 1, now=200.0).applied
    d3 = p2.decide(_est(demand=4.0), 2, now=200.5)
    assert d3.applied and d3.action == "upscale" and d3.target == 4


def test_policy_clamps_to_min_max():
    p = ScalePolicy(min_replicas=2, max_replicas=3, target_ongoing_requests=1.0,
                    upscale_delay_s=0.0, downscale_delay_s=0.0, cooldown_s=0.0)
    assert p.decide(_est(demand=100.0), 2, now=1.0).target == 3
    assert p.decide(_est(demand=0.0), 3, now=10.0).target == 2


# ---------------------------------------------------------------------------
# router structures
# ---------------------------------------------------------------------------

def test_affinity_map_counts_cap_evictions_and_releases_dead_replicas():
    evictions = []
    m = AffinityMap(cap=2, on_evict=lambda: evictions.append(1))
    m.pin("p:a", "r1")
    m.pin("p:b", "r2")
    m.get("p:a")          # refresh: "p:b" is now the LRU victim
    m.pin("p:c", "r1")
    assert m.evicted == 1 and len(evictions) == 1
    assert m.get("p:b") is None and m.get("p:a") == "r1"
    # Release-on-death drops every pin to the dead replica, uncounted as
    # cap eviction (it is a release, not capacity pressure).
    assert m.release_replica("r1") == 2
    assert m.evicted == 1 and len(m) == 0


def test_affinity_map_cap_is_per_kind_so_prefixes_cannot_thrash_model_pins():
    """High-cardinality prompt-prefix keys churn at their OWN cap: the
    multiplexed-model pin survives arbitrarily many unique-prompt requests
    (the failure the old separate model-affinity cache was immune to)."""
    m = AffinityMap(cap=4)
    m.pin("m:llama", "r1")
    for i in range(20):
        m.pin(f"p:digest{i}", "r2")
    assert m.get("m:llama") == "r1"           # never evicted by p: churn
    assert m.evicted == 16                    # p: kind churned at its cap
    assert m.snapshot()["by_kind"] == {"m": 1, "p": 4}


def test_prefix_key_for_body_shapes():
    body = b'{"tokens": [1, 2, 3], "max_tokens": 8}'
    k1 = prefix_key_for_body(body, "tA")
    k2 = prefix_key_for_body(b'{"tokens": [1, 2, 3], "max_tokens": 64}', "tA")
    assert k1 and k1 == k2  # same prompt head, different sampling: same key
    assert prefix_key_for_body(body, "tB") != k1  # tenant-scoped
    assert prefix_key_for_body(b'{"x": 1}') == ""  # no prompt: no key
    assert prefix_key_for_body(b"not json") == ""
    # Long prompts sharing their head map to one key (the system-prompt
    # workload): heads equal up to PREFIX_HEAD_TOKENS.
    shared = list(range(100))
    a = prefix_key_for_body(
        ('{"tokens": %s}' % (shared + [1])).encode())
    b = prefix_key_for_body(
        ('{"tokens": %s}' % (shared + [2])).encode())
    assert a == b != ""


def test_replica_set_pick_order_prefix_affinity_p2c():
    """The handle's routing order on a synthetic membership: prefix pin
    wins, then affinity pin, then p2c; pins release when the replica
    leaves; a pinned replica at capacity falls back (and re-pins)."""
    from ray_tpu_torch.serve.handle import _ReplicaSet

    rs = _ReplicaSet("t-app", "t-dep")
    try:
        rs.replicas = {"r1": object(), "r2": object(), "r3": object()}
        rs.max_ongoing = 2
        base_p = _counter_value("serve.routing.cache_hit_total",
                                kind="prefix", app="t-app", deployment="t-dep")
        keys = rs._routing_keys(prefix_key="px", affinity_key="ak")
        assert [k for k, _ in keys] == ["prefix", "affinity"]
        first = rs._pick_locked(keys)
        assert first in rs.replicas
        # Sticky: every later pick with the same prefix lands on `first`.
        for _ in range(5):
            assert rs._pick_locked(keys) == first
        assert _counter_value("serve.routing.cache_hit_total", kind="prefix",
                              app="t-app", deployment="t-dep") == base_p + 5
        # Prefix pin beats the affinity pin when they diverge.
        rs.affinity.pin("k:ak", [n for n in rs.replicas if n != first][0])
        assert rs._pick_locked(keys) == first
        # Affinity pin serves when only it matches.
        other = [n for n in rs.replicas if n != first][0]
        rs.affinity.pin("k:solo", other)
        assert rs._pick_locked((("affinity", "k:solo"),)) == other
        # Pinned replica at capacity: fall back to p2c and RE-PIN.
        rs.ongoing[first] = rs.max_ongoing
        moved = rs._pick_locked(keys)
        assert moved != first
        rs.ongoing[first] = 0
        assert rs._pick_locked(keys) == moved  # the pin moved with the pick
        # Membership departure releases the pin; next pick re-routes.
        del rs.replicas[moved]
        rs.affinity.retain(rs.replicas)
        assert rs.affinity.get("p:px") is None
        assert rs._pick_locked(keys) in rs.replicas
    finally:
        rs.close()


# ---------------------------------------------------------------------------
# cluster: prefix routing under replica death + autoscaled scale-out
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scale_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


@serve.deployment(name="Echo", num_replicas=2, max_ongoing_requests=4)
class Echo:
    def __init__(self):
        import os

        self.pid = os.getpid()

    def __call__(self, x="-"):
        return {"pid": self.pid, "x": x}


def test_prefix_routing_sticks_and_survives_replica_death(scale_cluster):
    handle = serve.run(Echo.bind(), name="pxapp", http=False)
    h = handle.options(prefix_key="sys-prompt-1")
    pids = {h.remote(i).result(timeout=30)["pid"] for i in range(6)}
    assert len(pids) == 1, f"prefix-keyed requests spread across {pids}"
    pinned_pid = pids.pop()
    # Find and kill the pinned replica actor.
    from ray_tpu_torch.serve.handle import SERVE_NAMESPACE, _replica_set

    rs = _replica_set("pxapp", "Echo")
    with rs.cond:
        pinned_name = rs.affinity.get("p:sys-prompt-1")
    assert pinned_name is not None
    rt.kill(rt.get_actor(pinned_name, namespace=SERVE_NAMESPACE))
    # The next prefix-keyed requests re-route (retry-on-death + pin
    # release) and re-stick to a LIVE replica — never the dead one.
    new_pids = {h.remote(i).result(timeout=60)["pid"] for i in range(6)}
    assert len(new_pids) == 1
    assert new_pids.pop() != pinned_pid
    with rs.cond:
        assert rs.affinity.get("p:sys-prompt-1") != pinned_name
    serve.delete("pxapp")


@serve.deployment(name="Busy", max_ongoing_requests=2,
                  autoscaling_config=serve.AutoscalingConfig(
                      min_replicas=1, max_replicas=3,
                      target_ongoing_requests=1.0,
                      upscale_delay_s=0.3, downscale_delay_s=5.0,
                      cooldown_s=1.0))
class Busy:
    def __call__(self, x="-"):
        time.sleep(0.05)
        return "ok"


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_autoscaler_scales_to_three_replicas_and_goodput_grows(scale_cluster):
    """The e2e scale-out: an overload_storm-shaped flood against an
    autoscaling deployment. The AUTOSCALER (not a static count) must grow
    the replica set to max_replicas=3, and the completed-request rate in
    the scaled-out window must beat the 1-replica opening window."""
    handle = serve.run(Busy.bind(), name="scaleout", http=False)
    ctl = rt.get_actor("__serve_controller__", namespace="serve")
    stop_at = time.monotonic() + 12.0
    lock = threading.Lock()
    done: list[float] = []  # completion timestamps

    def flood():
        while time.monotonic() < stop_at:
            try:
                handle.remote("x").result(timeout=30)
                with lock:
                    done.append(time.monotonic())
            except Exception:
                pass

    t0 = time.monotonic()
    threads = [threading.Thread(target=flood) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(not t.is_alive() for t in threads), "load threads wedged"

    state = rt.get(ctl.get_serve_state.remote(), timeout=30)
    dep = state["apps"]["scaleout"]["Busy"]
    assert dep["target"] == 3, f"autoscaler never reached 3 replicas: {dep}"
    assert len(dep["replicas"]) == 3
    ups = [d for d in dep["decisions"] if d["applied"] and d["action"] == "upscale"]
    assert ups, f"no applied upscale decision recorded: {dep['decisions']}"
    # Goodput scales: completions/s in the final 4s (scaled out) vs the
    # first 3s (1 replica, scale-out still pending).
    with lock:
        t_end = stop_at
        early = sum(1 for ts in done if ts - t0 <= 3.0) / 3.0
        late = sum(1 for ts in done if t_end - ts <= 4.0) / 4.0
    assert late > early, (
        f"goodput did not scale with replicas: early={early:.1f}/s late={late:.1f}/s"
    )
    serve.delete("scaleout")

