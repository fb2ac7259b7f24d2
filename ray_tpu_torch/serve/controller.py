"""ServeController: checkpointed control loop for all serve apps.

Role-equivalent to the reference's ServeController
(python/ray/serve/_private/controller.py:106 — a detached
actor that owns the deployment tables, runs the reconciliation control loop,
checkpoints to the GCS KV, and is recovered by actor restart) and its
DeploymentState machinery (deployment_state.py — replica start/stop/health)
and AutoscalingState (autoscaling_state.py — handle-demand driven decisions).

Redesign notes: one reconcile thread replaces the reference's asyncio
control-loop tasks; state checkpoints go to the cluster controller's KV
(equivalent of the GCS internal KV). Replicas are detached named actors so a
restarted ServeController re-adopts them by name instead of restarting them.

Scale plane (ray_tpu_torch/scale/): autoscaling decisions fold the QoS admission
controller's telemetry (per-class queue-delay minima, AIMD limit slope,
shed/expired rates pushed by the proxy via record_qos_telemetry) with
handle demand reports and replica queue depths (heartbeats) through a
DemandEstimator + ScalePolicy (hysteresis + flip cooldown). When a wanted
replica cannot be placed, its resource footprint is reported to the core
controller's external-demand table so the NODE autoscaler launches
capacity — the overload controller requests machines instead of only
shedding. Decisions land in a bounded per-deployment log (get_serve_state,
/api/serve, `raytpu list replicas`), on serve.autoscale.* gauges, and as
scale.decision trace spans when tracing is on.
"""
from __future__ import annotations

import random
import threading
import time
import traceback
from typing import Any, Optional

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.core import serialization
from ray_tpu_torch.scale.signals import DemandEstimator
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

SERVE_NAMESPACE = "serve"
CONTROLLER_NAME = "__serve_controller__"
CHECKPOINT_KEY = "serve:checkpoint"


def _kv_put(key: str, value: bytes):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core.controller.call("kv_put", {"ns": SERVE_NAMESPACE, "key": key, "value": value}))


def _kv_get(key: str) -> Optional[bytes]:
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("kv_get", {"ns": SERVE_NAMESPACE, "key": key}))


def _kv_del(key: str):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core.controller.call("kv_del", {"ns": SERVE_NAMESPACE, "key": key}))


def _ctl_call(method: str, payload: dict) -> dict:
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call(method, payload)) or {}


class _DeploymentState:
    """Desired + actual state for one deployment in one app."""

    def __init__(self, app_name: str, spec: dict):
        self.app = app_name
        self.spec = spec  # {name, blob, config-dict, route_prefix}
        self.replicas: dict[str, Any] = {}  # name -> ActorHandle
        self.replica_rev: dict[str, int] = {}  # name -> spec_rev it was built from
        self.spec_rev = 0  # bumped on every code/config change (rolling update)
        self.version = 0
        self.target = spec["config"]["initial_replicas"]
        self.demand: dict[int, tuple[float, float]] = {}  # handle_id -> (demand, ts)
        self.status = "UPDATING"
        # -- scale plane -------------------------------------------------
        # Replica queue depths from heartbeats: name -> (ongoing, ts).
        self.replica_depths: dict[str, tuple[float, float]] = {}
        self.estimator = DemandEstimator()
        self.policy = None  # built lazily from autoscaling_config
        self.last_estimate: Optional[dict] = None
        self.scale_log: list[dict] = []  # applied/suppressed decisions (bounded)
        self.scale_log_dropped = 0  # counted trim: the log is bounded
        self.unmet_reported = 0  # replicas wanted but unplaceable, as reported

    MAX_SCALE_LOG = 100

    @property
    def name(self) -> str:
        return self.spec["name"]

    def log_decision(self, rec: dict) -> None:
        self.scale_log.append(rec)
        if len(self.scale_log) > self.MAX_SCALE_LOG:
            trim = len(self.scale_log) - self.MAX_SCALE_LOG
            del self.scale_log[:trim]
            self.scale_log_dropped += trim


class ServeController:
    """Detached actor; restart-recoverable from its KV checkpoint."""

    def __init__(self):
        self.lock = threading.RLock()
        self.apps: dict[str, dict[str, _DeploymentState]] = {}
        self.routes: dict[str, tuple[str, str]] = {}  # prefix -> (app, deployment)
        self.http_port: Optional[int] = None
        self._stop = threading.Event()
        # QoS telemetry pushed by proxies (scale plane): reporter -> (report, ts).
        self.qos_reports: dict[str, tuple[dict, float]] = {}
        # Autoscaler observability: actual + target replica counts per
        # deployment (reporter -> controller -> /metrics).
        self._replicas_gauge = _metrics.Gauge(
            "serve.autoscale.replicas",
            "live replicas per deployment (scale plane actual)",
            tag_keys=("app", "deployment"))
        self._target_gauge = _metrics.Gauge(
            "serve.autoscale.target",
            "desired replicas per deployment (scale plane target)",
            tag_keys=("app", "deployment"))
        # Notified after every state-changing reconcile pass: server-side
        # blocking waits (wait_app_healthy) ride this instead of clients
        # polling get_status (reference: LongPollHost).
        self._state_changed = threading.Condition(self.lock)
        self._restore()
        self._thread = threading.Thread(target=self._control_loop, name="serve-ctl", daemon=True)
        self._thread.start()

    # -- public control API (called via actor methods) ---------------------
    def deploy_app(self, app_name: str, specs: list[dict], route_prefix: Optional[str]):
        """specs: [{name, blob(bytes: (callable,args,kwargs,user_config)),
        config: dict}] dependency-first; last one is the ingress."""
        with self.lock:
            old = self.apps.get(app_name, {})
            new: dict[str, _DeploymentState] = {}
            for spec in specs:
                prev = old.get(spec["name"])
                if prev is not None and prev.spec["blob"] == spec["blob"] and prev.spec["config"] == spec["config"]:
                    new[spec["name"]] = prev  # unchanged: keep replicas
                else:
                    st = _DeploymentState(app_name, spec)
                    if prev is not None:
                        # Code/config changed: adopt the old replicas at their
                        # old spec_rev; _reconcile rolls them over (new-code
                        # replicas start first, stale ones then stop).
                        st.replicas = prev.replicas
                        st.replica_rev = prev.replica_rev
                        st.spec_rev = prev.spec_rev + 1
                        st.version = prev.version + 1
                        # Carry the external-demand bookkeeping: the fresh
                        # state's 0 would otherwise match a now-satisfiable
                        # `missing == 0` and the stale table entry would
                        # leak node-autoscaler demand forever.
                        st.unmet_reported = prev.unmet_reported
                        if prev.spec["config"] == spec["config"]:
                            st.target = prev.target
                    new[spec["name"]] = st
            removed = [d for n, d in old.items() if n not in new]
            self.apps[app_name] = new
            self.routes = {p: t for p, t in self.routes.items() if t[0] != app_name}
            if route_prefix is not None:
                ingress = specs[-1]["name"]
                self.routes[route_prefix] = (app_name, ingress)
        for dep in removed:
            self._stop_all_replicas(dep)
            if dep.unmet_reported:
                self._report_unmet(dep, 0)  # release node-autoscaler demand
        self._checkpoint()

    def delete_app(self, app_name: str):
        with self.lock:
            deps = list(self.apps.pop(app_name, {}).values())
            self.routes = {p: t for p, t in self.routes.items() if t[0] != app_name}
        for dep in deps:
            self._stop_all_replicas(dep)
            if dep.unmet_reported:
                self._report_unmet(dep, 0)  # release node-autoscaler demand
        self._checkpoint()

    def shutdown(self):
        with self.lock:
            apps = list(self.apps)
        for a in apps:
            self.delete_app(a)
        _kv_del(CHECKPOINT_KEY)
        self._stop.set()

    def set_http_port(self, port: int):
        with self.lock:
            self.http_port = port
        self._checkpoint()

    # -- routing / status (called by handles + proxy) ----------------------
    def get_routing_info(self, app_name: str, deployment_name: str) -> Optional[dict]:
        with self.lock:
            dep = self.apps.get(app_name, {}).get(deployment_name)
            if dep is None:
                return None
            return {
                "replica_names": [n for n in dep.replicas],
                "version": dep.version,
                "max_ongoing_requests": dep.spec["config"]["max_ongoing_requests"],
                "request_router": dep.spec["config"].get("request_router"),
            }

    def get_route_table(self) -> dict:
        with self.lock:
            return {p: {"app": a, "deployment": d} for p, (a, d) in self.routes.items()}

    def get_http_port(self) -> Optional[int]:
        with self.lock:
            return self.http_port

    def record_handle_metrics(self, app: str, deployment: str, handle_id: int, demand: float, ts: float):
        with self.lock:
            dep = self.apps.get(app, {}).get(deployment)
            if dep is not None:
                dep.demand[handle_id] = (demand, ts)

    def record_qos_telemetry(self, reporter: str, report: dict, ts: float):
        """Proxy push (scale plane): the AIMD controller's telemetry plus
        per-deployment shed/expired/request tallies. Folded into each
        autoscaling deployment's demand estimate next control-loop tick."""
        with self.lock:
            self.qos_reports[reporter] = (report, ts)
            # Expired reporters (dead proxies) age out; the table stays
            # bounded by the live proxy count.
            cutoff = time.time() - 60.0
            for gone in [r for r, (_, t) in self.qos_reports.items() if t < cutoff]:
                del self.qos_reports[gone]

    def get_serve_state(self) -> dict:
        """The scale-plane view: per-deployment targets, live replicas with
        their heartbeat queue depths, the last demand estimate, and the
        bounded autoscale decision log. Serves /api/serve and
        `raytpu list replicas`."""
        now = time.time()
        with self.lock:
            return {
                "http_port": self.http_port,
                "apps": {
                    a: {
                        d.name: {
                            "status": d.status,
                            "target": d.target,
                            "autoscaling": bool(
                                d.spec["config"].get("autoscaling_config")),
                            "replicas": [
                                {
                                    "name": n,
                                    "rev": d.replica_rev.get(n, -1),
                                    "ongoing": d.replica_depths.get(n, (None, 0))[0],
                                }
                                for n in d.replicas
                            ],
                            "demand": sum(
                                dm for dm, ts in d.demand.values()
                                if now - ts < 5.0
                            ),
                            "unmet_replicas": d.unmet_reported,
                            "last_estimate": d.last_estimate,
                            "decisions": list(d.scale_log[-20:]),
                            "decisions_dropped": d.scale_log_dropped,
                        }
                        for d in deps.values()
                    }
                    for a, deps in self.apps.items()
                },
            }

    def get_status(self) -> dict:
        with self.lock:
            return {
                "http_port": self.http_port,
                "apps": {
                    a: {
                        d.name: {
                            "status": d.status,
                            "target": d.target,
                            "replicas": len(d.replicas),
                            "version": d.version,
                        }
                        for d in deps.values()
                    }
                    for a, deps in self.apps.items()
                },
            }

    def ping(self) -> bool:
        return True

    def wait_app_healthy(self, app_name: str, timeout_s: float = 60.0) -> bool:
        """Block (server-side, event-driven) until every deployment of the
        app is HEALTHY — replaces client-side status polling (the reference's
        long-poll pattern, long_poll.py: clients wait on the controller, the
        controller notifies on state change). Runs on its own actor lane
        (max_concurrency > 1), so the control loop keeps reconciling."""
        deadline = time.time() + timeout_s
        while True:
            with self._state_changed:
                deps = self.apps.get(app_name, {})
                if deps and all(d.status == "HEALTHY" for d in deps.values()):
                    return True
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._state_changed.wait(timeout=min(remaining, 2.0))

    # -- control loop ------------------------------------------------------
    def _control_loop(self):
        import ray_tpu_torch as rt  # noqa: F401  (ensures API ready in this process)

        last_health = 0.0
        while not self._stop.is_set():
            try:
                with self.lock:
                    deps = [d for app in self.apps.values() for d in app.values()]
                changed = False
                for dep in deps:
                    changed |= self._autoscale(dep)
                    changed |= self._reconcile(dep)
                if time.time() - last_health > 2.0:
                    last_health = time.time()
                    for dep in deps:
                        changed |= self._health_check(dep)
                if changed:
                    self._checkpoint()
                    with self._state_changed:
                        self._state_changed.notify_all()
            except Exception:
                traceback.print_exc()
            self._stop.wait(0.1)

    def _reconcile(self, dep: _DeploymentState) -> bool:
        """Drive actual replica count to dep.target, rolling stale-code
        replicas over to the current spec (new replicas first, then stale
        ones stop — reference: deployment_state.py rolling updates)."""
        changed = False
        with self.lock:
            want = dep.target
            fresh = [n for n in dep.replicas if dep.replica_rev.get(n, -1) == dep.spec_rev]
            stale = [n for n in dep.replicas if dep.replica_rev.get(n, -1) != dep.spec_rev]
        started_any = False
        while len(fresh) < want:
            name = self._start_replica(dep)
            if name:
                changed = started_any = True
                fresh.append(name)
            else:
                break  # no capacity now; retry next tick
        # Scale plane: replicas we want but could not start are PENDING
        # DEMAND for the node autoscaler. Report the unmet footprint to the
        # core controller's external-demand table (and clear it once
        # satisfied) so "the cluster is full" turns into "launch a node"
        # instead of a wedged UPDATING deployment.
        missing = max(0, want - len(fresh))
        if missing != dep.unmet_reported:
            self._report_unmet(dep, missing)
        if len(fresh) >= want and stale:
            # Enough current-code capacity: retire old code.
            for name in stale:
                self._stop_replica(dep, name)
            changed = True
        elif stale and not started_any and len(fresh) + len(stale) >= want:
            # Capacity-saturated roll (stale replicas hold the resources the
            # new ones need): stop ONE stale replica so the next tick can
            # place its replacement — converges one-by-one instead of
            # wedging in UPDATING forever. The >= want guard caps the drain
            # at a single in-flight hole, so a new version that fails to
            # start cannot progressively take down working old replicas.
            self._stop_replica(dep, stale[0])
            changed = True
        if len(fresh) > want:
            for name in fresh[want:]:
                self._stop_replica(dep, name)
            changed = True
        with self.lock:
            n_fresh = sum(1 for n in dep.replicas if dep.replica_rev.get(n, -1) == dep.spec_rev)
            dep.status = "HEALTHY" if n_fresh >= dep.target and not any(
                dep.replica_rev.get(n, -1) != dep.spec_rev for n in dep.replicas
            ) else "UPDATING"
        return changed

    def _replica_footprint(self, dep: _DeploymentState) -> dict:
        """One replica's resource demand (the node-autoscaler shape: CPU/GPU
        + custom resources), derived from the deployment's actor options."""
        aopts = dict(dep.spec["config"].get("ray_actor_options") or {})
        demand = dict(aopts.get("resources") or {})
        num_cpus = float(aopts.get("num_cpus", 0.0))
        if num_cpus:
            demand["CPU"] = demand.get("CPU", 0.0) + num_cpus
        num_gpus = float(aopts.get("num_gpus", 0.0))
        if num_gpus:
            demand["GPU"] = demand.get("GPU", 0.0) + num_gpus
        return demand

    def _fits_somewhere(self, demand: dict) -> bool:
        """Does any ALIVE node currently have room for this footprint?"""
        from ray_tpu_torch.core.controller import _fits

        try:
            state = _ctl_call("get_cluster_state", {})
        except Exception:
            return True  # cannot tell: attempt the start and let it decide
        return any(
            n.get("state") == "ALIVE"
            and _fits(n.get("resources_available", {}), demand)
            for n in state.get("nodes", {}).values()
        )

    def _report_unmet(self, dep: _DeploymentState, missing: int) -> None:
        """Sync the deployment's unplaceable-replica demand with the core
        controller's external-demand table (missing == 0 clears it)."""
        source = f"serve:{dep.app}/{dep.name}"
        footprint = self._replica_footprint(dep)
        items = [{"demand": footprint, "label_selector": {}}] * missing if footprint else []
        # A zero-footprint replica fits any node, so nothing is registered
        # for it — but unmet_reported still records `missing` so the
        # reconcile tick does not re-call this RPC 10x/sec for the whole
        # failure. The RPC only runs when there is something to register or
        # a previous registration to clear.
        if footprint or dep.unmet_reported:
            try:
                _ctl_call("set_external_demand", {"source": source, "items": items})
            except Exception:
                return  # core controller hiccup: retry next reconcile
        with self.lock:
            dep.unmet_reported = missing

    def _start_replica(self, dep: _DeploymentState) -> Optional[str]:
        """Start one replica from the CURRENT spec; returns its name."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.replica import Replica

        # Chaos site scale.replica.start: delayed or failed replica startup
        # (slow node provisioning, image pulls, a flaky first health check).
        # The autoscale_flap scenario pins that a slow-to-arrive replica
        # does not make the scale policy oscillate.
        fault = _chaos.maybe_inject("scale.replica.start",
                                    deployment=dep.name, app=dep.app)
        if fault is not None:
            if fault.kind == "delay":
                time.sleep(fault.delay_s)
            elif fault.kind == "error":
                return None  # start fails this tick; reconcile retries
        # Fast feasibility gate: a footprint no live node can host right now
        # would wedge this loop for the whole startup timeout. Fail the
        # start immediately instead — _reconcile reports the unmet
        # footprint to the node autoscaler's external-demand table, and the
        # start retries next tick (by which time a node may have launched).
        footprint = self._replica_footprint(dep)
        if footprint and not self._fits_somewhere(footprint):
            return None
        callable_, args, kwargs, user_config = serialization.deserialize(dep.spec["blob"])
        rid = f"{dep.name}#{random.randrange(16**6):06x}"
        actor_name = f"{dep.app}:{rid}"
        cfg = dep.spec["config"]
        aopts = dict(cfg.get("ray_actor_options") or {})
        try:
            handle = (
                rt.remote(Replica)
                .options(
                    name=actor_name,
                    namespace=SERVE_NAMESPACE,
                    lifetime="detached",
                    max_concurrency=cfg["max_ongoing_requests"] + 4,
                    num_cpus=float(aopts.get("num_cpus", 0.0)),
                    num_gpus=float(aopts.get("num_gpus", 0.0)),
                    resources=dict(aopts.get("resources", {})),
                )
                .remote(dep.app, dep.name, rid, callable_, args, kwargs, user_config)
            )
            # Block until constructed so routing info only advertises live
            # replicas (reference waits for replica init too). Init may
            # legitimately take minutes (an LLM's weights and warmup).
            rt.get(
                handle.check_health.remote(),
                timeout=float(cfg.get("startup_timeout_s", 600.0)),
            )
        except Exception:
            traceback.print_exc()
            return None
        with self.lock:
            dep.replicas[actor_name] = handle
            dep.replica_rev[actor_name] = dep.spec_rev
            dep.version += 1
        return actor_name

    def _stop_replica(self, dep: _DeploymentState, name: str):
        import ray_tpu_torch as rt

        with self.lock:
            handle = dep.replicas.pop(name, None)
            dep.replica_rev.pop(name, None)
            dep.replica_depths.pop(name, None)
            dep.version += 1
        if handle is None:
            return
        try:
            rt.get(handle.prepare_for_shutdown.remote(), timeout=6)
        except Exception:
            pass
        try:
            rt.kill(handle)
        except Exception:
            pass

    def _stop_all_replicas(self, dep: _DeploymentState):
        with self.lock:
            names = list(dep.replicas)
        for n in names:
            self._stop_replica(dep, n)

    def _health_check(self, dep: _DeploymentState) -> bool:
        import ray_tpu_torch as rt

        with self.lock:
            items = list(dep.replicas.items())
        dead = []
        now = time.time()
        for name, handle in items:
            try:
                # heartbeat = health + queue depth in one round trip; the
                # depth feeds the scale plane's server-side demand view.
                hb = rt.get(handle.heartbeat.remote(), timeout=10)
                ok = bool(hb.get("healthy"))
                with self.lock:
                    dep.replica_depths[name] = (float(hb.get("ongoing", 0)), now)
            except Exception:
                ok = False
            if not ok:
                dead.append(name)
        for name in dead:
            with self.lock:
                dep.replicas.pop(name, None)
                dep.replica_rev.pop(name, None)
                dep.replica_depths.pop(name, None)
                dep.version += 1
            # Best-effort kill in case it's alive-but-unhealthy.
            try:
                rt.kill(rt.get_actor(name, namespace=SERVE_NAMESPACE))
            except Exception:
                pass
        return bool(dead)

    def _autoscale(self, dep: _DeploymentState) -> bool:
        cfg = dep.spec["config"]
        auto = cfg.get("autoscaling_config")
        with self.lock:
            # Observability regardless of autoscaling: actual + target.
            tags = {"app": dep.app, "deployment": dep.name}
            self._replicas_gauge.set(len(dep.replicas), tags=tags)
            self._target_gauge.set(dep.target, tags=tags)
        if not auto:
            return False
        from ray_tpu_torch.serve.config import AutoscalingConfig

        ac = AutoscalingConfig(**auto)
        now = time.time()
        with self.lock:
            if dep.policy is None:
                dep.policy = ac.to_policy()
            # Demand = most recent handle reports (stale ones expire).
            dep.demand = {h: (d, ts) for h, (d, ts) in dep.demand.items()
                          if now - ts < 5 * ac.metrics_interval_s + 1.0}
            # QoS reports that mention THIS deployment: the global AIMD
            # signals (delay minima, limit slope) attributed alongside the
            # deployment's own shed/expired tallies.
            dkey = f"{dep.app}/{dep.name}"
            qos_reports = []
            for reporter, (report, ts) in self.qos_reports.items():
                dstats = report.get("deployments", {}).get(dkey)
                if dstats is None:
                    continue  # this proxy never routed the deployment
                qos_reports.append((reporter, {
                    "delay_min_by_class": report.get("delay_min_by_class", {}),
                    "target_delay_s": report.get("target_delay_s", 0.0),
                    "limit_trend": report.get("limit_trend", 0.0),
                    "sheds_total": dstats.get("sheds_total", 0.0),
                    "expired_total": dstats.get("expired_total", 0.0),
                    "requests_total": dstats.get("requests_total", 0.0),
                }, ts))
            est = dep.estimator.fold(
                handle_demand=list(dep.demand.values()),
                replica_depths=list(dep.replica_depths.values()),
                qos_reports=qos_reports,
                now=now,
            )
            decision = dep.policy.decide(est, dep.target, now=now)
            dep.last_estimate = est.to_dict()
            if decision.applied or decision.reason == "cooldown":
                # Applied changes AND cooldown suppressions are logged — a
                # suppressed flip is exactly what the operator debugging an
                # oscillation needs to see.
                dep.log_decision({
                    "ts": decision.ts, "action": decision.action,
                    "applied": decision.applied, "from": dep.target,
                    "to": decision.target, "desired": decision.desired,
                    "reason": decision.reason,
                    "signals": decision.signals,
                })
            if not decision.applied:
                return False
            old = dep.target
            dep.target = decision.target
        if _tracing.trace_enabled():
            # A point trace per applied decision: the scale plane's actions
            # interleave with request spans on /api/traces.
            with _tracing.span("scale.decision", app=dep.app,
                               deployment=dep.name, action=decision.action,
                               reason=decision.reason, from_replicas=old,
                               to_replicas=decision.target):
                pass
        return True

    # -- checkpoint / restore ---------------------------------------------
    def _checkpoint(self):
        with self.lock:
            state = {
                "http_port": self.http_port,
                "routes": dict(self.routes),
                "apps": {
                    a: [
                        {
                            "spec": d.spec,
                            "replica_names": list(d.replicas),
                            "replica_rev": dict(d.replica_rev),
                            "spec_rev": d.spec_rev,
                            "version": d.version,
                            "target": d.target,
                        }
                        for d in deps.values()
                    ]
                    for a, deps in self.apps.items()
                },
            }
        blob, _ = serialization.serialize(state)
        try:
            _kv_put(CHECKPOINT_KEY, blob)
        except Exception:
            traceback.print_exc()

    def _restore(self):
        import ray_tpu_torch as rt

        try:
            blob = _kv_get(CHECKPOINT_KEY)
        except Exception:
            return
        if not blob:
            return
        state = serialization.deserialize(blob)
        self.http_port = state.get("http_port")
        self.routes = dict(state.get("routes", {}))
        for app_name, deps in state.get("apps", {}).items():
            table: dict[str, _DeploymentState] = {}
            for rec in deps:
                st = _DeploymentState(app_name, rec["spec"])
                st.version = rec["version"] + 1  # force router re-resolve
                st.target = rec["target"]
                st.spec_rev = rec.get("spec_rev", 0)
                # Re-adopt surviving detached replicas by name.
                for name in rec["replica_names"]:
                    try:
                        st.replicas[name] = rt.get_actor(name, namespace=SERVE_NAMESPACE)
                        st.replica_rev[name] = rec.get("replica_rev", {}).get(name, st.spec_rev)
                    except ValueError:
                        pass
                table[rec["spec"]["name"]] = st
            self.apps[app_name] = table
