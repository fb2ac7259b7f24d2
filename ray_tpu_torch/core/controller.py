"""Cluster controller: the control plane (GCS equivalent).

Role-equivalent to the reference's GCS server (src/ray/gcs/
gcs_server.cc and friends): node table + health checks (GcsNodeManager /
GcsHealthCheckManager), actor lifecycle FSM (GcsActorManager,
gcs_actor_manager.h:48-76), placement groups (GcsPlacementGroupManager),
internal KV (GcsKvManager), pubsub (InternalPubSubGcsService), job table
(GcsJobManager), and the cluster resource view (GcsResourceManager +
ray_syncer). One deliberate architectural departure for the TPU build: task
scheduling is *central* — the controller holds the single resource ledger and
grants leases directly, instead of the reference's distributed
raylet-to-raylet spillback scheduling (cluster_lease_manager.cc). A TPU pod
is a mostly-static gang-scheduled domain, so a central ledger gives atomic
gang reservation (what the reference needs 2-phase commit across raylets
for) and strictly simpler failure semantics, at the cost of a scalability
ceiling that a pod-sized cluster does not hit.
"""
from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core import task_state as _ts
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.obs import _merge_events as _merge_trace_events
from ray_tpu_torch.obs import autopsy as _autopsy
from ray_tpu_torch.obs import flight as _flight
from ray_tpu_torch.obs import profiler as _profiler
from ray_tpu_torch.obs import slo as _slo
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.bgtasks import spawn_bg as _spawn_bg_task

logger = logging.getLogger(__name__)

# Actor FSM states (reference: gcs_actor_manager.h:48-76).
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


@dataclass
class NodeRecord:
    node_id: str
    address: str  # daemon rpc address
    resources_total: dict
    resources_available: dict
    labels: dict
    store_path: str
    conn: Any = None
    last_heartbeat: float = 0.0
    state: str = "ALIVE"
    # Latest daemon-reported object-store occupancy + worker table (rides
    # every heartbeat; the state API's list_nodes/list_workers source).
    store_stats: dict = field(default_factory=dict)
    workers: list = field(default_factory=list)
    # Drain protocol (reference: NodeManagerService.DrainRaylet): a draining
    # node accepts no NEW leases/actors/bundles but keeps serving running
    # work and object reads until the drainer terminates it.
    draining: bool = False


@dataclass
class ActorRecord:
    actor_id: ActorID
    spec: Any  # ActorSpec
    state: str = PENDING
    node_id: str = ""
    worker_addr: str = ""
    worker_id: str = ""
    restarts_used: int = 0
    death_cause: str = ""
    pending_waiters: list = field(default_factory=list)


@dataclass
class BundleState:
    index: int
    resources: dict
    node_id: str = ""
    available: dict = field(default_factory=dict)


@dataclass
class PGRecord:
    pg_id: PlacementGroupID
    bundles: list  # [BundleState]
    strategy: str
    state: str = "PENDING"
    name: str = ""
    job_id: Optional[JobID] = None
    pending_waiters: list = field(default_factory=list)
    # Gang label constraint: every bundle lands only on nodes matching this
    # (reference: LabelSelector in bundle scheduling — label_selector.h used
    # by TPU-slice gang reservation, SURVEY §2.1).
    label_selector: dict = field(default_factory=dict)


@dataclass
class PendingLease:
    lease_id: str
    demand: dict
    strategy: Any
    label_selector: dict
    future: asyncio.Future
    job_id: Optional[str] = None
    conn: Any = None


def _fits(avail: dict, demand: dict) -> bool:
    return all(avail.get(k, 0) + 1e-9 >= v for k, v in demand.items())


def _sub(avail: dict, demand: dict):
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) - v


def _add(avail: dict, demand: dict):
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) + v


def _labels_match(labels: dict, selector: dict) -> bool:
    """Label selector semantics (reference: common/scheduling/label_selector.h):
    values "v" (equals), "!v" (not equals), "in(a,b)", "!in(a,b")."""
    for key, cond in selector.items():
        val = labels.get(key)
        if cond.startswith("!in(") and cond.endswith(")"):
            if val is not None and str(val) in cond[4:-1].split(","):
                return False
        elif cond.startswith("in(") and cond.endswith(")"):
            if val is None or str(val) not in cond[3:-1].split(","):
                return False
        elif cond.startswith("!"):
            if val is not None and str(val) == cond[1:]:
                return False
        else:
            if val is None or str(val) != cond:
                return False
    return True


class Controller:
    def __init__(self, config: Config, host: str | None = None, persist_path: str | None = None):
        """persist_path enables control-plane fault tolerance: hard state
        (KV, actors, PGs, jobs, named-actor table) snapshots to this file and
        a restarted Controller on the same address restores it, re-adopting
        daemons/actors as they re-register (reference: GCS FT via a
        persistent StoreClient, gcs_server.h:136 kRedisStorage; here a local
        snapshot file plays the Redis role — same recovery contract)."""
        self.config = config
        self.persist_path = persist_path
        self.server = rpc.RpcServer(self, host=host or config.node_ip)
        self.nodes: dict[str, NodeRecord] = {}
        self.kv: dict[str, dict[str, bytes]] = {}  # namespace -> {key: value}
        self.actors: dict[ActorID, ActorRecord] = {}
        self.named_actors: dict[tuple[str, str], ActorID] = {}
        self.pgs: dict[PlacementGroupID, PGRecord] = {}
        self.leases: dict[str, tuple[str, dict, Any, Any]] = {}  # lease_id -> (node_id, demand, strategy, owner_conn)
        self.pending_leases: list[PendingLease] = []
        self.pending_actors: list = []  # ActorRecords parked until placeable
        self.object_dir: dict[bytes, set[str]] = {}  # oid bytes -> node ids
        self.object_sizes: dict[bytes, int] = {}
        # External pending demand (scale plane): control planes above the
        # scheduler (the ServeController's unplaceable replicas) register
        # resource footprints here; the autoscaler treats them exactly like
        # pending task/actor demand. source -> [{"demand", "label_selector"}].
        self.external_demand: dict[str, list] = {}
        # Elastic train plane: per-experiment live-resize epochs. Every
        # resize attempt fences on a bump here, so a stale controller
        # incarnation can never race a newer one's in-flight transfer.
        self.elastic_epochs: dict[str, int] = {}
        self.elastic_epochs_evicted = 0
        self.subscribers: dict[str, set] = {}  # channel -> conns
        self.jobs: dict[str, dict] = {}
        self._job_counter = 0
        self._rr_counter = 0
        self._bg: list[asyncio.Task] = []
        # Strong refs to fire-and-forget tasks (asyncio tracks tasks weakly;
        # an unreferenced scheduling-retry task GC-killed mid-await means a
        # pending task or actor is never placed — the exact bug class the
        # worker init-task fix diagnosed, enforced by graftlint in ray_tpu).
        self._misc_tasks: set[asyncio.Task] = set()
        self.events: list[dict] = []  # structured event log (ray_event_recorder equiv)
        self.events_dropped = 0  # control events lost to log trims
        self.task_events: list[dict] = []  # aggregated per-worker task events
        self.task_events_dropped = 0  # task events lost to buffer trims
        self.metrics_by_reporter: dict[str, tuple] = {}
        # Trace index: trace_id -> {name, start, end, spans, workers, events}.
        # Bounded both ways (traces and events-per-trace) so a chatty trace
        # cannot grow controller memory; events stored here survive
        # task_events trims, which is what makes /api/traces useful.
        self.traces: dict[str, dict] = {}
        self.traces_evicted = 0  # whole traces dropped by the index bound
        self.MAX_TRACES = 256
        self.MAX_TRACE_EVENTS = 512
        # Per-task state index (GcsTaskManager equivalent): one record per
        # (task_id, attempt), folded from lifecycle events (task_state.py).
        # Bounded independently of the flat task_events buffer — trimming
        # that buffer no longer loses live-task state.
        self.task_index: dict[tuple[str, int], dict] = {}
        self.tasks_evicted = 0  # index records dropped by the bound
        # Checkpoint registry (ckpt plane): every save attempt's outcome
        # (committed AND aborted — an invisible failed save is a debugging
        # session), plus the per-channel latest-committed pointer that
        # drives weight publication. Derivable from shared storage, so NOT
        # in the snapshot: a restarted controller re-learns ids as savers
        # re-register and subscribers fall back to their poll path.
        self.ckpt_registry: dict[str, dict] = {}
        self.ckpt_channels: dict[str, dict] = {}
        self.ckpt_evicted = 0  # registry rows dropped by the bound
        self.MAX_CKPT_REGISTRY = 512
        # Observability plane: the flight-dump registry ("where is the
        # post-mortem" index — workers/daemons report every black-box dump
        # path here) and the SLO burn-rate engine (objectives seeded from
        # config.slo_spec; more arrive at runtime via slo_register).
        self.flight_dumps: list[dict] = []
        self.flight_dumps_dropped = 0  # dump records lost to the registry bound
        self.MAX_FLIGHT_DUMPS = 256
        # Alert-triggered profile captures: on an SLO burn ALERT the
        # controller snapshots a merged cluster flamegraph here (the
        # incident carries its own cost attribution). One capture per
        # objective per limiter window — rate-limited exactly like flight
        # dumps, so a flapping alert cannot turn the profiler into the
        # incident. Bounded, counted.
        self.incident_profiles: list[dict] = []
        self.incident_profiles_dropped = 0
        self.MAX_INCIDENT_PROFILES = 32
        self._profile_limiter = _profiler.CaptureLimiter(min_interval_s=2.0)
        self.slo_engine = _slo.SloEngine()
        if config.slo_spec:
            self._load_slo_spec(config.slo_spec)
        self._dirty = False
        # Actors restored from a snapshot as ALIVE/RESTARTING must be
        # re-confirmed by their daemon's re-registration within the grace
        # window, else their worker is assumed gone and the restart FSM runs.
        self._unconfirmed_actors: set[ActorID] = set()
        self._reconcile_deadline: float | None = None
        if persist_path:
            self._restore_snapshot()

    # ------------------------------------------------------------------
    async def start(self, port: int = 0) -> str:
        if self.config.chaos_spec:
            # The head arms its own chaos plane from the same config it
            # pushes to every daemon/worker (controller-side sites:
            # heartbeat drops, lease-grant latency/failure).
            _chaos.install_from_json(self.config.chaos_spec)
        addr = await self.server.start(port)
        self._bg.append(asyncio.create_task(self._health_check_loop()))
        self._bg.append(asyncio.create_task(self._slo_eval_loop()))
        if self.persist_path:
            self._bg.append(asyncio.create_task(self._snapshot_loop()))
        logger.info("controller listening on %s", addr)
        return addr

    def _spawn_bg(self, coro, name: str | None = None) -> "asyncio.Task":
        """create_task with a strong reference held until completion (the
        bg-strong-ref invariant; see util.bgtasks)."""
        return _spawn_bg_task(self._misc_tasks, coro, name=name)

    async def stop(self):
        for t in self._bg:
            t.cancel()
        for t in list(self._misc_tasks):
            t.cancel()
        if self.persist_path and self._dirty:
            # Final flush BEFORE closing the server: acknowledged mutations
            # must survive a graceful stop, and the close below triggers
            # disconnect churn (node-dead, driver-exit) that must NOT be
            # persisted as real state. Crashes can still lose <0.25s.
            try:
                self._write_snapshot()
                self._dirty = False
            except Exception:
                logger.exception("final controller snapshot failed")
        await self.server.close()

    def _event(self, kind: str, **kw):
        # tracing.now(): one clock across controller events, worker task
        # events, and spans (comparable timestamps in merged views).
        ev = {"ts": _tracing.now(), "kind": kind, **kw}
        self.events.append(ev)
        # Tee into the head process's flight recorder: a controller crash
        # dump then carries the control-plane decisions (node_dead,
        # slo_state, chaos events) next to the spans.
        _flight.absorb(ev)
        self._dirty = True
        if len(self.events) > self.config.event_buffer_size:
            trimmed = len(self.events) // 2
            self.events_dropped += trimmed
            del self.events[:trimmed]

    # -- SLO burn-rate engine (observability plane) ----------------------
    def _load_slo_spec(self, spec_json: str):
        """Objectives declared in config (RAYTPU_SLO_SPEC / slo_spec): a JSON
        object or list of objects in obs/slo.py spec format. Bad entries are
        rejected loudly and individually — one typo must not disarm the rest."""
        import json

        try:
            specs = json.loads(spec_json)
        except ValueError as e:
            logger.error("slo_spec is not valid JSON, ignored: %s", e)
            return
        for spec in specs if isinstance(specs, list) else [specs]:
            try:
                self.slo_engine.register(spec)
            except (TypeError, ValueError) as e:
                logger.error("slo objective rejected: %r (%s)", spec, e)

    async def _slo_eval_loop(self):
        """Re-evaluate every objective against the SAME merged series the
        dashboard scrapes (google-SRE multi-window burn rates, obs/slo.py).
        State changes become event-log entries; ALERT transitions are also
        stamped onto recently-active traces so a latency investigation that
        starts from a trace sees the burn alert in-line with the spans."""
        while True:
            await asyncio.sleep(max(0.1, self.config.slo_eval_interval_s))
            if not self.slo_engine.trackers:
                continue  # quiet path: no objectives, no work
            try:
                series = self.handle_get_metrics(None, {})
            except Exception:
                logger.exception("slo metrics snapshot failed")
                continue
            now = _tracing.now()
            for row in self.slo_engine.ingest(now, series):
                self._event("slo_state", objective=row["objective"]["name"],
                            state=row["state"], burn_fast=row["burn_fast"],
                            burn_slow=row["burn_slow"])
                if row["state"] == _slo.ALERT:
                    self._stamp_slo_alert(now, row)
                    # Incident capture: snapshot the cluster's recent
                    # profile window so the burn alert carries its own
                    # flamegraph. Fires once per alert transition, rate-
                    # limited per objective like flight dumps.
                    self._spawn_bg(self._capture_incident_profile(row),
                                   name="slo-profile-capture")

    def _stamp_slo_alert(self, now: float, row: dict):
        """Append one alert point-event inside every recently-active indexed
        trace (bounded scan; per-trace caps still apply, counted)."""
        ev = {"ts": now, "kind": "slo_alert", "name": row["objective"]["name"],
              "state": row["state"], "worker": "controller"}
        horizon = now - row["objective"].get("fast_window_s", 60.0)
        for i, t in enumerate(reversed(list(self.traces.values()))):
            if i >= 64:
                break  # bounded: newest 64 traces is "recently active"
            if t["end"] < horizon:
                continue
            if len(t["events"]) < self.MAX_TRACE_EVENTS:
                t["events"].append(ev)
            else:
                t["dropped"] += 1

    async def _capture_incident_profile(self, row: dict):
        """Snapshot a merged cluster flamegraph for one SLO burn alert into
        the bounded incident registry. EXACTLY once per alert transition:
        the FSM only yields rows on state changes, and the per-objective
        limiter (flight-dump discipline) absorbs flapping."""
        name = row["objective"]["name"]
        if not self._profile_limiter.allow(name):
            return
        try:
            merged = await self.handle_profile_collect(
                None, {"window_s": 60.0, "max_stacks": 512})
        except Exception:
            logger.exception("incident profile capture failed (%s)", name)
            return
        rec = {"ts": _tracing.now(), "objective": name, "state": row["state"],
               "burn_fast": row.get("burn_fast"), "profile": merged}
        self.incident_profiles.append(rec)
        if len(self.incident_profiles) > self.MAX_INCIDENT_PROFILES:
            trimmed = len(self.incident_profiles) - self.MAX_INCIDENT_PROFILES
            self.incident_profiles_dropped += trimmed
            del self.incident_profiles[:trimmed]
        self._event("profile_capture", objective=name,
                    samples=merged.get("samples", 0),
                    procs=len(merged.get("procs") or []))

    # -- persistence (control-plane fault tolerance) --------------------
    async def _snapshot_loop(self):
        while True:
            await asyncio.sleep(0.25)
            if self._dirty:
                self._dirty = False
                try:
                    self._write_snapshot()
                except Exception:
                    logger.exception("controller snapshot failed")

    def _write_snapshot(self):
        import pickle

        state = {
            # Runtime-env packages (multi-MB content-addressed zips) are
            # excluded: re-pickling them every snapshot tick would stall the
            # loop. After a controller restart, new materializations of those
            # URIs need a re-upload (daemon-side extracted caches survive).
            "kv": {ns: v for ns, v in self.kv.items() if ns != "runtime_env_pkg"},
            "jobs": self.jobs,
            "job_counter": self._job_counter,
            "named_actors": {k: v.binary() for k, v in self.named_actors.items()},
            "actors": [
                {
                    "actor_id": a.actor_id.binary(),
                    "spec": a.spec,
                    "state": a.state,
                    "node_id": a.node_id,
                    "worker_addr": a.worker_addr,
                    "worker_id": a.worker_id,
                    "restarts_used": a.restarts_used,
                    "death_cause": a.death_cause,
                }
                for a in self.actors.values()
            ],
            "pgs": [
                {
                    "pg_id": pg.pg_id.binary(),
                    "bundles": [
                        {"index": b.index, "resources": b.resources, "node_id": b.node_id, "available": b.available}
                        for b in pg.bundles
                    ],
                    "strategy": pg.strategy,
                    "state": pg.state,
                    "name": pg.name,
                    "job_id": pg.job_id,
                    "label_selector": pg.label_selector,
                }
                for pg in self.pgs.values()
            ],
        }
        tmp = f"{self.persist_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=5)
        os.replace(tmp, self.persist_path)

    def _restore_snapshot(self):
        import pickle

        try:
            with open(self.persist_path, "rb") as f:
                state = pickle.load(f)
        except FileNotFoundError:
            return
        self.kv = state["kv"]
        self.jobs = state["jobs"]
        self._job_counter = state["job_counter"]
        for rec in state["actors"]:
            if rec["state"] == DEAD:
                continue  # tombstones need no recovery
            r = ActorRecord(
                actor_id=ActorID(rec["actor_id"]),
                spec=rec["spec"],
                state=rec["state"],
                node_id=rec["node_id"],
                worker_addr=rec["worker_addr"],
                worker_id=rec["worker_id"],
                restarts_used=rec["restarts_used"],
                death_cause=rec["death_cause"],
            )
            self.actors[r.actor_id] = r
            if r.state in (ALIVE, RESTARTING):
                self._unconfirmed_actors.add(r.actor_id)
            elif r.state == PENDING:
                self.pending_actors.append(r)
        # Only name entries whose records were restored: DEAD tombstones are
        # dropped above, and a dangling name would KeyError every lookup.
        self.named_actors = {
            k: ActorID(v) for k, v in state["named_actors"].items() if ActorID(v) in self.actors
        }
        for rec in state["pgs"]:
            pg = PGRecord(
                pg_id=PlacementGroupID(rec["pg_id"]),
                bundles=[
                    BundleState(b["index"], dict(b["resources"]), node_id=b["node_id"], available=dict(b["available"]))
                    for b in rec["bundles"]
                ],
                strategy=rec["strategy"],
                state=rec["state"],
                name=rec["name"],
                job_id=rec["job_id"],
                label_selector=rec["label_selector"],
            )
            self.pgs[pg.pg_id] = pg
        self._reconcile_deadline = time.monotonic() + self.config.controller_reconcile_grace_s
        logger.info(
            "controller restored: %d actors (%d unconfirmed), %d PGs, %d KV namespaces",
            len(self.actors), len(self._unconfirmed_actors), len(self.pgs), len(self.kv),
        )

    # -- pubsub ---------------------------------------------------------
    def handle_subscribe(self, conn, p):
        self.subscribers.setdefault(p["channel"], set()).add(conn)
        conn.on_close = self._make_close_cb(conn)
        return True

    def handle_worker_logs(self, conn, p):
        """Fan worker stdout/stderr lines out to drivers subscribed to the
        ``logs`` channel (reference: log_monitor publishes through GCS pubsub
        and drivers print — _private/log_monitor.py)."""
        self.publish("logs", p.get("worker_id", ""), p)

    def publish(self, channel: str, key: str, data: Any):
        dead = []
        for conn in self.subscribers.get(channel, ()):  # push-based; the
            # reference uses long-polling (pubsub/publisher.h:233) because gRPC
            # streams were historically avoided; symmetric sockets let us push.
            if conn.closed:
                dead.append(conn)
                continue
            try:
                # Fire-and-forget enqueue: a publish storm (log lines, task
                # events) coalesces into one envelope per subscriber per
                # loop tick instead of one frame + one task per event.
                conn.notify_soon("pub", {"channel": channel, "key": key, "data": data})
            except Exception:
                dead.append(conn)
        for c in dead:
            self.subscribers[channel].discard(c)

    # -- connection lifecycle ------------------------------------------
    def on_connection(self, conn):
        conn.on_close = self._make_close_cb(conn)

    def _make_close_cb(self, conn):
        def cb(c):
            for subs in self.subscribers.values():
                subs.discard(c)
            role = c.meta.get("role")
            try:
                self._release_leases_of(c)
                if role == "daemon":
                    node_id = c.meta.get("node_id")
                    # Stale-close guard: a daemon that already redialed and
                    # re-registered has a NEW conn — this close event must not
                    # kill the fresh registration.
                    if node_id in self.nodes and self.nodes[node_id].conn is c:
                        self._spawn_bg(self._on_node_dead(node_id, "daemon disconnected"), name="on-node-dead")
                elif role == "driver":
                    self._spawn_bg(self._on_driver_exit(c.meta.get("job_id")), name="on-driver-exit")
            except RuntimeError:
                pass  # loop already shutting down

        return cb

    # -- node management ------------------------------------------------
    async def handle_register_node(self, conn, p):
        node = NodeRecord(
            node_id=p["node_id"],
            address=p["address"],
            resources_total=dict(p["resources"]),
            resources_available=dict(p["resources"]),
            labels=p.get("labels", {}),
            store_path=p.get("store_path", ""),
            conn=conn,
            last_heartbeat=time.monotonic(),
        )
        conn.meta.update(role="daemon", node_id=p["node_id"])
        self.nodes[p["node_id"]] = node
        # Re-registration after a controller restart: the daemon reports its
        # resident objects and live actors so the directory and actor FSMs
        # re-converge (reference: GCS FT — raylets resend their state on
        # RayletNotifyGCSRestart).
        for oid_bin, size in p.get("objects", []):
            self.object_dir.setdefault(oid_bin, set()).add(p["node_id"])
            self.object_sizes[oid_bin] = size
        # Restored CREATED placement groups re-consume their bundles on this
        # node (bundle reservations survive the control-plane restart).
        for pg in self.pgs.values():
            if pg.state == "CREATED":
                for b in pg.bundles:
                    if b.node_id == p["node_id"]:
                        _sub(node.resources_available, b.resources)
        for rec in p.get("actors", []):
            record = self.actors.get(ActorID(rec["actor_id"]))
            if record is None:
                continue
            record.node_id = p["node_id"]
            record.worker_addr = rec["worker_addr"]
            record.worker_id = rec["worker_id"]
            if record.state != DEAD:
                record.state = ALIVE
                self._wake_actor_waiters(record)
            self._unconfirmed_actors.discard(record.actor_id)
            # A live actor consumes its demand on the re-registered node
            # (unless it is inside a PG bundle, already accounted above).
            strategy = record.spec.options.scheduling_strategy
            if getattr(strategy, "kind", "") != "PLACEMENT_GROUP":
                _sub(node.resources_available, record.spec.options.resource_demand())
        self._event("node_alive", node_id=p["node_id"], resources=p["resources"])
        self.publish("node", p["node_id"], {"state": "ALIVE", "address": p["address"]})
        await self._retry_pending()
        return {"config": self.config.to_dict(), "nodes": self._node_table()}

    def _node_table(self):
        return {
            nid: {
                "address": n.address,
                "resources_total": n.resources_total,
                "resources_available": n.resources_available,
                "labels": n.labels,
                "store_path": n.store_path,
                "state": n.state,
                "draining": n.draining,
            }
            for nid, n in self.nodes.items()
        }

    def handle_drain_node(self, conn, p):
        """Start draining: no new leases/actors/bundles schedule onto the
        node; running work and object reads continue (reference:
        NodeManagerService.DrainRaylet). Idempotent; returns whether the
        node is currently free of running leases/actors (safe to terminate)."""
        node = self.nodes.get(p["node_id"])
        if node is None or node.state != "ALIVE":
            return {"ok": False, "reason": "no such live node"}
        node.draining = True
        self._event("node_draining", node_id=p["node_id"])
        idle = all(
            abs(node.resources_available.get(k, 0) - v) < 1e-6
            for k, v in node.resources_total.items()
        )
        return {"ok": True, "idle": idle}

    def handle_undrain_node(self, conn, p):
        node = self.nodes.get(p["node_id"])
        if node is not None:
            node.draining = False
            # Reopened capacity: demand that pended against the drain runs now.
            self._spawn_bg(self._retry_pending(), name="retry-pending")
        return {"ok": node is not None}

    def handle_heartbeat(self, conn, p):
        fault = _chaos.maybe_inject("controller.heartbeat", node=p.get("node_id", "")[:12])
        if fault is not None and fault.kind == "drop":
            # A lost heartbeat: last_heartbeat ages toward the death timeout
            # (enough consecutive drops = injected node-death declaration).
            return True
        node = self.nodes.get(p["node_id"])
        if node:
            node.last_heartbeat = time.monotonic()
            # Piggybacked node state (object-store occupancy + worker
            # table): the list_nodes/list_workers source, refreshed every
            # heartbeat without extra RPCs.
            if "store" in p:
                node.store_stats = p["store"]
            if "workers" in p:
                node.workers = p["workers"]
        return True

    def handle_get_cluster_state(self, conn, p):
        return {
            "nodes": self._node_table(),
            "actors": {
                a.actor_id.hex(): {
                    "state": a.state,
                    "node_id": a.node_id,
                    "worker_addr": a.worker_addr,
                    "name": a.spec.name,
                    "restarts": a.restarts_used,
                    "class": a.spec.cls_id,
                }
                for a in self.actors.values()
            },
            "placement_groups": {
                pg.pg_id.hex(): {
                    "state": pg.state,
                    "strategy": pg.strategy,
                    "bundles": [{"index": b.index, "resources": b.resources, "node_id": b.node_id} for b in pg.bundles],
                }
                for pg in self.pgs.values()
            },
            "jobs": self.jobs,
            "objects": {"count": len(self.object_dir), "bytes": sum(self.object_sizes.values())},
        }

    def handle_get_events(self, conn, p):
        events = self.events[-int(p.get("limit", 1000)):]
        if not p.get("with_stats"):
            return events
        # Observable loss: silently-trimmed buffers are themselves a signal
        # (satellite of the tracing work — nothing should vanish untallied).
        worker_dropped = 0.0
        for _ts, series in self.metrics_by_reporter.values():
            for rec in series:
                if rec["name"] == "events_dropped_total":
                    worker_dropped += rec["value"]
        return {
            "events": events,
            # Black-box dump paths (newest first): the "where is the
            # post-mortem" pointer right next to the event stream.
            "flight_dumps": list(reversed(self.flight_dumps[-20:])),
            "dropped": {
                "controller_events": self.events_dropped,
                "task_events": self.task_events_dropped,
                "worker_events": worker_dropped,
                "traces_evicted": self.traces_evicted,
                "tasks_evicted": self.tasks_evicted,
                "flight_dumps": self.flight_dumps_dropped,
            },
        }

    def handle_get_autoscaler_state(self, conn, p):
        """Pending demand + per-node load for the autoscaler (reference:
        GcsAutoscalerStateManager feeding autoscaler.proto's
        ClusterResourceState — pending resource requests / gang requests)."""
        # Bundle-bound (PLACEMENT_GROUP) and node-affinity leases can only run
        # on their fixed target — a new node can never host them, so they are
        # not autoscaler demand (the PG's capacity shows up via pending_gangs).
        pending = [
            {"demand": pl.demand, "label_selector": pl.label_selector, "kind": "lease"}
            for pl in self.pending_leases
            if getattr(pl.strategy, "kind", "DEFAULT") not in ("PLACEMENT_GROUP", "NODE_AFFINITY")
        ]
        for record in self.pending_actors:
            strategy = record.spec.options.scheduling_strategy
            if getattr(strategy, "kind", "DEFAULT") in ("PLACEMENT_GROUP", "NODE_AFFINITY"):
                continue  # bundle/node-bound: not free-form demand (see above)
            pending.append({
                "demand": record.spec.options.resource_demand(),
                "label_selector": record.spec.options.label_selector,
                "kind": "actor",
            })
        gang = [
            {"bundles": [b.resources for b in pg.bundles], "strategy": pg.strategy,
             "label_selector": pg.label_selector}
            for pg in self.pgs.values()
            if pg.state == "PENDING"
        ]
        for items in self.external_demand.values():
            for it in items:
                pending.append({
                    "demand": it.get("demand") or {},
                    "label_selector": it.get("label_selector") or {},
                    "kind": "external",
                })
        return {
            "pending": pending,
            "pending_gangs": gang,
            "nodes": self._node_table(),
        }

    def handle_set_external_demand(self, conn, p):
        """Register (or clear, with an empty items list) one source's
        external pending demand for the autoscaler (scale plane: the serve
        controller's unplaceable replica footprints)."""
        source = p.get("source") or ""
        items = p.get("items") or []
        if not source:
            return {"ok": False, "error": "source required"}
        if items:
            self.external_demand[source] = [
                {"demand": dict(it.get("demand") or {}),
                 "label_selector": dict(it.get("label_selector") or {})}
                for it in items
            ]
        else:
            self.external_demand.pop(source, None)
        return {"ok": True, "sources": len(self.external_demand)}

    # -- task-event aggregation (TaskEventBuffer -> GcsTaskManager equiv) -
    def handle_report_task_events(self, conn, p):
        self.task_events.extend(p["events"])
        for ev in p["events"]:
            tid = ev.get("trace_id")
            if tid:
                self._index_trace_event(tid, ev)
            if ev.get("kind") in _ts.EVENT_STATE:
                self._fold_task_event(ev)
        if len(self.task_events) > 4 * self.config.event_buffer_size:
            trimmed = len(self.task_events) // 2
            self.task_events_dropped += trimmed
            del self.task_events[:trimmed]
        return True

    def _fold_task_event(self, ev: dict):
        """Fold one lifecycle event into the bounded per-(task_id, attempt)
        index (reference: GcsTaskManager's per-task storage with its own
        bound + eviction counter, independent of the raw event buffer)."""
        task_id = ev.get("task_id")
        if not task_id:
            return
        key = (task_id, int(ev.get("attempt", 0)))
        record = self.task_index.get(key)
        if record is None:
            while len(self.task_index) >= max(16, self.config.task_index_size):
                self._evict_task_record()
            record = self.task_index[key] = {"task_id": task_id, "attempt": key[1]}
        _ts.fold(record, ev)

    def _evict_task_record(self):
        """Evict one index record: the oldest TERMINAL record within a
        bounded scan window, else the oldest outright — live tasks survive
        overflow as long as finished ones are available to shed."""
        victim = None
        for i, (key, record) in enumerate(self.task_index.items()):
            if record.get("state") in _ts.TERMINAL:
                victim = key
                break
            if i >= 64:  # bounded scan; an all-live prefix evicts the oldest
                break
        if victim is None:
            victim = next(iter(self.task_index))
        del self.task_index[victim]
        self.tasks_evicted += 1

    def _index_trace_event(self, trace_id: str, ev: dict):
        t = self.traces.get(trace_id)
        if t is None:
            while len(self.traces) >= self.MAX_TRACES:
                victim_id = next(iter(self.traces))  # evict oldest trace
                victim = self.traces.pop(victim_id)
                self.traces_evicted += 1
                # Name WHAT was lost, not just that something was: a later
                # "trace not found" can then distinguish evicted-but-maybe-
                # recoverable (collect_flight_trace re-assembles from live
                # recorder rings) from never-existed.
                self._event("trace_evicted", trace_id=victim_id,
                            name=victim["name"], spans=victim["spans"])
            t = self.traces[trace_id] = {
                "name": "", "start": ev["ts"], "end": ev["ts"],
                "spans": 0, "workers": set(), "events": [], "dropped": 0,
            }
        end = ev["ts"] + ev.get("dur", 0.0)
        t["start"] = min(t["start"], ev["ts"])
        t["end"] = max(t["end"], end)
        kind = ev.get("kind", "")
        if kind == "span":
            t["spans"] += 1
            if not ev.get("parent_id"):
                t["name"] = ev.get("name", "")  # root span names the trace
        elif kind == "task_exec_start":
            t["spans"] += 1
            if not t["name"]:
                t["name"] = ev.get("fn", "")
        t["workers"].add(ev.get("worker", "?"))
        if len(t["events"]) < self.MAX_TRACE_EVENTS:
            t["events"].append(ev)
        else:
            t["dropped"] += 1

    def handle_get_task_events(self, conn, p):
        limit = int(p.get("limit", 20000))
        if "since" not in p:
            return self.task_events[-limit:] if limit > 0 else []
        # Cursor mode for pollers (dashboard, CLI --follow): `since` is an
        # ABSOLUTE event sequence number (monotone across buffer trims —
        # task_events_dropped counts exactly the events trimmed off the
        # front), so each poll copies only what's new instead of the whole
        # 20k-event tail. The reply's `next` feeds the next poll; `missed`
        # counts events trimmed away before the poller got to them.
        base = self.task_events_dropped
        since = int(p["since"])
        # Clamp into the live window BOTH ways: a cursor from before a trim
        # skips forward (missed counts the loss); a cursor from a previous
        # controller incarnation (restart reset base+buffer) lands past the
        # end — rewind to the current end and return a smaller `next`, so
        # the poller self-heals instead of freezing on an empty reply
        # forever.
        start = max(0, min(since - base, len(self.task_events)))
        events = self.task_events[start : start + limit] if limit > 0 else []
        return {
            "events": events,
            "next": base + start + len(events),
            "missed": max(0, base - since),
            "truncated": start + len(events) < len(self.task_events),
        }

    def handle_get_trace(self, conn, p):
        """Every indexed event of one trace, time-ordered."""
        t = self.traces.get(p["trace_id"])
        if t is None:
            return []
        return sorted(t["events"], key=lambda e: e["ts"])

    def handle_list_traces(self, conn, p):
        """Recent traces, newest first; q filters by id prefix or root-span
        name substring (the dashboard's /api/traces)."""
        limit = int(p.get("limit", 100))
        q = p.get("q") or ""
        out = []
        for trace_id in reversed(list(self.traces)):
            t = self.traces[trace_id]
            if q and not (trace_id.startswith(q) or q in t["name"]):
                continue
            out.append({
                "trace_id": trace_id,
                "name": t["name"],
                "start": t["start"],
                "dur": t["end"] - t["start"],
                "spans": t["spans"],
                "workers": len(t["workers"]),
                "events": len(t["events"]),
                "events_dropped": t["dropped"],
            })
            if len(out) >= limit:
                break
        return out

    # -- state API (ray list/summary/memory equivalent) ------------------
    # Server-side filtering + explicit truncation markers on every list
    # endpoint (reference: python/ray/util/state — the StateApiClient always
    # reports total vs returned so "I saw everything" is never assumed).

    @staticmethod
    def _truncate(matched: list, limit: int) -> dict:
        return {
            "total": len(matched),
            "truncated": max(0, len(matched) - limit),
            "items": matched[:limit],
        }

    def handle_list_tasks(self, conn, p):
        state = p.get("state")
        node = p.get("node")
        fn = p.get("fn")
        job = p.get("job")
        task_id = p.get("task_id")
        limit = int(p.get("limit", 100))
        matched = []
        # Newest first: dict preserves insertion order; reversed => recent.
        for record in reversed(list(self.task_index.values())):
            if state and record.get("state") != state:
                continue
            if node and not (record.get("node_id") or "").startswith(node):
                continue
            if fn and fn not in (record.get("fn") or ""):
                continue
            if job and not (record.get("job_id") or "").startswith(job):
                continue
            if task_id and not record["task_id"].startswith(task_id):
                continue
            matched.append(record)
        out = self._truncate(matched, limit)
        out["tasks"] = out.pop("items")
        out["evicted"] = self.tasks_evicted
        return out

    def handle_summary_tasks(self, conn, p):
        """Per-function rollup of the task index (reference: `ray summary
        tasks` — GcsTaskManager's TaskSummaries by func_or_class_name)."""
        job = p.get("job")
        by_fn: dict[str, dict] = {}
        for record in self.task_index.values():
            if job and not (record.get("job_id") or "").startswith(job):
                continue
            fn = record.get("fn") or "?"
            ent = by_fn.setdefault(fn, {"total": 0, "states": {}})
            ent["total"] += 1
            st = record.get("state") or "?"
            ent["states"][st] = ent["states"].get(st, 0) + 1
        return {
            "summary": by_fn,
            "total_tasks": len(self.task_index),
            "evicted": self.tasks_evicted,
        }

    def handle_get_task(self, conn, p):
        """Every indexed attempt of one task id (prefix match), oldest first."""
        tid = p["task_id"]
        return sorted(
            (r for (t, _a), r in self.task_index.items() if t.startswith(tid)),
            key=lambda r: (r["task_id"], r["attempt"]),
        )

    def handle_list_actors(self, conn, p):
        state = p.get("state")
        node = p.get("node")
        name = p.get("name")
        job = p.get("job")
        limit = int(p.get("limit", 100))
        matched = []
        for a in reversed(list(self.actors.values())):
            if state and a.state != state:
                continue
            if node and not a.node_id.startswith(node):
                continue
            if name and name not in a.spec.name and name not in a.spec.cls_id:
                continue
            if job and not a.spec.job_id.hex().startswith(job):
                continue
            matched.append({
                "actor_id": a.actor_id.hex(),
                "state": a.state,
                "name": a.spec.name,
                "class": a.spec.cls_id,
                "node_id": a.node_id,
                "worker_id": a.worker_id,
                "worker_addr": a.worker_addr,
                "job_id": a.spec.job_id.hex(),
                "restarts": a.restarts_used,
                "death_cause": a.death_cause,
            })
        out = self._truncate(matched, limit)
        out["actors"] = out.pop("items")
        return out

    def handle_list_objects(self, conn, p):
        node = p.get("node")
        limit = int(p.get("limit", 100))
        matched = []
        for oid, node_ids in self.object_dir.items():
            if node and not any(n.startswith(node) for n in node_ids):
                continue
            matched.append({
                "oid": oid.hex() if hasattr(oid, "hex") else str(oid),
                "size": self.object_sizes.get(oid, 0),
                "locations": sorted(node_ids),
            })
        matched.sort(key=lambda o: -o["size"])
        out = self._truncate(matched, limit)
        out["objects"] = out.pop("items")
        out["total_bytes"] = sum(self.object_sizes.values())
        return out

    def handle_list_nodes(self, conn, p):
        state = p.get("state")
        now = time.monotonic()
        matched = [
            {
                "node_id": nid,
                "state": n.state,
                "draining": n.draining,
                "address": n.address,
                "resources_total": n.resources_total,
                "resources_available": n.resources_available,
                "labels": n.labels,
                "store": n.store_stats,
                "workers": len(n.workers),
                "heartbeat_age_s": round(now - n.last_heartbeat, 3) if n.last_heartbeat else None,
            }
            for nid, n in self.nodes.items()
            if not state or n.state == state
        ]
        out = self._truncate(matched, int(p.get("limit", 1000)))
        out["nodes"] = out.pop("items")
        return out

    def handle_list_workers(self, conn, p):
        state = p.get("state")
        node = p.get("node")
        limit = int(p.get("limit", 1000))
        matched = []
        for nid, n in self.nodes.items():
            if n.state != "ALIVE" or (node and not nid.startswith(node)):
                continue
            for w in n.workers:
                if state and w.get("state") != state:
                    continue
                matched.append({"node_id": nid, **w})
        out = self._truncate(matched, limit)
        out["workers"] = out.pop("items")
        return out

    async def handle_memory_summary(self, conn, p):
        """Cluster-wide `ray memory` equivalent: fan out to every live
        daemon (which fans out to ITS workers) and return the per-worker
        ownership/reference tables plus per-node store occupancy."""
        limit = int(p.get("limit", 200))

        async def one(node: NodeRecord):
            try:
                return await asyncio.wait_for(
                    node.conn.call("memory_summary", {"limit": limit}), timeout=15
                )
            except Exception as e:
                return {"node_id": node.node_id, "error": f"{type(e).__name__}: {e}"}

        live = [
            n for n in self.nodes.values()
            if n.state == "ALIVE" and n.conn is not None and not n.conn.closed
        ]
        return {"nodes": list(await asyncio.gather(*(one(n) for n in live)))}

    # -- elastic train plane (live resize epoch fence) -------------------
    def handle_elastic_resize_epoch(self, conn, p):
        """Fence + bump one experiment's live-resize epoch. ``expect``
        (optional) must match the current epoch or the bump is refused —
        the caller is a stale controller incarnation and must fall back
        rather than race the transfer that advanced the epoch."""
        exp = p.get("experiment") or ""
        if not exp:
            return {"ok": False, "error": "experiment required"}
        cur = self.elastic_epochs.get(exp, 0)
        expect = p.get("expect")
        if expect is not None and int(expect) != cur:
            return {"ok": False, "epoch": cur, "error": "stale epoch"}
        # Insertion-order refresh + LRU cap: active experiments stay, long-
        # dead ones age out (counted, never silent).
        self.elastic_epochs.pop(exp, None)
        self.elastic_epochs[exp] = cur + 1
        while len(self.elastic_epochs) > 512:
            self.elastic_epochs.pop(next(iter(self.elastic_epochs)))
            self.elastic_epochs_evicted += 1
        self._event("elastic_resize", experiment=exp, epoch=cur + 1)
        return {"ok": True, "epoch": cur + 1}

    # -- checkpoint registry & weight publication (ckpt plane) -----------
    def handle_ckpt_register(self, conn, p):
        """Record one save attempt's outcome. Committed summaries carrying a
        channel move that channel's latest pointer and fan out over pubsub
        (``ckpt:<channel>``) — the weight-publication trigger."""
        s = dict(p["summary"])
        self.ckpt_registry[s["ckpt_id"]] = s
        while len(self.ckpt_registry) > self.MAX_CKPT_REGISTRY:
            self.ckpt_registry.pop(next(iter(self.ckpt_registry)))
            self.ckpt_evicted += 1
        self._event("checkpoint_" + s.get("status", "committed"),
                    ckpt_id=s["ckpt_id"], step=s.get("step"),
                    channel=s.get("channel", ""))
        channel = s.get("channel")
        if channel and s.get("status") == "committed":
            self.ckpt_channels[channel] = s
            self.publish("ckpt:" + channel, s["ckpt_id"], s)
        return True

    def handle_ckpt_list(self, conn, p):
        """Registry rows, newest first, PR-4 list conventions (server-side
        filters + explicit truncation markers)."""
        channel = p.get("channel")
        status = p.get("status")
        matched = [
            s for s in reversed(list(self.ckpt_registry.values()))
            if (not channel or s.get("channel") == channel)
            and (not status or s.get("status") == status)
        ]
        out = self._truncate(matched, int(p.get("limit", 100)))
        out["checkpoints"] = out.pop("items")
        out["evicted"] = self.ckpt_evicted
        out["channels"] = {c: s["ckpt_id"] for c, s in self.ckpt_channels.items()}
        return out

    def handle_ckpt_latest(self, conn, p):
        return self.ckpt_channels.get(p["channel"])

    # -- observability plane (SLO API / flight dumps / autopsy) ----------
    def handle_slo_register(self, conn, p):
        try:
            spec = self.slo_engine.register(p["spec"])
        except (TypeError, ValueError) as e:
            return {"ok": False, "error": str(e)}
        self._event("slo_registered", objective=spec["name"])
        return {"ok": True, "objective": spec}

    def handle_slo_unregister(self, conn, p):
        ok = self.slo_engine.unregister(p["name"])
        if ok:
            self._event("slo_unregistered", objective=p["name"])
        return ok

    def handle_slo_status(self, conn, p):
        return self.slo_engine.status()

    def handle_slo_summary(self, conn, p):
        return self.slo_engine.summary()

    def handle_slo_history(self, conn, p):
        return self.slo_engine.history()

    def handle_report_flight_dump(self, conn, p):
        """A worker/daemon just wrote (or harvested) a black-box flight dump;
        index the path so `raytpu debug` and /api/events can point at it."""
        rec = {"ts": _tracing.now(), "proc": p.get("proc", ""),
               "path": p.get("path", ""), "trigger": p.get("trigger", ""),
               "node_id": p.get("node_id", ""), "reason": p.get("reason", "")}
        self.flight_dumps.append(rec)
        if len(self.flight_dumps) > self.MAX_FLIGHT_DUMPS:
            trimmed = len(self.flight_dumps) - self.MAX_FLIGHT_DUMPS
            self.flight_dumps_dropped += trimmed
            del self.flight_dumps[:trimmed]
        self._event("flight_dump", proc=rec["proc"], trigger=rec["trigger"],
                    path=rec["path"])
        return True

    def handle_list_flight_dumps(self, conn, p):
        out = self._truncate(list(reversed(self.flight_dumps)), int(p.get("limit", 50)))
        out["dumps"] = out.pop("items")
        out["dropped"] = self.flight_dumps_dropped
        return out

    async def handle_profile_collect(self, conn, p):
        """Cluster profile collection (/api/profile, `raytpu profile`, the
        incident capture): fan out to every live daemon — each fans out to
        ITS workers, memory_summary-style — add the head process's own leg,
        and merge the per-proc folds into one cluster flamegraph (bounded,
        counted evictions; merge_folds dedups by proc id, which is what
        keeps in-process heads from double counting). ``status`` mode
        aggregates sampler status rows instead of merging folds; ``node_id``
        restricts the fan-out to one node."""
        req = {k: p[k] for k in ("status", "trace_id", "seconds", "window_s")
               if k in p}
        seconds = float(p.get("seconds") or 0.0)
        node_filter = p.get("node_id") or ""

        async def one(node: NodeRecord):
            try:
                return await asyncio.wait_for(
                    node.conn.call("profile_fold", req),
                    timeout=seconds + 15.0)
            except Exception as e:
                return {"folds": [], "errors": [
                    f"{node.node_id[:8]}: {type(e).__name__}: {e}"]}

        live = [
            n for n in self.nodes.values()
            if n.state == "ALIVE" and n.conn is not None and not n.conn.closed
            and (not node_filter or n.node_id.startswith(node_filter))
        ]
        own_future = None
        if not node_filter:
            # The head's own leg runs concurrently with the fan-out (a
            # `seconds` capture is a real wall-clock window on every proc).
            loop = asyncio.get_running_loop()
            own_future = loop.run_in_executor(
                None, lambda: _profiler.local_fold(req))
        replies = await asyncio.gather(*(one(n) for n in live))
        folds: list = []
        errors: list[str] = []
        for r in replies:
            folds.extend(r.get("folds") or [])
            errors.extend(r.get("errors") or [])
        if own_future is not None:
            folds.append(await own_future)
        if p.get("status"):
            rows = [r for r in folds if isinstance(r, dict)]
            return {"statuses": rows,
                    "aggregate": _profiler.aggregate_status(rows),
                    "errors": errors}
        merged = _profiler.merge_folds(
            folds, max_stacks=int(p.get("max_stacks") or
                                  _profiler.DEFAULT_MAX_STACKS))
        for k in ("window_s", "seconds", "trace_id"):
            if k in p:
                merged[k] = p[k]
        merged["errors"] = errors
        return merged

    def handle_profile_incidents(self, conn, p):
        """Alert-triggered capture registry: merged cluster flamegraphs
        snapshotted on SLO burn alerts (newest first, bounded, counted)."""
        out = self._truncate(list(reversed(self.incident_profiles)),
                             int(p.get("limit", 10)))
        out["incidents"] = out.pop("items")
        out["dropped"] = self.incident_profiles_dropped
        out["suppressed"] = self._profile_limiter.suppressed
        return out

    async def handle_collect_flight_trace(self, conn, p):
        """Reassemble ONE trace from every live per-process flight recorder
        (daemons fan out to their workers) merged with whatever the bounded
        trace index still holds — this is what makes `raytpu trace export`
        work even after the index evicted the trace."""
        trace_id = p["trace_id"]

        async def one(node: NodeRecord):
            try:
                return await asyncio.wait_for(
                    node.conn.call("flight_trace", {"trace_id": trace_id}),
                    timeout=10)
            except Exception as e:
                return {"events": [], "sources": 0,
                        "error": f"{node.node_id[:8]}: {type(e).__name__}: {e}"}

        live = [
            n for n in self.nodes.values()
            if n.state == "ALIVE" and n.conn is not None and not n.conn.closed
        ]
        events: list[dict] = []
        sources, errors = 0, []
        for r in await asyncio.gather(*(one(n) for n in live)):
            events = _merge_trace_events(events, r.get("events") or [])
            sources += int(r.get("sources", 0))
            if r.get("error"):
                errors.append(r["error"])
        own = _flight.recorder().events_for_trace(trace_id)
        if own:  # head-process ring (controller events + driver spans)
            events = _merge_trace_events(events, own)
            sources += 1
        t = self.traces.get(trace_id)
        if t is not None:
            events = _merge_trace_events(events, t["events"])
        # Distinguish "evicted but recoverable" from "never existed": the
        # trace_evicted events (satellite of this plane) carry the ids.
        evicted = t is None and any(
            ev.get("kind") == "trace_evicted" and ev.get("trace_id") == trace_id
            for ev in self.events)
        return {"events": events, "sources": sources, "indexed": t is not None,
                "evicted": evicted, "errors": errors}

    def handle_trace_autopsy(self, conn, p):
        """Critical-path hop decomposition of one indexed trace: where did
        the wall clock go (proxy queue / admission / wire / exec / drain)."""
        t = self.traces.get(p["trace_id"])
        if t is None:
            return {"error": "trace not found (evicted or never indexed — "
                             "try collect_flight_trace)"}
        return _autopsy.autopsy(t["events"])

    def handle_autopsy_summary(self, conn, p):
        """Per-deployment "where does p99 go": autopsy every indexed serve
        trace (bounded scan, newest first) and aggregate the hop shares."""
        limit = int(p.get("limit", 200))
        auts = []
        for trace_id in reversed(list(self.traces)):
            if len(auts) >= limit:
                break
            t = self.traces[trace_id]
            if t["name"] != "serve.request":
                continue
            a = _autopsy.autopsy(t["events"])
            if not a.get("error"):
                auts.append(a)
        return _autopsy.aggregate(auts)

    # -- metrics aggregation (ray.util.metrics equivalent pipeline) ------
    def handle_report_metrics(self, conn, p):
        self.metrics_by_reporter[p["reporter"]] = (time.monotonic(), p["series"])
        return True

    def handle_get_metrics(self, conn, p):
        """Merged view across LIVE reporters (entries older than 3 report
        intervals are dropped — dead workers must not contribute stale gauges
        or leak controller memory). Counters/histograms sum; GAUGES stay one
        series per reporter (a `reporter` tag is added) — summing a
        point-in-time value like a memory fraction across processes reports
        cluster-wide nonsense; per-reporter series let the scraper choose
        max/avg. Histograms merge only when bucket boundaries match
        (mismatched boundaries keep separate series instead of corrupting
        counts)."""
        now = time.monotonic()
        horizon = 3 * self.config.metrics_report_interval_s + 5.0
        reporters = self.metrics_by_reporter
        for rid in [r for r, (ts, _) in reporters.items() if now - ts > horizon]:
            del reporters[rid]
        merged: dict[tuple, dict] = {}
        for rid, (_ts, series) in reporters.items():
            for rec in series:
                if rec["kind"] == "gauge":
                    tags = {**rec["tags"], "reporter": rid[:12]}
                    key = (rec["name"], tuple(sorted(tags.items())), ())
                    cur = merged.get(key)
                    # Last write per reporter wins (reporters replace their
                    # whole series each tick, so one entry per key anyway).
                    if cur is None or rec.get("ts", 0) >= cur.get("ts", 0):
                        merged[key] = {**rec, "tags": tags}
                    continue
                key = (rec["name"], tuple(sorted(rec["tags"].items())), tuple(rec.get("buckets") or ()))
                cur = merged.get(key)
                if cur is None:
                    merged[key] = dict(rec)
                elif rec["kind"] == "histogram" and cur.get("counts") and rec.get("counts"):
                    cur["counts"] = [a + b for a, b in zip(cur["counts"], rec["counts"])]
                    cur["sum"] += rec["sum"]
                    cur["n"] += rec["n"]
                else:
                    cur["value"] += rec["value"]
        return list(merged.values()) + self._controller_series()

    def _controller_series(self) -> list[dict]:
        """The controller's own runtime metrics, merged into every get_metrics
        reply (the controller is not a reporter — it IS the aggregator)."""
        ts = time.time()

        def rec(name, kind, value, tags, desc=""):
            return {"name": name, "kind": kind, "description": desc,
                    "tags": {**tags, "reporter": "controller"},
                    "value": float(value), "ts": ts}

        out = [
            rec("scheduler.pending", "gauge", len(self.pending_leases),
                {"what": "leases"}, "lease requests waiting for capacity"),
            rec("scheduler.pending", "gauge", len(self.pending_actors),
                {"what": "actors"}, "actors parked until placeable"),
            rec("state.task_index.size", "gauge", len(self.task_index),
                {}, "per-task state index records currently held"),
        ]
        if self.tasks_evicted:
            out.append(rec("state.task_index.evicted_total", "counter",
                           self.tasks_evicted, {},
                           "task state records dropped by the index bound"))
        if self.ckpt_evicted:
            out.append(rec("state.ckpt_registry.evicted_total", "counter",
                           self.ckpt_evicted, {},
                           "checkpoint registry rows dropped by the bound"))
        if self.events_dropped:
            out.append(rec("events_dropped_total", "counter", self.events_dropped,
                           {"where": "controller"}, "control events lost to log trims"))
        if self.task_events_dropped:
            out.append(rec("events_dropped_total", "counter", self.task_events_dropped,
                           {"where": "controller_task_buffer"},
                           "aggregated task events lost to buffer trims"))
        if self.flight_dumps_dropped:
            out.append(rec("state.flight_dumps.dropped_total", "counter",
                           self.flight_dumps_dropped, {},
                           "flight dump records lost to the registry bound"))
        # SLO plane: burn-rate + state gauges per objective, scraped from the
        # same endpoint as everything else (no second metrics pipeline).
        for g in self.slo_engine.gauges(ts):
            g["tags"] = {**g["tags"], "reporter": "controller"}
            out.append(g)
        return out

    async def _health_check_loop(self):
        # Reference: GcsHealthCheckManager gRPC-probes raylets; here liveness
        # is daemon->controller heartbeats plus TCP connection state.
        while True:
            await asyncio.sleep(self.config.heartbeat_interval_s)
            now = time.monotonic()
            for nid, node in list(self.nodes.items()):
                if node.state == "ALIVE" and now - node.last_heartbeat > self.config.heartbeat_timeout_s:
                    await self._on_node_dead(nid, "heartbeat timeout")
            # Post-restore grace expired: restored-ALIVE actors whose node
            # never re-registered get the worker-died treatment (restart FSM
            # decides restart vs DEAD from max_restarts).
            if self._reconcile_deadline is not None and now >= self._reconcile_deadline:
                self._reconcile_deadline = None
                for actor_id in list(self._unconfirmed_actors):
                    record = self.actors.get(actor_id)
                    self._unconfirmed_actors.discard(actor_id)
                    if record is not None and record.state in (ALIVE, RESTARTING):
                        record.node_id = ""  # placement is stale; don't credit resources back
                        await self._on_actor_worker_died(record, "not re-confirmed after controller restart")

    async def _on_node_dead(self, node_id: str, reason: str):
        node = self.nodes.get(node_id)
        if node is None or node.state == "DEAD":
            return
        node.state = "DEAD"
        node.resources_available = {}
        self._event("node_dead", node_id=node_id, reason=reason)
        logger.warning("node %s dead: %s", node_id[:8], reason)
        self.publish("node", node_id, {"state": "DEAD", "reason": reason})
        # Objects on that node are gone from the directory.
        for oid, nodes in list(self.object_dir.items()):
            nodes.discard(node_id)
            if not nodes:
                del self.object_dir[oid]
        # Fail/restart actors that lived there.
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (ALIVE, PENDING, RESTARTING):
                await self._on_actor_worker_died(actor, f"node died: {reason}")
        # Leases on the node are void.
        for lease_id, (nid, demand, _strategy, _owner) in list(self.leases.items()):
            if nid == node_id:
                del self.leases[lease_id]
        # PG bundles on that node: mark pg for reschedule (round 1: mark DEAD).
        for pg in self.pgs.values():
            if pg.state == "CREATED" and any(b.node_id == node_id for b in pg.bundles):
                pg.state = "RESCHEDULING"
                self._spawn_bg(self._schedule_pg(pg), name="reschedule-pg")

    async def _on_driver_exit(self, job_id):
        if job_id is None:
            return
        self.jobs.get(job_id, {}).update(state="DEAD")
        self._event("job_finished", job_id=job_id)
        # Kill non-detached actors belonging to the job.
        for actor in list(self.actors.values()):
            if actor.spec.job_id.hex() == job_id and actor.spec.options.lifetime != "detached" and actor.state != DEAD:
                await self._kill_actor(actor, "driver exited", no_restart=True)
        for pg in list(self.pgs.values()):
            if pg.job_id is not None and pg.job_id.hex() == job_id:
                await self._remove_pg(pg)

    # -- job management -------------------------------------------------
    def handle_register_job(self, conn, p):
        existing = p.get("job_id")
        if existing is not None and JobID(existing).hex() in self.jobs:
            # Driver reconnecting after a controller restart: keep its job.
            job_id = JobID(existing)
            conn.meta.update(role="driver", job_id=job_id.hex())
            self.jobs[job_id.hex()]["state"] = "RUNNING"
            return {"job_id": job_id.binary(), "config": self.config.to_dict(), "nodes": self._node_table()}
        self._job_counter += 1
        job_id = JobID.from_int(self._job_counter)
        conn.meta.update(role="driver", job_id=job_id.hex())
        self.jobs[job_id.hex()] = {"state": "RUNNING", "driver_addr": p.get("driver_addr", ""), "start_ts": time.time()}
        self._event("job_started", job_id=job_id.hex())
        return {"job_id": job_id.binary(), "config": self.config.to_dict(), "nodes": self._node_table()}

    # -- KV -------------------------------------------------------------
    def handle_kv_put(self, conn, p):
        ns = self.kv.setdefault(p.get("ns", ""), {})
        exists = p["key"] in ns
        if not exists or p.get("overwrite", True):
            ns[p["key"]] = p["value"]
            self._dirty = True
        return not exists

    def handle_kv_get(self, conn, p):
        return self.kv.get(p.get("ns", ""), {}).get(p["key"])

    def handle_kv_del(self, conn, p):
        removed = self.kv.get(p.get("ns", ""), {}).pop(p["key"], None) is not None
        self._dirty = self._dirty or removed
        return removed

    def handle_kv_keys(self, conn, p):
        prefix = p.get("prefix", "")
        return [k for k in self.kv.get(p.get("ns", ""), {}) if k.startswith(prefix)]

    # -- scheduling core ------------------------------------------------
    def _feasible_nodes(self, demand: dict, label_selector: dict,
                        include_draining: bool = False) -> list[NodeRecord]:
        # include_draining: infeasibility checks count draining capacity —
        # demand a draining node COULD serve must pend (drain may be
        # cancelled), not hard-fail as never-satisfiable.
        return [
            n
            for n in self.nodes.values()
            if n.state == "ALIVE"
            and (include_draining or not n.draining)
            and _labels_match(n.labels, label_selector)
            and all(n.resources_total.get(k, 0) + 1e-9 >= v for k, v in demand.items())
        ]

    def _pick_node(self, demand: dict, strategy, label_selector: dict) -> Optional[NodeRecord]:
        """Scheduling policies (reference: raylet/scheduling/policy/*):
        DEFAULT = hybrid pack-below-threshold-then-spread
        (hybrid_scheduling_policy.h:50), SPREAD = round-robin least-loaded
        (spread_scheduling_policy), NODE_AFFINITY, PLACEMENT_GROUP bundle."""
        kind = getattr(strategy, "kind", "DEFAULT")
        if kind == "PLACEMENT_GROUP":
            pg = self.pgs.get(strategy.placement_group)
            if pg is None or pg.state != "CREATED":
                return None
            idxs = [strategy.bundle_index] if strategy.bundle_index >= 0 else range(len(pg.bundles))
            for i in idxs:
                b = pg.bundles[i]
                node = self.nodes.get(b.node_id)
                if node and node.state == "ALIVE" and _fits(b.available, demand):
                    return node
            return None
        if kind == "NODE_AFFINITY":
            node = self.nodes.get(strategy.node_id)
            if node and node.state == "ALIVE" and not node.draining and _fits(node.resources_available, demand):
                return node
            if getattr(strategy, "soft", False):
                pass  # fall through to default policy
            else:
                return None
        feasible = [n for n in self._feasible_nodes(demand, label_selector) if _fits(n.resources_available, demand)]
        if not feasible:
            return None
        feasible.sort(key=lambda n: n.node_id)

        def utilization(n: NodeRecord) -> float:
            fracs = [
                1 - n.resources_available.get(k, 0) / t for k, t in n.resources_total.items() if t > 0
            ]
            return max(fracs) if fracs else 0.0

        if kind == "SPREAD":
            self._rr_counter += 1
            feasible.sort(key=utilization)
            return feasible[(self._rr_counter) % max(1, len([n for n in feasible if utilization(n) == utilization(feasible[0])]))]
        below = [n for n in feasible if utilization(n) < self.config.scheduler_spread_threshold]
        if below:
            return max(below, key=utilization)  # pack: most-utilized below threshold
        return min(feasible, key=utilization)  # spread: least utilized

    def _consume(self, node: NodeRecord, demand: dict, strategy=None):
        # PG-bound demand consumes its BUNDLE only: the bundle's reservation
        # was already subtracted from the node when the PG was committed
        # (reference: PG actors use the group's reservation, they don't stack
        # on top of it). Subtracting from the node again here would corrupt
        # the cluster availability view (double-count).
        if strategy is not None and getattr(strategy, "kind", "") == "PLACEMENT_GROUP":
            pg = self.pgs.get(strategy.placement_group)
            if pg:
                idxs = [strategy.bundle_index] if strategy.bundle_index >= 0 else range(len(pg.bundles))
                for i in idxs:
                    b = pg.bundles[i]
                    if b.node_id == node.node_id and _fits(b.available, demand):
                        _sub(b.available, demand)
                        break
            return
        _sub(node.resources_available, demand)

    def _restore(self, node_id: str, demand: dict, strategy=None):
        if strategy is not None and getattr(strategy, "kind", "") == "PLACEMENT_GROUP":
            pg = self.pgs.get(strategy.placement_group)
            if pg:
                idxs = [strategy.bundle_index] if strategy.bundle_index >= 0 else range(len(pg.bundles))
                for i in idxs:
                    b = pg.bundles[i]
                    if b.node_id == node_id:
                        _add(b.available, demand)
                        break
            return
        node = self.nodes.get(node_id)
        if node and node.state == "ALIVE":
            _add(node.resources_available, demand)

    async def handle_request_lease(self, conn, p):
        """Grant a worker lease: returns node address once resources free up.

        Reference flow: NormalTaskSubmitter::RequestNewWorkerIfNeeded ->
        raylet HandleRequestWorkerLease -> ClusterLeaseManager queue
        (node_manager.cc:1786); here the queue lives in the controller.
        """
        strategy = p["strategy"]
        demand = p["demand"]
        fault = _chaos.maybe_inject("controller.lease.grant", lease=p.get("lease_id", ""))
        if fault is not None:
            if fault.kind == "delay":
                await asyncio.sleep(fault.delay_s)  # lease-grant latency
            elif fault.kind == "error":
                raise fault.error("lease grant")  # submitter retries the lease
        node = self._pick_node(demand, strategy, p.get("label_selector", {}))
        if node is not None:
            self._consume(node, demand, strategy)
            self.leases[p["lease_id"]] = (node.node_id, demand, strategy, conn)
            return {"node_id": node.node_id, "address": node.address, "store_path": node.store_path, "strategy": strategy}
        if (
            not self.config.infeasible_as_pending
            and not self._feasible_nodes(demand, p.get("label_selector", {}), include_draining=True)
            and getattr(strategy, "kind", "") != "PLACEMENT_GROUP"
            # Post-restart reconcile grace (and cold start): daemons
            # re-register over the next seconds, so an empty/partial node
            # table is not evidence of infeasibility — fast-failing here
            # turned every lease that raced a controller restart into a
            # permanent "infeasible resource demand" task failure (found by
            # the chaos controller_restart scenario). Park instead; the
            # register_node retry pass grants it.
            and self._reconcile_deadline is None
            and any(n.state == "ALIVE" for n in self.nodes.values())
        ):
            return {"infeasible": True}
        fut = asyncio.get_running_loop().create_future()
        pl = PendingLease(p["lease_id"], demand, strategy, p.get("label_selector", {}), fut)
        pl.conn = conn
        self.pending_leases.append(pl)
        try:
            return await fut
        except asyncio.CancelledError:
            if pl in self.pending_leases:
                self.pending_leases.remove(pl)
            raise

    def handle_release_lease(self, conn, p):
        entry = self.leases.pop(p["lease_id"], None)
        if entry:
            node_id, demand, strategy, _owner = entry
            self._restore(node_id, demand, p.get("strategy", strategy))
            self._spawn_bg(self._retry_pending(), name="retry-pending")
        return True

    def _release_leases_of(self, conn):
        """A submitter (driver or worker) disconnected: return its granted
        resources and drop its queued lease requests."""
        released = False
        for lease_id, (node_id, demand, strategy, owner) in list(self.leases.items()):
            if owner is conn:
                del self.leases[lease_id]
                self._restore(node_id, demand, strategy)
                released = True
        for pl in list(self.pending_leases):
            if getattr(pl, "conn", None) is conn:
                self.pending_leases.remove(pl)
        if released:
            self._spawn_bg(self._retry_pending(), name="retry-pending")

    async def _retry_pending(self):
        """Event-driven reconciliation of ALL pending work (leases, PGs,
        actors); called whenever capacity changes (lease release, node join,
        worker death, PG removal) rather than on a poll timer."""
        progress = True
        while progress:
            progress = False
            for pg in [g for g in self.pgs.values() if g.state == "PENDING"]:
                assignment = self._plan_bundles(pg)
                if assignment is not None:
                    self._commit_pg(pg, assignment)
                    progress = True
            for pl in list(self.pending_leases):
                node = self._pick_node(pl.demand, pl.strategy, pl.label_selector)
                if node is not None:
                    self.pending_leases.remove(pl)
                    self._consume(node, pl.demand, pl.strategy)
                    self.leases[pl.lease_id] = (node.node_id, pl.demand, pl.strategy, getattr(pl, "conn", None))
                    if not pl.future.done():
                        pl.future.set_result(
                            {"node_id": node.node_id, "address": node.address, "store_path": node.store_path, "strategy": pl.strategy}
                        )
                    progress = True
            for record in list(self.pending_actors):
                if record.state == DEAD:
                    self.pending_actors.remove(record)
                    continue
                spec = record.spec
                node = self._pick_node(spec.options.resource_demand(), spec.options.scheduling_strategy, spec.options.label_selector)
                if node is not None:
                    self.pending_actors.remove(record)
                    # Consume synchronously BEFORE yielding to the created
                    # task, or the same free capacity double-books across
                    # actors/leases examined later in this pass.
                    self._consume(node, spec.options.resource_demand(), spec.options.scheduling_strategy)
                    self._spawn_bg(self._start_actor_on(record, node), name="start-actor")
                    progress = True

    # -- actors ---------------------------------------------------------
    async def handle_register_actor(self, conn, p):
        spec = p["spec"]
        if spec.name:
            key = (spec.namespace, spec.name)
            if key in self.named_actors:
                existing = self.actors[self.named_actors[key]]
                if existing.state != DEAD:
                    if spec.options.get_if_exists:
                        return self._actor_info(existing)
                    raise ValueError(f"actor name {spec.name!r} already taken in namespace {spec.namespace!r}")
            self.named_actors[key] = spec.actor_id
        record = ActorRecord(actor_id=spec.actor_id, spec=spec)
        self.actors[spec.actor_id] = record
        self._event("actor_registered", actor_id=spec.actor_id.hex(), name=spec.name)
        # Creation is asynchronous: the handle is usable immediately and the
        # first method call blocks on wait_actor_alive (reference:
        # GcsActorManager registration is async from the caller's view).
        self._spawn_bg(self._schedule_actor(record), name="schedule-actor")
        return self._actor_info(record)

    async def _actor_info_when_alive(self, record: ActorRecord):
        if record.state == ALIVE:
            return self._actor_info(record)
        if record.state == DEAD:
            return self._actor_info(record)
        fut = asyncio.get_running_loop().create_future()
        record.pending_waiters.append(fut)
        return await fut

    def _actor_info(self, record: ActorRecord):
        return {
            "actor_id": record.actor_id.binary(),
            "state": record.state,
            "worker_addr": record.worker_addr,
            "node_id": record.node_id,
            "death_cause": record.death_cause,
        }

    def _wake_actor_waiters(self, record: ActorRecord):
        info = self._actor_info(record)
        for fut in record.pending_waiters:
            if not fut.done():
                fut.set_result(info)
        record.pending_waiters.clear()
        self.publish("actor", record.actor_id.hex(), info)

    async def _schedule_actor(self, record: ActorRecord):
        """Place the actor now if possible, else park it PENDING indefinitely —
        a node may join later (reference: GcsActorManager keeps actors
        PENDING_CREATION without a deadline, gcs_actor_manager.h FSM). Waking
        is event-driven via _retry_pending, not a poll."""
        if record.state == DEAD:
            return  # killed while pending; don't resurrect
        spec = record.spec
        node = self._pick_node(spec.options.resource_demand(), spec.options.scheduling_strategy, spec.options.label_selector)
        if node is None:
            if record not in self.pending_actors:
                self.pending_actors.append(record)
            return
        self._consume(node, spec.options.resource_demand(), spec.options.scheduling_strategy)
        await self._start_actor_on(record, node)

    async def _start_actor_on(self, record: ActorRecord, node: NodeRecord):
        """Start a (already resource-consumed) actor on the chosen node."""
        spec = record.spec
        demand = spec.options.resource_demand()
        strategy = spec.options.scheduling_strategy
        record.node_id = node.node_id
        record.creation_attempts = getattr(record, "creation_attempts", 0) + 1
        try:
            reply = await node.conn.call("start_actor", {"spec": spec}, timeout=self.config.actor_creation_timeout_s)
            if record.state == DEAD:  # killed during creation
                self._restore(node.node_id, demand, strategy)
                try:
                    await node.conn.call("kill_worker", {"worker_id": reply["worker_id"], "reason": "actor killed"}, timeout=5)
                except Exception:
                    pass
                return
            record.worker_addr = reply["worker_addr"]
            record.worker_id = reply["worker_id"]
            record.state = ALIVE
            record.creation_attempts = 0  # only CONSECUTIVE failures are terminal
            self._event("actor_alive", actor_id=record.actor_id.hex(), node=node.node_id)
            self._wake_actor_waiters(record)
        except Exception as e:
            self._restore(node.node_id, demand, strategy)
            record.node_id = ""
            logger.warning("actor %s creation on %s failed: %s", record.actor_id.hex()[:8], node.node_id[:8], e)
            if record.creation_attempts >= 3:
                # Repeated *creation* failures (constructor raising, node
                # flapping) are terminal — different from unplaceable-pending.
                record.state = DEAD
                record.death_cause = f"actor creation failed {record.creation_attempts} times: {e}"
                self._wake_actor_waiters(record)
                return
            await asyncio.sleep(self.config.task_retry_delay_s)
            await self._schedule_actor(record)

    async def _on_actor_worker_died(self, record: ActorRecord, reason: str):
        # Any death/restart handling confirms the record is live-tracked again
        # — the post-restore grace check must not fire a second death on it.
        self._unconfirmed_actors.discard(record.actor_id)
        if record.state == DEAD:
            return
        self._restore(record.node_id, record.spec.options.resource_demand(), record.spec.options.scheduling_strategy)
        record.node_id = ""
        record.worker_addr = ""
        max_restarts = record.spec.options.max_restarts
        if max_restarts == -1 or record.restarts_used < max_restarts:
            record.restarts_used += 1
            record.state = RESTARTING
            self._event("actor_restarting", actor_id=record.actor_id.hex(), attempt=record.restarts_used)
            self.publish("actor", record.actor_id.hex(), self._actor_info(record))
            await self._schedule_actor(record)
        else:
            record.state = DEAD
            record.death_cause = reason
            self._event("actor_dead", actor_id=record.actor_id.hex(), reason=reason)
            self._wake_actor_waiters(record)
        await self._retry_pending()

    async def handle_worker_died(self, conn, p):
        """Daemon reports a worker process exit (reference: raylet notifies GCS,
        GcsActorManager::OnWorkerDead)."""
        for actor_id_bin in p.get("actor_ids", []):
            record = self.actors.get(ActorID(actor_id_bin))
            if record is not None:
                await self._on_actor_worker_died(record, p.get("reason", "worker died"))
        return True

    def handle_get_actor(self, conn, p):
        if "name" in p:
            aid = self.named_actors.get((p.get("namespace", "default"), p["name"]))
            if aid is None:
                return None
            record = self.actors.get(aid)
        else:
            record = self.actors.get(ActorID(p["actor_id"]))
        if record is None:
            return None
        info = self._actor_info(record)
        info["spec"] = record.spec if p.get("with_spec") else None
        return info

    async def handle_wait_actor_alive(self, conn, p):
        record = self.actors.get(ActorID(p["actor_id"]))
        if record is None:
            return None
        if record.state in (ALIVE, DEAD):
            return self._actor_info(record)
        fut = asyncio.get_running_loop().create_future()
        record.pending_waiters.append(fut)
        return await fut

    async def handle_kill_actor(self, conn, p):
        record = self.actors.get(ActorID(p["actor_id"]))
        if record is None:
            return False
        await self._kill_actor(record, "killed via controller", no_restart=p.get("no_restart", True))
        return True

    async def _kill_actor(self, record: ActorRecord, reason: str, no_restart: bool):
        self._unconfirmed_actors.discard(record.actor_id)
        if record.state == DEAD:
            return
        node = self.nodes.get(record.node_id)
        if no_restart:
            record.spec.options.max_restarts = 0
        if node and node.conn and not node.conn.closed:
            try:
                await node.conn.call("kill_worker", {"worker_id": record.worker_id, "reason": reason}, timeout=5)
            except Exception:
                pass
        if no_restart and record.state != DEAD:
            # Only restore if the actor was actually placed; a kill racing an
            # in-flight start_actor is handled by _schedule_actor's post-reply
            # DEAD check (which restores exactly once).
            if record.node_id and record.worker_addr:
                self._restore(record.node_id, record.spec.options.resource_demand(), record.spec.options.scheduling_strategy)
            record.state = DEAD
            record.death_cause = reason
            self._event("actor_dead", actor_id=record.actor_id.hex(), reason=reason)
            self._wake_actor_waiters(record)
            await self._retry_pending()

    def handle_list_named_actors(self, conn, p):
        ns = p.get("namespace")
        return [
            {"namespace": k[0], "name": k[1]}
            for k, aid in self.named_actors.items()
            if (ns is None or k[0] == ns) and self.actors[aid].state != DEAD
        ]

    # -- placement groups ----------------------------------------------
    async def handle_create_placement_group(self, conn, p):
        pg = PGRecord(
            pg_id=p["pg_id"],
            bundles=[BundleState(i, dict(b), available=dict(b)) for i, b in enumerate(p["bundles"])],
            strategy=p["strategy"],
            name=p.get("name", ""),
            job_id=p.get("job_id"),
            label_selector=p.get("label_selector") or {},
        )
        self.pgs[pg.pg_id] = pg
        await self._schedule_pg(pg)
        if pg.state == "CREATED":
            return {"state": pg.state, "bundle_nodes": [b.node_id for b in pg.bundles]}
        if p.get("wait", False):
            fut = asyncio.get_running_loop().create_future()
            pg.pending_waiters.append(fut)
            return await fut
        return {"state": pg.state}

    def _release_pg_holdings(self, pg: PGRecord) -> None:
        """Return every placed bundle's node-level reservation and mark the
        bundles unplaced. Bundles on DEAD nodes have nothing to return; a
        never-placed bundle (empty node_id) is a no-op. This is THE one
        ledger-release for PG bundles: reschedule-after-node-death re-plans
        from scratch (a commit would otherwise double-subtract the kept
        nodes), and removal must refund survivors no matter what state the
        PG died in (a RESCHEDULING/PENDING gang that still held two of its
        three bundles used to leak them forever — the preempted-gang
        restart then found its own CPUs permanently occupied)."""
        for b in pg.bundles:
            if b.node_id:
                node = self.nodes.get(b.node_id)
                if node and node.state == "ALIVE":
                    _add(node.resources_available, b.resources)
                b.node_id = ""
                b.available = {}

    async def _schedule_pg(self, pg: PGRecord):
        """Gang-reserve all bundles atomically on the central ledger
        (reference: GcsPlacementGroupScheduler 2PC across raylets,
        bundle_scheduling_policy.h:73-97 for PACK/SPREAD/STRICT_*). An
        unplaceable PG stays PENDING; _retry_pending commits it when capacity
        appears (event-driven, no poll loop)."""
        self._release_pg_holdings(pg)  # reschedule: free survivors first
        assignment = self._plan_bundles(pg)
        if assignment is None:
            pg.state = "PENDING"
            return
        self._commit_pg(pg, assignment)
        # Leases queued with PLACEMENT_GROUP strategy were unschedulable until
        # now — wake them.
        await self._retry_pending()

    def _commit_pg(self, pg: PGRecord, assignment: list):
        for b, node in zip(pg.bundles, assignment):
            _sub(node.resources_available, b.resources)
            b.node_id = node.node_id
            b.available = dict(b.resources)
        pg.state = "CREATED"
        self._event("pg_created", pg_id=pg.pg_id.hex())
        for fut in pg.pending_waiters:
            if not fut.done():
                fut.set_result({"state": "CREATED", "bundle_nodes": [b.node_id for b in pg.bundles]})
        pg.pending_waiters.clear()

    def _plan_bundles(self, pg: PGRecord) -> Optional[list]:
        nodes = [n for n in self.nodes.values() if n.state == "ALIVE" and not n.draining]
        if pg.label_selector:
            nodes = [n for n in nodes if _labels_match(n.labels, pg.label_selector)]
        nodes.sort(key=lambda n: n.node_id)
        avail = {n.node_id: dict(n.resources_available) for n in nodes}
        byid = {n.node_id: n for n in nodes}
        assignment: list = []
        strategy = pg.strategy
        if strategy == "STRICT_PACK":
            for n in nodes:
                a = dict(avail[n.node_id])
                if all(_fits_consume(a, b.resources) for b in pg.bundles):
                    return [n] * len(pg.bundles)
            return None
        used_nodes: list[str] = []
        for b in pg.bundles:
            candidates = [n for n in nodes if _fits(avail[n.node_id], b.resources)]
            if strategy == "STRICT_SPREAD":
                candidates = [n for n in candidates if n.node_id not in used_nodes]
            if not candidates:
                return None
            if strategy in ("SPREAD", "STRICT_SPREAD"):
                fresh = [n for n in candidates if n.node_id not in used_nodes]
                pick = (fresh or candidates)[0]
            else:  # PACK
                packed = [n for n in candidates if n.node_id in used_nodes]
                pick = (packed or candidates)[0]
            _sub(avail[pick.node_id], b.resources)
            used_nodes.append(pick.node_id)
            assignment.append(byid[pick.node_id])
        return assignment

    async def handle_wait_placement_group(self, conn, p):
        """Block until the PG is CREATED or REMOVED (event-driven client
        ready(); replaces client-side polling)."""
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return {"state": "REMOVED"}
        if pg.state == "CREATED":
            return {"state": "CREATED", "bundle_nodes": [b.node_id for b in pg.bundles]}
        fut = asyncio.get_running_loop().create_future()
        pg.pending_waiters.append(fut)
        timeout = p.get("timeout")
        if timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(asyncio.shield(fut), timeout)
        except asyncio.TimeoutError:
            if fut in pg.pending_waiters:
                pg.pending_waiters.remove(fut)
            return {"state": pg.state}

    async def handle_remove_placement_group(self, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return False
        await self._remove_pg(pg)
        return True

    async def _remove_pg(self, pg: PGRecord):
        self._release_pg_holdings(pg)
        pg.state = "REMOVED"
        self.pgs.pop(pg.pg_id, None)
        for fut in pg.pending_waiters:
            if not fut.done():
                fut.set_result({"state": "REMOVED"})
        pg.pending_waiters.clear()
        self._event("pg_removed", pg_id=pg.pg_id.hex())
        await self._retry_pending()

    def handle_get_placement_group(self, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return None
        return {
            "state": pg.state,
            "strategy": pg.strategy,
            "bundles": [{"index": b.index, "resources": b.resources, "node_id": b.node_id, "available": b.available} for b in pg.bundles],
        }

    # -- object directory ----------------------------------------------
    def handle_report_object(self, conn, p):
        oid = p["oid"]
        self.object_dir.setdefault(oid, set()).add(p["node_id"])
        self.object_sizes[oid] = p.get("size", 0)
        self.publish("object", oid.hex() if hasattr(oid, "hex") else str(oid), {"node_id": p["node_id"]})
        return True

    def handle_report_objects_evicted(self, conn, p):
        for oid in p["oids"]:
            nodes = self.object_dir.get(oid)
            if nodes:
                nodes.discard(p["node_id"])
                if not nodes:
                    self.object_dir.pop(oid, None)
                    self.object_sizes.pop(oid, None)
        return True

    def handle_lookup_object(self, conn, p):
        nodes = self.object_dir.get(p["oid"], set())
        return [
            {"node_id": nid, "address": self.nodes[nid].address, "store_path": self.nodes[nid].store_path}
            for nid in nodes
            if nid in self.nodes and self.nodes[nid].state == "ALIVE"
        ]

    async def handle_free_objects(self, conn, p):
        oids = p["oids"]
        by_node: dict[str, list] = {}
        for oid in oids:
            for nid in self.object_dir.pop(oid, set()):
                by_node.setdefault(nid, []).append(oid)
            self.object_sizes.pop(oid, None)
        for nid, node_oids in by_node.items():
            node = self.nodes.get(nid)
            if node and node.state == "ALIVE" and node.conn:
                try:
                    await node.conn.call("delete_objects", {"oids": node_oids}, timeout=5)
                except Exception:
                    pass
        return True


def _fits_consume(avail: dict, demand: dict) -> bool:
    if not _fits(avail, demand):
        return False
    _sub(avail, demand)
    return True
