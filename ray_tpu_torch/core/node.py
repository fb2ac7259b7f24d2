"""Per-node daemon: worker pool + local object store + object transfer.

Role-equivalent to the reference's raylet (src/ray/raylet:
NodeManager + WorkerPool + ObjectManager + plasma store thread). Differences
by design: scheduling decisions live in the controller (central ledger, see
controller.py); the daemon's job is mechanism — spawning/pooling worker
processes (reference: worker_pool.h:281), owning the node's shared-memory
arena, and moving object payloads between nodes in chunks (reference:
object_manager.h:128, PullManager/PushManager with 1MB chunking).
"""
from __future__ import annotations

import asyncio
import collections
import hmac
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch.core.object_store import SharedMemoryClient
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.bgtasks import spawn_bg as _spawn_bg_task

logger = logging.getLogger(__name__)


@dataclass
class WorkerRecord:
    worker_id: str
    proc: Optional[subprocess.Popen]
    conn: Any = None
    address: str = ""
    state: str = "STARTING"  # STARTING | IDLE | LEASED | ACTOR | DEAD
    actor_ids: list = field(default_factory=list)
    ready: asyncio.Future | None = None
    last_idle_ts: float = 0.0
    state_ts: float = 0.0  # last state transition (OOM victim ordering)
    restartable_actor: bool = False  # hosted actor has max_restarts != 0
    death_reported: bool = False
    env_hash: str = ""  # runtime-env hash this worker was built for


class NodeDaemon:
    def __init__(
        self,
        controller_addr: str,
        config: Config | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        store_capacity: int | None = None,
        host: str | None = None,
        session_dir: str | None = None,
        env: dict | None = None,
        autodetect_accelerators: bool = True,
    ):
        self.autodetect_accelerators = autodetect_accelerators
        self.node_id = NodeID.from_random().hex()
        self.controller_addr = controller_addr
        self.config = config or Config().apply_env()
        self.resources = resources if resources is not None else {"CPU": float(os.cpu_count() or 1)}
        self.labels = dict(labels or {})
        self.labels.setdefault("node_id", self.node_id)
        self.session_dir = session_dir or f"/tmp/raytpu_{os.getpid()}"
        os.makedirs(self.session_dir, exist_ok=True)
        self.store_path = os.path.join(
            "/dev/shm" if os.path.isdir("/dev/shm") else self.session_dir, f"raytpu_store_{self.node_id[:12]}"
        )
        self.store_capacity = store_capacity or self.config.object_store_memory
        self.store: SharedMemoryClient | None = None
        self.server = rpc.RpcServer(self, host=host or self.config.node_ip)
        self.controller: rpc.Connection | None = None
        self.workers: dict[str, WorkerRecord] = {}
        # Idle pool keyed by runtime-env hash ("" = plain): a lease only
        # reuses workers built for ITS environment (reference: worker_pool.h
        # idle cache keyed by runtime-env hash).
        self.idle_workers: dict[str, list[WorkerRecord]] = {}
        self._spawn_env = dict(env or {})
        # Streaming transfer plane: pipelined multi-source pulls with global
        # admission (reference: ObjectManager + PullManager).
        self.pull_manager = PullManager(self)
        # Long-lived peer daemon connections, reused across pulls instead of
        # dialing per object (reference: ObjectManager connection pool).
        self._peer_conns: dict[str, rpc.Connection] = {}
        # Spilled-object read cache: oid -> [fd, last_used]; one open() per
        # object per transfer session, chunks served with pread.
        self._spill_fds: dict[bytes, list] = {}
        # Strong refs to fire-and-forget tasks (asyncio tracks tasks weakly;
        # an unreferenced task can be GC'd mid-await — the init-task bug class).
        self._misc_tasks: set[asyncio.Task] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._bg: list[asyncio.Task] = []
        self.address = ""
        # Per-node worker log files, tailed by the LogMonitor task and
        # forwarded to drivers (reference: _private/log_monitor.py side-car).
        self.log_dir = os.path.join(self.session_dir, "logs", self.node_id[:12])
        self._log_monitor = None
        # Chaos: an injected TPU-preemption notice fired for this node (the
        # daemon drains, then drops off the cluster after the grace window).
        self._preempted = False
        # Flight dumps already reported to the controller (harvest dedup).
        self._flight_reported: set[str] = set()

    def _spawn_bg(self, coro, name: str | None = None) -> asyncio.Task:
        """create_task with a strong reference held until completion. Every
        fire-and-forget task in this daemon must go through here: asyncio
        keeps only weak refs, and a gc cycle landing mid-await kills an
        unreferenced task with GeneratorExit (observed as lost sealed-object
        reports and never-reported worker deaths)."""
        loop = self._loop if self._loop is not None else asyncio.get_running_loop()
        return _spawn_bg_task(self._misc_tasks, coro, loop=loop, name=name)

    # ------------------------------------------------------------------
    async def start(self, port: int = 0) -> str:
        self._loop = asyncio.get_running_loop()
        # GPU autodetection: a daemon on a GPU host advertises its cards and
        # their name exactly like the reference's accelerator managers feed
        # the raylet resource/label config
        # (python/ray/_private/accelerators/nvidia_gpu.py).
        if self.autodetect_accelerators:
            from ray_tpu_torch.accel.gpu import detect_gpu_resources

            gpu_res, gpu_labels = detect_gpu_resources()
            for k, v in gpu_res.items():
                self.resources.setdefault(k, v)
            for k, v in gpu_labels.items():
                self.labels.setdefault(k, v)
        self.store = SharedMemoryClient(
            self.store_path,
            capacity=self.store_capacity,
            create=True,
            spill_dir=self.config.object_spill_dir or None,
        )
        self.address = await self.server.start(port)
        # Persistent link: survives controller restarts — every (re)dial
        # replays registration, carrying live actors + resident objects so a
        # restored control plane re-converges (reference: raylet reconnect on
        # RayletNotifyGCSRestart, core_worker.proto:475).
        self.controller = rpc.PersistentConnection(
            self.controller_addr, handler=self, on_reconnect=self._register_with_controller
        )
        await self.controller.ensure()
        self._bg.append(asyncio.create_task(self._heartbeat_loop()))
        self._bg.append(asyncio.create_task(self._idle_reaper_loop()))
        self._bg.append(asyncio.create_task(self._transfer_metrics_loop()))
        from ray_tpu_torch.log_monitor import LogMonitor

        async def _publish_logs(batch: dict):
            batch["node_id"] = self.node_id
            await self.controller.notify("worker_logs", batch)

        self._log_monitor = LogMonitor(self.log_dir, _publish_logs)
        self._bg.append(asyncio.create_task(self._log_monitor.run()))
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor

        self._memory_monitor = MemoryMonitor(
            threshold=self.config.memory_usage_threshold,
            interval_s=self.config.memory_monitor_interval_s,
            get_workers=lambda: list(self.workers.values()),
            kill=self._kill_worker_proc,
            restartable=lambda w: w.restartable_actor,
        )
        self._bg.append(asyncio.create_task(self._memory_monitor.run()))
        logger.info("node daemon %s on %s (store %s)", self.node_id[:8], self.address, self.store_path)
        return self.address

    async def stop(self):
        for t in self._bg:
            t.cancel()
        for t in list(self._misc_tasks):
            t.cancel()
        for w in list(self.workers.values()):
            self._kill_worker_proc(w, "daemon shutdown")
        for conn in list(self._peer_conns.values()):
            try:
                await conn.close()
            except Exception:
                pass
        self._peer_conns.clear()
        for fd, _ts in self._spill_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._spill_fds.clear()
        await self.server.close()
        if self.controller:
            await self.controller.close()
        if self.store:
            spill_dir = self.store.spill_dir
            self.store.close()
            try:
                os.unlink(self.store_path)
            except OSError:
                pass
            if spill_dir and os.path.isdir(spill_dir):
                import shutil

                shutil.rmtree(spill_dir, ignore_errors=True)

    async def _register_with_controller(self, conn):
        objects = [(oid.binary(), size) for oid, size in self.store.list_objects()]
        if self.store.spill_dir and os.path.isdir(self.store.spill_dir):
            for fname in os.listdir(self.store.spill_dir):
                try:
                    oid = ObjectID(bytes.fromhex(fname))
                except ValueError:
                    continue
                objects.append((oid.binary(), os.path.getsize(os.path.join(self.store.spill_dir, fname))))
        actors = [
            {"actor_id": aid, "worker_addr": w.address, "worker_id": w.worker_id}
            for w in self.workers.values()
            if w.state == "ACTOR" and w.conn and not w.conn.closed
            for aid in w.actor_ids
        ]
        reply = await conn.call(
            "register_node",
            {
                "node_id": self.node_id,
                "address": self.address,
                "resources": self.resources,
                "labels": self.labels,
                "store_path": self.store_path,
                "objects": objects,
                "actors": actors,
            },
        )
        self.config = self.config.adopt_cluster(reply["config"])
        rpc.apply_transport_config(self.config)
        if self.config.chaos_spec:
            # Arm the chaos plane with the cluster schedule (idempotent for
            # an identical spec, so controller-restart re-registration does
            # not reset live hit counters).
            _chaos.install_from_json(self.config.chaos_spec)
        # Continuous profiler: a standalone daemon process samples itself
        # too (it is not behind any worker). Idempotent when co-resident
        # with a driver that already armed this process's sampler; the proc
        # label is left alone so dedup-by-proc stays stable.
        from ray_tpu_torch.obs import profiler as _profiler

        _profiler.arm(
            hz=self.config.profile_hz,
            max_stacks=self.config.profile_max_stacks,
            epoch_s=self.config.profile_epoch_s,
            window_epochs=self.config.profile_window_epochs,
            max_traces=self.config.profile_max_traces,
        )

    async def _heartbeat_loop(self):
        from ray_tpu_torch.accel.gpu import preemption_notice

        while True:
            await asyncio.sleep(self.config.heartbeat_interval_s)
            if not self._preempted:
                fault = preemption_notice(self.node_id, self.labels)
                if fault is not None:
                    self._preempted = True
                    self._spawn_bg(self._preempt_self(fault), name="tpu-preempt")
            try:
                await self.controller.notify("heartbeat", {
                    "node_id": self.node_id,
                    # Piggybacked node state for the controller's
                    # list_nodes/list_workers views (object-store occupancy
                    # + worker table; a few hundred bytes per beat).
                    "store": self._store_stats(),
                    "workers": [
                        {
                            "worker_id": w.worker_id,
                            "state": w.state,
                            "address": w.address,
                            "actors": len(w.actor_ids),
                        }
                        for w in self.workers.values()
                    ],
                })
            except Exception:
                pass

    async def _preempt_self(self, fault):
        """Injected TPU preemption (reference: GCE preemption notice -> the
        slice host disappears after a short grace). Drain first — the
        scheduler stops placing new work here — then drop off the cluster:
        workers die with the host and the controller observes the TCP close
        immediately (no heartbeat-timeout wait), restarting actors and
        rescheduling gang bundles elsewhere."""
        logger.warning(
            "chaos: TPU preemption notice for node %s (grace %.2fs)",
            self.node_id[:8], fault.delay_s,
        )
        # Black box: record the notice and dump the ring NOW, while the
        # grace window still exists — after it, this host is gone.
        from ray_tpu_torch.obs import flight as _flight

        _flight.record("tpu.preempt", node=self.node_id[:12], grace_s=fault.delay_s)
        _flight.dump("tpu.preempt", reason=f"node {self.node_id[:12]} preempted")
        try:
            await self.controller.call("drain_node", {"node_id": self.node_id})
        except Exception:
            pass
        await asyncio.sleep(fault.delay_s)
        for w in list(self.workers.values()):
            self._kill_worker_proc(w, "tpu preempted")
        await self.server.close()
        if self.controller:
            # PersistentConnection.close() latches closed: the heartbeat
            # loop's next notify raises instead of redialing (a preempted
            # host must not resurrect itself by re-registering).
            await self.controller.close()

    async def _idle_reaper_loop(self):
        while True:
            await asyncio.sleep(5.0)
            now = time.monotonic()
            for pool in self.idle_workers.values():
                for w in list(pool):
                    if now - w.last_idle_ts > self.config.idle_worker_killing_time_s:
                        pool.remove(w)
                        self._kill_worker_proc(w, "idle timeout")
            for key, (fd, ts) in list(self._spill_fds.items()):
                if now - ts > 60.0:  # transfer session over: release the fd
                    self._spill_fds.pop(key, None)
                    try:
                        os.close(fd)
                    except OSError:
                        pass

    async def _transfer_metrics_loop(self):
        """Ship the transfer plane's counters/gauges/histograms to the
        controller under this node's own reporter id. The series are built
        locally by the PullManager (not the process-global metrics registry),
        so in-process test clusters never double-report them through a
        co-resident CoreWorker reporter."""
        while True:
            await asyncio.sleep(self.config.metrics_report_interval_s)
            try:
                await self.controller.notify(
                    "report_metrics",
                    {"reporter": f"node:{self.node_id[:12]}", "series": self.pull_manager.metrics_series()},
                )
            except Exception:
                pass

    # -- worker pool ----------------------------------------------------
    async def _materialize_env(self, renv: Optional[dict]):
        """(env overrides, extra sys.path entries, cwd, hash) for a runtime
        env spec; packages cached per URI under the session dir."""
        if not renv:
            return {}, [], None, "", None, None
        from ray_tpu_torch.core import runtime_env as _re

        async def kv_get(uri: str):
            return await self.controller.call("kv_get", {"ns": _re.PKG_NS, "key": uri})

        cache_root = os.path.join(self.session_dir, "runtime_envs")
        os.makedirs(cache_root, exist_ok=True)
        try:
            env_vars, pypath, cwd, python_exe, container = await _re.materialize(
                renv, cache_root, kv_get
            )
        except _re.RuntimeEnvSetupError:
            # Deterministic failure: submitters see the TYPE across the RPC
            # hop (worker.py _request_lease isinstance-checks it), classify
            # it PERMANENT for the task key, and fail the task instead of
            # retrying the lease forever — a missing conda env or failed
            # build fails identically every try.
            raise
        except (rpc.ConnectionLost, ConnectionError,
                asyncio.TimeoutError, TimeoutError):
            # Transient control-plane fault mid-materialization (kv_get
            # hiccup, controller restart): propagate as-is so the
            # submitter's lease retry path gets another attempt. NOT the
            # broader RpcError: a controller HANDLER error repeats
            # identically per attempt — that's the permanent bucket below.
            raise
        except Exception as e:
            # Everything else is deterministic for this spec (corrupt
            # package zip, extract/filesystem errors, bad spec content) —
            # the same bytes fail the same way on every retry. Permanent by
            # default; only the known-transient set above retries.
            raise _re.RuntimeEnvSetupError(f"runtime_env setup failed: {e}") from e
        return env_vars, pypath, cwd, renv.get("hash", ""), python_exe, container

    def _spawn_worker(self, env_overrides: dict | None = None, pypath: list | None = None,
                      cwd: str | None = None, env_hash: str = "",
                      python_exe: str | None = None,
                      container: dict | None = None) -> WorkerRecord:
        worker_id = WorkerID.from_random().hex()
        env = {**os.environ, **self._spawn_env, **(env_overrides or {})}
        env["RAYTPU_WORKER_ID"] = worker_id
        env["RAYTPU_CONTROLLER_ADDR"] = self.controller_addr
        if self.config.auth_token:
            env["RAYTPU_AUTH_TOKEN"] = self.config.auth_token
        if self.config.chaos_spec:
            # Arm the worker's chaos plane at process start (worker_main),
            # BEFORE registration — exec-side faults must be able to hit the
            # very first task a fresh worker runs.
            env["RAYTPU_CHAOS_SPEC"] = self.config.chaos_spec
        env["RAYTPU_DAEMON_ADDR"] = self.address
        env["RAYTPU_NODE_IP"] = self.server.host  # workers bind/advertise the node's IP
        env["RAYTPU_STORE_PATH"] = self.store_path
        # Flight-recorder dumps land NEXT TO the worker logs: a last-gasp
        # dump (chaos kill, fatal crash) is harvested by _report_worker_died
        # from the same directory tree an operator already checks.
        env["RAYTPU_FLIGHT_DIR"] = os.path.join(self.log_dir, "flight")
        env["RAYTPU_NODE_ID"] = self.node_id
        env.setdefault("PYTHONPATH", "")
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        # Propagate the daemon/driver interpreter's sys.path so functions
        # pickled by reference (module-level fns in driver-side modules)
        # resolve in workers — the runtime-env equivalent of the reference's
        # working_dir/py_modules propagation (_private/runtime_env/).
        driver_path = os.pathsep.join(p for p in sys.path if p)
        parts = list(pypath or []) + [repo_root, driver_path, env["PYTHONPATH"]]
        env["PYTHONPATH"] = os.pathsep.join(p for p in parts if p)
        if os.environ.get("RAYTPU_WORKER_LOGS"):
            # Debug escape hatch: inherit the daemon's terminal directly.
            stdout, stderr = None, None
        else:
            # Per-worker log files, tailed by the LogMonitor and republished
            # to drivers (reference: workers log to session files that
            # log_monitor.py tails). Unbuffered so prints are timely.
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(self.log_dir, f"worker-{worker_id}.out"), "ab")
            stderr = open(os.path.join(self.log_dir, f"worker-{worker_id}.err"), "ab")
            env.setdefault("PYTHONUNBUFFERED", "1")
        # python_exe: a runtime-env venv/conda interpreter (dependency
        # isolation); defaults to the daemon's own. A container spec wraps
        # the whole worker command in the engine invocation instead.
        cmd = [python_exe or sys.executable, "-m", "ray_tpu_torch.core.worker_main"]
        if container is not None:
            from ray_tpu_torch.core import runtime_env as _re

            cmd = _re.container_spawn_command(
                container, container["engine"], env, self.session_dir, repo_root,
                cwd=cwd, gpus=self.resources.get("GPU", 0) > 0,
            )
        proc = subprocess.Popen(
            cmd,
            env=env,
            cwd=cwd,
            stdout=stdout,
            stderr=stderr,
        )
        if stdout is not None:
            stdout.close()
            stderr.close()
        record = WorkerRecord(
            worker_id=worker_id, proc=proc, ready=asyncio.get_running_loop().create_future(), env_hash=env_hash
        )
        self.workers[worker_id] = record
        return record

    async def handle_register_worker(self, conn, p):
        record = self.workers.get(p["worker_id"])
        if record is None:  # externally started worker (tests)
            record = WorkerRecord(worker_id=p["worker_id"], proc=None, ready=asyncio.get_running_loop().create_future())
            self.workers[p["worker_id"]] = record
        record.conn = conn
        record.address = p["address"]
        record.state = "IDLE"
        record.state_ts = time.monotonic()
        conn.meta.update(role="worker", worker_id=p["worker_id"])
        conn.on_close = lambda c, r=record: self._spawn_bg(self._on_worker_conn_closed(r))
        if record.ready and not record.ready.done():
            record.ready.set_result(record)
        return {"node_id": self.node_id, "config": self.config.to_dict()}

    async def _on_worker_conn_closed(self, record: WorkerRecord):
        if record.state == "DEAD":
            return
        record.state = "DEAD"
        self.workers.pop(record.worker_id, None)
        pool = self.idle_workers.get(record.env_hash)
        if pool and record in pool:
            pool.remove(record)
        logger.warning("worker %s died (actors=%s)", record.worker_id[:8], [a.hex()[:8] for a in map(_as_actor, record.actor_ids)])
        await self._report_worker_died(record, "worker process died")

    async def _report_worker_died(self, record: WorkerRecord, reason: str):
        """Tell the controller (exactly once per worker) so actor FSMs advance
        (reference: raylet NodeManager -> GcsActorManager::OnWorkerDead).
        Also harvests the worker's last-gasp flight dumps (written
        synchronously before os._exit, so the file beats the TCP close) and
        reports each path so post-mortems surface on /api/events."""
        if record.death_reported:
            return
        record.death_reported = True
        await self._report_flight_dumps(record, reason)
        try:
            await self.controller.call(
                "worker_died",
                {"worker_id": record.worker_id, "actor_ids": record.actor_ids, "reason": reason, "node_id": self.node_id},
            )
        except Exception:
            pass

    async def _report_flight_dumps(self, record: WorkerRecord, reason: str):
        """Harvest + report the worker's last-gasp dumps. Idempotent
        (``_flight_reported``), so every death path can call it."""
        for path in self._harvest_flight_dumps(record.worker_id):
            logger.warning("harvested flight dump for dead worker %s: %s",
                           record.worker_id[:8], path)
            try:
                await self.controller.notify("report_flight_dump", {
                    "proc": record.worker_id[:12], "path": path,
                    "trigger": "worker.death", "node_id": self.node_id,
                    "reason": reason,
                })
            except Exception:
                pass

    def _harvest_flight_dumps(self, worker_id: str) -> list[str]:
        """New (not-yet-reported) flight dumps this worker left on disk."""
        fdir = os.path.join(self.log_dir, "flight")
        try:
            names = os.listdir(fdir)
        except OSError:
            return []
        prefix = f"flight-{worker_id[:12]}-"
        out = []
        for n in sorted(names):
            if n.startswith(prefix) and n.endswith(".jsonl"):
                p = os.path.join(fdir, n)
                if p not in self._flight_reported:
                    self._flight_reported.add(p)
                    out.append(p)
        return out

    async def handle_flight_trace(self, conn, p):
        """Per-node leg of `raytpu trace export` reassembly: this daemon
        process's own recorder plus every live worker's (fanned out the
        memory_summary way). Dead/stalled workers are skipped — reassembly
        is best-effort recovery, not a barrier."""
        from ray_tpu_torch.obs import flight as _flight

        tid = p.get("trace_id", "")
        events = list(_flight.recorder().events_for_trace(tid))
        sources = 1
        for w in list(self.workers.values()):
            if w.conn is None or w.conn.closed or w.state == "DEAD":
                continue
            try:
                r = await asyncio.wait_for(
                    w.conn.call("flight_query", {"trace_id": tid}), timeout=5.0)
                events.extend(r.get("events", []))
                sources += 1
            except Exception:
                continue
        return {"events": events, "sources": sources}

    async def handle_profile_fold(self, conn, p):
        """Per-node leg of cluster profile collection: this daemon process's
        own fold (or status row) plus every live worker's, fanned out the
        flight_trace way. Returns the per-proc list UNMERGED — the top of
        the fan-in dedups by proc id, which is what keeps in-process
        topologies (daemon co-resident with the head/driver) from double
        counting a shared sampler."""
        from ray_tpu_torch.obs import profiler as _profiler

        req = {k: p[k] for k in ("status", "trace_id", "seconds", "window_s")
               if k in p}
        seconds = float(p.get("seconds") or 0.0)
        if seconds:
            loop = asyncio.get_running_loop()
            own = await loop.run_in_executor(
                None, lambda: _profiler.local_fold(req))
        else:
            own = _profiler.local_fold(req)
        errors: list[str] = []

        async def one(w):
            # Concurrent: a `seconds` capture runs on every worker at once
            # (serial fan-out would stack the capture windows end to end).
            try:
                return await asyncio.wait_for(
                    w.conn.call("profile_fold", req), timeout=seconds + 10.0)
            except Exception as e:
                errors.append(f"{w.worker_id[:8]}: {type(e).__name__}: {e}")
                return None

        live = [w for w in self.workers.values()
                if w.conn is not None and not w.conn.closed and w.state != "DEAD"]
        folds = [own] + [f for f in await asyncio.gather(*(one(w) for w in live))
                         if f is not None]
        return {"folds": folds, "errors": errors}

    async def _acquire_worker(self, renv: Optional[dict] = None) -> WorkerRecord:
        env_vars, pypath, cwd, env_hash, python_exe, container = await self._materialize_env(renv)
        pool = self.idle_workers.get(env_hash, [])
        while pool:
            w = pool.pop()
            if w.state == "IDLE" and w.conn and not w.conn.closed:
                return w
        record = self._spawn_worker(env_vars, pypath, cwd, env_hash, python_exe, container)
        await asyncio.wait_for(record.ready, timeout=self.config.worker_start_timeout_s)
        return record

    async def handle_lease_worker(self, conn, p):
        """Pop an idle worker of the right runtime env (or spawn one) and
        hand its address to the submitter (reference: WorkerPool::PopWorker
        via HandleRequestWorkerLease, idle cache keyed by runtime-env hash)."""
        record = await self._acquire_worker(p.get("runtime_env"))
        record.state = "LEASED"
        record.state_ts = time.monotonic()
        fault = _chaos.maybe_inject("node.worker.lease", worker=record.worker_id[:12])
        if fault is not None and fault.kind in ("kill", "hang"):
            # Kill (or SIGSTOP) this worker shortly after the lease lands —
            # deterministically mid-task for any task longer than delay_s.
            self._spawn_bg(self._chaos_worker_fault(record, fault), name="chaos-worker-fault")
        return {"worker_id": record.worker_id, "address": record.address}

    async def _chaos_worker_fault(self, record: WorkerRecord, fault):
        await asyncio.sleep(fault.delay_s)
        if record.state == "DEAD":
            return
        if fault.kind == "hang":
            # A wedged-but-alive worker: the process stops scheduling but the
            # TCP connection stays up (the hardest failure shape to detect).
            if record.proc is not None and record.proc.poll() is None:
                import signal as _signal

                record.proc.send_signal(_signal.SIGSTOP)
            return
        logger.warning("chaos: killing leased worker %s", record.worker_id[:8])
        self._kill_worker_proc(record, "chaos: injected worker kill")

    def handle_return_worker(self, conn, p):
        record = self.workers.get(p["worker_id"])
        if record and record.state == "LEASED":
            if p.get("reusable", True) and record.conn and not record.conn.closed:
                record.state = "IDLE"
                record.last_idle_ts = record.state_ts = time.monotonic()
                self.idle_workers.setdefault(record.env_hash, []).append(record)
            else:
                self._kill_worker_proc(record, "not reusable")
        return True

    async def handle_start_actor(self, conn, p):
        """Controller asks us to place an actor: lease a worker, have it
        construct the actor (reference: GcsActorScheduler lease+push)."""
        spec = p["spec"]
        record = await self._acquire_worker(getattr(spec.options, "runtime_env", None) or None)
        record.state = "ACTOR"
        record.state_ts = time.monotonic()
        try:
            await record.conn.call("create_actor", {"spec": spec}, timeout=self.config.actor_creation_timeout_s)
        except Exception:
            self._kill_worker_proc(record, "actor creation failed")
            raise
        record.actor_ids.append(spec.actor_id.binary())
        record.restartable_actor = getattr(spec.options, "max_restarts", 0) != 0
        return {"worker_addr": record.address, "worker_id": record.worker_id}

    async def handle_kill_worker(self, conn, p):
        record = self.workers.get(p["worker_id"])
        if record:
            if record.conn and not record.conn.closed:
                try:
                    await record.conn.notify("shutdown", {"reason": p.get("reason", "")})
                    await asyncio.sleep(0.05)
                except Exception:
                    pass
            self._kill_worker_proc(record, p.get("reason", "killed"))
        return True

    def _kill_worker_proc(self, record: WorkerRecord, reason: str):
        already_dead = record.state == "DEAD"
        record.state = "DEAD"
        self.workers.pop(record.worker_id, None)
        pool = self.idle_workers.get(record.env_hash)
        if pool and record in pool:
            pool.remove(record)
        if record.proc is not None and record.proc.poll() is None:
            record.proc.kill()
        # A daemon-initiated kill closes the conn AFTER state flips to DEAD,
        # so _on_worker_conn_closed won't report — report here or restartable
        # actors (max_restarts) would never leave ALIVE in the controller.
        if not already_dead and record.actor_ids:
            self._spawn_bg(self._report_worker_died(record, reason))
        elif not already_dead:
            # Plain task workers: the controller learns of the death through
            # the caller's retry path, but the black box still needs
            # harvesting — a "not reusable" lease return is how a chaos-
            # killed worker gets reaped when it races the conn-close event.
            self._spawn_bg(self._report_flight_dumps(record, reason))

    # -- object plane ---------------------------------------------------
    async def _peer(self, addr: str) -> rpc.Connection:
        """Cached daemon-to-daemon connection (dialed once, reused by every
        pull/chunk to that peer)."""
        conn = self._peer_conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        conn = await rpc.connect(addr, handler=None, timeout=2.0, retry=False)
        cached = self._peer_conns.get(addr)
        if cached is not None and not cached.closed:
            # Lost a dial race with a concurrent pull; keep the winner.
            await conn.close()
            return cached
        self._peer_conns[addr] = conn
        return conn

    async def _drop_peer(self, addr: str, conn: rpc.Connection):
        """Hard-drop a peer connection (it may be mid-raw-frame writing into
        a transfer buffer; closing cancels its read loop so a retried chunk
        can never race a stale writer on the same region)."""
        if self._peer_conns.get(addr) is conn:
            self._peer_conns.pop(addr, None)
        try:
            await conn.close()
        except Exception:
            pass

    async def handle_pull_object(self, conn, p):
        """Ensure the object is in the local store, pulling from remote nodes
        if needed (reference: PullManager admission + chunked transfer)."""
        oid = ObjectID(p["oid"])
        if self.store.contains(oid):
            return {"ok": True}
        if self._restore_local(oid):  # spilled locally: restore beats a network pull
            return {"ok": True}
        token = _tracing.activate(tuple(p["tc"])) if p.get("tc") else None
        try:
            ok = await self.pull_manager.pull(oid, p.get("locations"))
            return {"ok": ok}
        except Exception as e:
            return {"ok": False, "error": str(e)}
        finally:
            _tracing.deactivate(token)

    def _restore_local(self, oid: ObjectID) -> bool:
        """Restore a spilled object into the arena, reporting any objects
        truly evicted to make room (they have no spill copy)."""
        evicted: list = []
        ok = self.store.restore(oid, evicted_out=evicted)
        if evicted:
            self._spawn_bg(
                self.controller.notify(
                    "report_objects_evicted", {"oids": [o.binary() for o in evicted], "node_id": self.node_id}
                )
            )
        return ok

    def handle_object_info(self, conn, p):
        oid = ObjectID(p["oid"])
        view = self.store.get(oid)
        if view is None and self._restore_local(oid):
            view = self.store.get(oid)
        if view is None:
            size = self.store.spilled_size(oid)  # arena full: serve from disk
            return None if size is None else {"size": size}
        size = len(view)
        view.release()
        self.store.release(oid)
        return {"size": size}

    def _spilled_pread(self, oid: ObjectID, offset: int, length: int) -> bytes | None:
        """Ranged read of a spilled object through a per-object cached fd:
        ONE open per transfer session instead of a path resolve + open per
        chunk; pread needs no seek state so concurrent chunks can share the
        fd. The reaper closes fds idle >60s; delete closes eagerly."""
        fault = _chaos.maybe_inject("node.spill.pread", oid=oid.hex()[:16])
        if fault is not None and fault.kind == "error":
            return None  # unreadable spill file: callers fail loud (KeyError)
        fd = self._spill_fd(oid)
        if fd is None:
            return None
        try:
            return os.pread(fd, length, offset)
        except OSError:
            return None

    def _spill_fd(self, oid: ObjectID) -> int | None:
        """The cached read fd for a spilled object (opening it on first use),
        or None. Shared by _spilled_pread and the sendfile serve path — one
        open per transfer session either way."""
        if not self.store.spill_dir:
            return None
        key = oid.binary()
        ent = self._spill_fds.get(key)
        if ent is None:
            try:
                fd = os.open(os.path.join(self.store.spill_dir, oid.hex()), os.O_RDONLY)
            except OSError:
                return None
            ent = self._spill_fds[key] = [fd, 0.0]
        ent[1] = time.monotonic()
        return ent[0]

    def _close_spill_fd(self, oid: ObjectID):
        ent = self._spill_fds.pop(oid.binary(), None)
        if ent is not None:
            try:
                os.close(ent[0])
            except OSError:
                pass

    def _serve_chunk_chaos(self, oid: ObjectID, offset: int):
        """The chunk-serve fault gate, shared by the per-chunk and window
        serve handlers (graftlint's chaos-gate rule wants ONE literal
        ``node.chunk.serve`` injection point tree-wide, and the two handlers
        must fail identically under it)."""
        fault = _chaos.maybe_inject("node.chunk.serve", oid=oid.hex()[:16])
        if fault is not None:
            if fault.kind == "evict":
                # The object genuinely disappears from this node (arena AND
                # spill copy) with the directory told, exactly like real
                # eviction under a borrower: the puller falls back to the
                # directory and, with no copies left, the owner reconstructs
                # via lineage.
                self._close_spill_fd(oid)
                self.store.delete(oid, drop_spilled=True)
                self._spawn_bg(
                    self.controller.notify(
                        "report_objects_evicted",
                        {"oids": [oid.binary()], "node_id": self.node_id},
                    ),
                    name="chaos-evict-report",
                )
                raise KeyError(f"object {oid.hex()} not in store (chaos-evicted)")
            if fault.kind == "error":
                raise fault.error(f"chunk {oid.hex()[:10]}+{offset}")

    async def handle_read_object_chunk_raw(self, conn, p):
        """Serve one chunk on the raw lane: the payload is an arena
        memoryview slice (or a spilled pread) written straight to the wire —
        no bytes() copy, no pickle (reference: ObjectManager chunked Push).
        The reply is a tiny ack that can coalesce with other replies."""
        oid = ObjectID(p["oid"])
        offset, length = p["offset"], p["length"]
        self._serve_chunk_chaos(oid, offset)
        view = self.store.get(oid)
        if view is None and self._restore_local(oid):  # restore once, stream from arena
            view = self.store.get(oid)
        if view is None:
            data = self._spilled_pread(oid, offset, length)
            if data is None:
                raise KeyError(f"object {oid.hex()} not in store")
            if len(data) != length:
                # Fail loud with the real cause: shipping the short payload
                # would make the receiver discard it as a size mismatch and
                # retry this same truncated file until the source is declared
                # dead, burying "spill file truncated" under generic errors.
                raise OSError(
                    f"truncated spill read for {oid.hex()}: wanted {length} at +{offset}, got {len(data)}"
                )
            await conn.send_raw(p["key"], data)
            self.pull_manager.bytes_out += length
            return True
        try:
            sl = view[offset : offset + length]
            await conn.send_raw(p["key"], sl)
            self.pull_manager.bytes_out += len(sl)
            return True
        finally:
            view.release()
            self.store.release(oid)

    async def handle_read_object_window_raw(self, conn, p):
        """Serve a RUN of chunks (a whole pull window) on the raw lane with
        ONE control RPC and — on authenticated links — ONE MAC tag for the
        run (window mode, see rpc.raw_window_hasher): chunk i of the run is
        a NOPTAG raw frame keyed base||i, payload bytes streamed into a
        shared window HMAC whose tag returns in this handler's authenticated
        envelope reply. The puller hashes the same bytes as they land and
        compares — tamper anywhere in the window fails the WHOLE window
        typed and it refetches per-chunk. With auth off there is no MAC
        either way, and a spilled run goes fd->socket via os.sendfile (the
        payload never enters userspace)."""
        oid = ObjectID(p["oid"])
        offset, length, chunk = p["offset"], p["length"], p["chunk"]
        base = p["key"]
        self._serve_chunk_chaos(oid, offset)
        hasher = rpc.raw_window_hasher() if rpc.get_auth_token() else None
        view = self.store.get(oid)
        if view is None and self._restore_local(oid):  # restore once, stream from arena
            view = self.store.get(oid)
        try:
            pos, end, i = offset, offset + length, 0
            while pos < end:
                cln = min(chunk, end - pos)
                key = base + i.to_bytes(4, "little")
                if view is not None:
                    await conn.send_raw(key, view[pos : pos + cln], hasher=hasher)
                elif hasher is None and (fd := self._spill_fd(oid)) is not None:
                    await conn.send_raw_file(key, fd, pos, cln)
                else:
                    data = self._spilled_pread(oid, pos, cln)
                    if data is None:
                        raise KeyError(f"object {oid.hex()} not in store")
                    if len(data) != cln:
                        # Same fail-loud contract as the per-chunk handler:
                        # surface "spill file truncated", don't let the
                        # window tag mismatch bury it.
                        raise OSError(
                            f"truncated spill read for {oid.hex()}: wanted {cln} at +{pos}, got {len(data)}"
                        )
                    await conn.send_raw(key, data, hasher=hasher)
                self.pull_manager.bytes_out += cln
                pos += cln
                i += 1
        finally:
            if view is not None:
                view.release()
                self.store.release(oid)
        return {"ok": True, "tag": hasher.digest()[: rpc.FRAME_TAG_LEN] if hasher is not None else b""}

    def handle_delete_objects(self, conn, p):
        for oid_bin in p["oids"]:
            oid = ObjectID(oid_bin)
            self._close_spill_fd(oid)
            self.store.delete(oid, drop_spilled=True)
        return True

    def handle_report_sealed(self, conn, p):
        # Worker sealed an object locally; forward the location to the directory.
        self._spawn_bg(self._report_sealed(p))
        return True

    async def _report_sealed(self, p):
        try:
            await self.controller.notify("report_object", {"oid": p["oid"], "node_id": self.node_id, "size": p.get("size", 0)})
        except Exception:
            pass

    def _store_stats(self) -> dict:
        """The one shape of this node's arena occupancy (heartbeat piggyback
        and memory_summary) — add a stat here, not per caller."""
        return {"capacity": self.store.capacity, "used": self.store.used, "num_objects": self.store.num_objects}

    async def handle_memory_summary(self, conn, p):
        """Per-node half of the cluster `ray memory` fan-out: this node's
        store occupancy plus every live resident worker's ownership/
        reference summary (workers answer the same RPC in-process)."""
        limit = int(p.get("limit", 200))

        async def one(w: WorkerRecord):
            try:
                return await asyncio.wait_for(
                    w.conn.call("memory_summary", {"limit": limit}), timeout=10
                )
            except Exception as e:
                return {"worker_id": w.worker_id, "error": f"{type(e).__name__}: {e}"}

        live = [
            w for w in self.workers.values()
            if w.state not in ("DEAD", "STARTING") and w.conn is not None and not w.conn.closed
        ]
        return {
            "node_id": self.node_id,
            "store": self._store_stats(),
            "workers": list(await asyncio.gather(*(one(w) for w in live))),
        }

    def handle_tail_worker_log(self, conn, p):
        """Serve the tail of a resident worker's log file (the fetch half of
        `raytpu logs`; the follow half rides the controller's `logs` pubsub).
        Accepts a worker-id prefix; returns both streams' tails."""
        prefix = p.get("worker_id", "")
        max_bytes = min(int(p.get("max_bytes", 64 * 1024)), 1024 * 1024)
        out = {}
        if not os.path.isdir(self.log_dir):
            return out
        for name in sorted(os.listdir(self.log_dir)):
            if not name.startswith("worker-"):
                continue
            stem, _, ext = name.rpartition(".")
            wid = stem[len("worker-"):]
            if ext not in ("out", "err") or not wid.startswith(prefix):
                continue
            path = os.path.join(self.log_dir, name)
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - max_bytes))
                    data = f.read(max_bytes)
            except OSError:
                continue
            lines = data.decode("utf-8", errors="replace").splitlines()
            if size > max_bytes and lines:
                lines = lines[1:]  # drop the partial first line of the window
            out.setdefault(wid, {})["stderr" if ext == "err" else "stdout"] = lines
        return out


class _LocalHist:
    """Tiny daemon-local histogram accumulator emitting snapshot()-shaped
    records. Deliberately NOT the process-global metrics registry: in-process
    test clusters co-host daemons with a CoreWorker whose reporter ships that
    registry — daemon series must ride the daemon's own reporter id only."""

    __slots__ = ("buckets", "counts", "sum", "n")

    def __init__(self, buckets: list):
        self.buckets = list(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, value: float):
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.n += 1

    def record(self, name: str, desc: str, ts: float) -> dict:
        return {
            "name": name, "kind": "histogram", "description": desc,
            "tags": {}, "value": 0.0, "ts": ts,
            "buckets": list(self.buckets), "counts": list(self.counts),
            "sum": self.sum, "n": self.n,
        }


class PullManager:
    """Pipelined, multi-source object pulls (reference: ObjectManager +
    PullManager, object_manager.h:128).

    Per object: a window of K chunks in flight (fills the bandwidth-delay
    product instead of stop-and-wait), chunk ranges striped across every
    replica the directory returns, and per-chunk failover — a failed chunk
    retries against an alternate source instead of restarting the object.
    Globally: admission caps (concurrent pulls, inflight bytes) so bulk
    transfer cannot starve the control plane, concurrent pulls of one oid
    coalesce onto a single transfer, and peer connections are reused from
    the daemon's cache. Chunks move on the rpc raw lane: never pickled,
    recv'd straight into the arena buffer at the chunk's offset."""

    def __init__(self, daemon: "NodeDaemon"):
        self.daemon = daemon
        self._pulls: dict[bytes, asyncio.Future] = {}
        self._sem: asyncio.Semaphore | None = None  # lazily: needs the loop
        self._byte_waiters: collections.deque = collections.deque()
        self._inflight_bytes = 0
        self._inflight_pulls = 0
        # Counters (plain ints on the hot path; shipped by metrics_series).
        self.bytes_in = 0
        self.bytes_out = 0
        self.pulls_ok = 0
        self.pulls_failed = 0
        self.chunks_retried = 0
        self._lat = _LocalHist([0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120])
        self._mbs = _LocalHist([1, 4, 16, 64, 256, 1024, 4096])
        # Last completed pull's shape, for bench detail / debugging.
        self.last_pull: dict = {}

    def _ensure_primitives(self):
        if self._sem is None:
            self._sem = asyncio.Semaphore(max(1, self.daemon.config.max_concurrent_pulls))

    # -- admission ------------------------------------------------------
    # Byte budget without a Condition: single-threaded on the daemon loop, so
    # the uncontended path is a plain counter bump (no lock round trip per
    # chunk) and waiters park on bare futures that release wakes.
    async def _acquire_bytes(self, n: int):
        budget = max(1, self.daemon.config.max_inflight_pull_bytes)
        # A single chunk larger than the whole budget still admits when
        # nothing else is in flight (no deadlock on huge chunk sizes).
        while not (self._inflight_bytes == 0 or self._inflight_bytes + n <= budget):
            fut = asyncio.get_running_loop().create_future()
            self._byte_waiters.append(fut)
            await fut
        self._inflight_bytes += n

    def _release_bytes(self, n: int):
        self._inflight_bytes -= n
        while self._byte_waiters:
            fut = self._byte_waiters.popleft()
            if not fut.done():
                fut.set_result(None)  # wake all; each re-checks the budget

    # -- public entry ---------------------------------------------------
    async def pull(self, oid: ObjectID, locations=None) -> bool:
        """Pull ``oid`` into the local arena. Concurrent calls for the same
        oid coalesce onto one transfer (everyone awaits the same future)."""
        self._ensure_primitives()
        key = oid.binary()
        fut = self._pulls.get(key)
        if fut is not None:
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._pulls[key] = fut
        ok = False
        try:
            ok = await self._pull_once(oid, locations)
        except Exception as e:
            logger.warning("pull %s failed: %s", oid.hex()[:10], e)
        finally:
            self._pulls.pop(key, None)
            if not fut.done():
                fut.set_result(ok)
        return ok

    async def _pull_once(self, oid: ObjectID, locations) -> bool:
        d = self.daemon
        if d.store.contains(oid):
            return True
        hinted = locations is not None
        if not hinted:
            locations = await d.controller.call("lookup_object", {"oid": oid.binary()})
        sources = [dict(loc) for loc in (locations or []) if loc["node_id"] != d.node_id]
        if not sources and not hinted:
            return False
        t0 = time.monotonic()
        self._inflight_pulls += 1
        ok = False
        try:
            with _tracing.child_span("object.pull", oid=oid.hex()[:16]):
                async with self._sem:  # pull admission
                    try:
                        ok = bool(sources) and await self._transfer(oid, sources, t0)
                    except Exception:
                        if not hinted:
                            raise
                        ok = False  # hinted sources died mid-transfer: ask the directory
                    if not ok and hinted:
                        # Owner hints are an optimization, not the truth:
                        # the hinted replica may be dead or evicted while
                        # the directory knows a live copy elsewhere (any
                        # earlier puller reported it). One fallback lookup,
                        # excluding sources that just failed.
                        tried = {s["node_id"] for s in sources}
                        fresh = await d.controller.call("lookup_object", {"oid": oid.binary()})
                        alt = [
                            dict(loc) for loc in (fresh or [])
                            if loc["node_id"] != d.node_id and loc["node_id"] not in tried
                        ]
                        if alt:
                            ok = await self._transfer(oid, alt, t0)
        finally:
            # In the finally so an exception exit still counts as a failed
            # pull — the failed counter exists precisely for those.
            self._inflight_pulls -= 1
            if ok:
                self.pulls_ok += 1
            else:
                self.pulls_failed += 1
        return ok

    async def _transfer(self, oid: ObjectID, sources: list, t0: float) -> bool:
        d = self.daemon
        cfg = d.config
        # Probe every advertised replica in parallel; only sources that
        # actually hold the object (directory entries can be stale) join the
        # stripe set.
        async def probe(loc):
            try:
                conn = await d._peer(loc["address"])
                info = await asyncio.wait_for(
                    conn.call("object_info", {"oid": oid.binary()}), cfg.pull_chunk_timeout_s
                )
                return (loc, info["size"]) if info else None
            except Exception:
                return None

        probed = [r for r in await asyncio.gather(*(probe(loc) for loc in sources)) if r]
        if not probed:
            return False
        size = probed[0][1]
        live = [loc for loc, sz in probed if sz == size]
        chunk = cfg.pull_chunk_size
        nchunks = (size + chunk - 1) // chunk or 1
        # Window mode: chunks group into runs of up to pull_window_chunks,
        # each fetched with ONE control RPC (and, with auth on, ONE MAC tag)
        # via read_object_window_raw — see _fetch_window. Chunk mode (and
        # single-chunk runs) keeps the v3 per-chunk shape. Runs stripe
        # across sources exactly like chunks did, and a run never admits
        # more than the inflight-byte budget in one acquisition (the
        # admission cap must bound window mode exactly as it bounds chunks).
        run_chunks = 1
        if getattr(cfg, "raw_mac_granularity", "window") == "window":
            run_chunks = max(1, cfg.pull_window_chunks)
            run_chunks = min(run_chunks, max(1, cfg.max_inflight_pull_bytes // chunk))
        runs: list[tuple[int, int]] = []
        i = 0
        while i < nchunks:
            k = min(run_chunks, nchunks - i)
            runs.append((i, k))
            i += k
        pending = collections.deque(runs)
        retried_before = self.chunks_retried
        stop = False
        buf = None
        try:
            buf, evicted = d.store.create_autoevict(oid, size)
            if evicted:
                await d.controller.notify(
                    "report_objects_evicted", {"oids": [o.binary() for o in evicted], "node_id": d.node_id}
                )

            async def window_worker():
                nonlocal stop
                while pending and not stop:
                    ri, rk = pending.popleft()
                    off = ri * chunk
                    ln = min(rk * chunk, size - off)
                    await self._acquire_bytes(ln)
                    try:
                        if rk == 1:
                            await self._fetch_chunk(oid, buf, off, ln, live, ri)
                        else:
                            await self._fetch_window(oid, buf, off, ln, chunk, live, ri)
                        self.bytes_in += ln
                    except Exception:
                        stop = True
                        raise
                    finally:
                        self._release_bytes(ln)

            # Through the daemon's strong-ref registry for uniformity with
            # every other spawn (the local `workers` list + gather below
            # already pin these, but one spawn idiom keeps graftlint's
            # bg-strong-ref story simple and names the tasks for leak debug).
            workers = [
                d._spawn_bg(window_worker(), name="pull-window")
                for _ in range(min(max(1, cfg.pull_window_chunks), len(runs)))
            ]
            results = await asyncio.gather(*workers, return_exceptions=True)
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                raise errs[0]
            d.store.seal(oid)
        except BaseException:
            if buf is not None:
                # abort(), not delete(): the entry is created-but-unsealed,
                # and the writer pin makes a plain delete refuse it — the
                # allocation would leak and ObjectExistsError would poison
                # every future pull of this oid on this node.
                try:
                    d.store.abort(oid)
                except Exception:
                    pass
            raise
        finally:
            del buf
        elapsed = max(time.monotonic() - t0, 1e-9)
        mb_s = size / elapsed / 1e6
        self._lat.observe(elapsed)
        self._mbs.observe(mb_s)
        self.last_pull = {
            "size": size,
            "window": min(max(1, cfg.pull_window_chunks), nchunks),
            "sources": len(live),
            "chunks": nchunks,
            "chunks_retried": self.chunks_retried - retried_before,
            "mb_s": round(mb_s, 1),
            "mode": "window" if run_chunks > 1 else "chunk",
        }
        _tracing.event("object.pull.done", size=size, mb_s=round(mb_s, 1))
        await d.controller.notify(
            "report_object", {"oid": oid.binary(), "node_id": d.node_id, "size": size}
        )
        return True

    def _pull_source_chaos(self, src: dict):
        """The pull-source fault gate, shared by the window and per-chunk
        fetch paths (ONE literal ``node.pull.source`` injection point —
        chaos-gate's uniqueness contract): a simulated source death spends
        that source's failure budget and hard-drops its connection exactly
        like a real mid-transfer failure."""
        pull_fault = _chaos.maybe_inject("node.pull.source", source=src["node_id"][:12])
        if pull_fault is not None and pull_fault.kind == "error":
            raise pull_fault.error(f"source {src['node_id'][:8]}")

    async def _fetch_window(self, oid: ObjectID, buf, off: int, ln: int, chunk: int, sources: list, idx: int):
        """Fetch a run of chunks with ONE read_object_window_raw RPC.
        Chunk i of the run lands at its own offset (keyed base||i) and, on
        authenticated links, streams into a shared window HMAC compared
        against the tag the serve reply carries — tamper ANYWHERE in the run
        fails the whole window typed, the source connection is hard-dropped
        (it may be mid-frame), and the run refetches per-chunk with its own
        failover budget. A peer without the window handler ("no handler"
        RpcError — an older build) is remembered on its connection and
        served per-chunk from then on (capability negotiation by first
        use)."""
        d = self.daemon
        cfg = d.config
        nchunks = (ln + chunk - 1) // chunk
        # One deadline over the whole run: proportional to the per-chunk
        # deadline so degraded links don't time out a window that would have
        # passed chunk by chunk.
        timeout = cfg.pull_chunk_timeout_s * max(1.0, nchunks / 2)
        n = len(sources)
        for attempt in range(n):
            src = sources[(idx + attempt) % n]
            if src.get("dead"):
                continue
            conn = None
            try:
                conn = await d._peer(src["address"])
            except Exception:
                continue
            if conn.meta.get("no_window_raw"):
                continue  # known pre-window peer: per-chunk fallback below
            base = os.urandom(12)
            hasher = rpc.raw_window_hasher() if rpc.get_auth_token() else None
            keys = []
            futs = []
            try:
                self._pull_source_chaos(src)
                for i in range(nchunks):
                    coff = off + i * chunk
                    cln = min(chunk, off + ln - coff)
                    key = base + i.to_bytes(4, "little")
                    keys.append(key)
                    futs.append(conn.expect_raw(key, buf[coff : coff + cln], hasher))
                try:
                    ack, *landed = await asyncio.wait_for(
                        asyncio.gather(
                            conn.call(
                                "read_object_window_raw",
                                {"oid": oid.binary(), "offset": off, "length": ln,
                                 "chunk": chunk, "key": base},
                            ),
                            *futs,
                        ),
                        timeout,
                    )
                finally:
                    for key in keys:
                        conn.unexpect_raw(key)
                if not ack or not ack.get("ok") or not all(landed):
                    raise rpc.RpcError("window transfer failed")
                if hasher is not None and not hmac.compare_digest(
                    ack.get("tag", b""), hasher.digest()[: rpc.FRAME_TAG_LEN]
                ):
                    raise rpc.RawWindowTamperError(
                        f"window MAC mismatch for {oid.hex()[:10]}+{off} from {src['node_id'][:8]}"
                    )
                return
            except Exception as e:
                if isinstance(e, rpc.RpcError) and "no handler" in str(e):
                    # Older peer without the window RPC: negotiate down to
                    # per-chunk for this connection's lifetime, silently.
                    conn.meta["no_window_raw"] = True
                    break
                self.chunks_retried += nchunks
                _tracing.event(
                    "object.pull.window_retry",
                    oid=oid.hex()[:16], offset=off, source=src["node_id"][:8],
                    error=f"{type(e).__name__}: {e}"[:120],
                )
                logger.warning(
                    "window %s+%d of %s from %s failed (%s: %s); refetching per-chunk",
                    off, ln, oid.hex()[:10], src["node_id"][:8], type(e).__name__, e,
                )
                # The source may be mid-frame into our buffer: hard-drop its
                # connection so a dead writer can't race the per-chunk retry
                # on the same region (same contract as _fetch_chunk).
                if conn is not None and d._peer_conns.get(src["address"]) is conn:
                    await d._drop_peer(src["address"], conn)
                break
        # Per-chunk fallback: every chunk of the run through the v3 path
        # with its own striping + failover budget.
        for i in range(nchunks):
            coff = off + i * chunk
            cln = min(chunk, off + ln - coff)
            await self._fetch_chunk(oid, buf, coff, cln, sources, idx + i)

    async def _fetch_chunk(self, oid: ObjectID, buf, off: int, ln: int, sources: list, idx: int):
        """Fetch one chunk, striping the initial source by chunk index and
        failing over to alternates (each failure hard-drops the offending
        connection: it may be mid-frame into our buffer, and a dead writer
        must not race the retry on the same region)."""
        d = self.daemon
        timeout = d.config.pull_chunk_timeout_s
        n = len(sources)
        last_err: Exception | None = None
        budget = 2 * n  # real failures spend this; collateral drops don't
        attempt = 0
        guard = 0
        while budget > 0 and guard < 8 * n:
            guard += 1
            src = sources[(idx + attempt) % n]
            attempt += 1
            if src.get("dead"):
                if all(s.get("dead") for s in sources):
                    break
                continue
            conn = None
            try:
                conn = await d._peer(src["address"])
                self._pull_source_chaos(src)
                key = os.urandom(12)
                fut = conn.expect_raw(key, buf[off : off + ln])
                try:
                    # One deadline over both halves (request ack + payload
                    # landing); they overlap — the raw frame is usually on
                    # the wire before the coalesced ack reply.
                    ack, landed = await asyncio.wait_for(
                        asyncio.gather(
                            conn.call(
                                "read_object_chunk_raw",
                                {"oid": oid.binary(), "offset": off, "length": ln, "key": key},
                            ),
                            fut,
                        ),
                        timeout,
                    )
                finally:
                    conn.unexpect_raw(key)
                if not ack or not landed:
                    raise rpc.RpcError("chunk transfer failed")
                return
            except Exception as e:
                last_err = e
                self.chunks_retried += 1
                # Collateral ConnectionLost: ANOTHER chunk worker already
                # hard-dropped this connection (it is no longer the cached
                # one). That is one source problem fanned out across the
                # whole window — charging it to this source's death budget
                # would let a single slow chunk kill a healthy
                # single-replica pull. Redial and retry without spending.
                collateral = (
                    isinstance(e, rpc.ConnectionLost)
                    and conn is not None
                    and d._peer_conns.get(src["address"]) is not conn
                )
                if not collateral:
                    budget -= 1
                    src["failures"] = src.get("failures", 0) + 1
                    if src["failures"] >= 2:
                        src["dead"] = True
                _tracing.event(
                    "object.pull.chunk_retry",
                    oid=oid.hex()[:16], offset=off, source=src["node_id"][:8],
                    error=f"{type(e).__name__}: {e}"[:120],
                )
                logger.warning(
                    "chunk %s+%d of %s from %s failed (%s); trying alternate",
                    off, ln, oid.hex()[:10], src["node_id"][:8], e,
                )
                if conn is not None and not collateral:
                    await d._drop_peer(src["address"], conn)
            if all(s.get("dead") for s in sources):
                break
        raise last_err if last_err is not None else rpc.RpcError("no live sources")

    # -- observability ---------------------------------------------------
    def metrics_series(self) -> list[dict]:
        now = time.time()
        out = []

        def rec(name, kind, value, tags, desc=""):
            out.append({"name": name, "kind": kind, "description": desc,
                        "tags": tags, "value": float(value), "ts": now})

        rec("object.transfer.bytes", "counter", self.bytes_in,
            {"dir": "in"}, "object bytes pulled into this node's arena")
        rec("object.transfer.bytes", "counter", self.bytes_out,
            {"dir": "out"}, "object bytes served to remote pullers")
        rec("object.pull.count", "counter", self.pulls_ok, {"result": "ok"})
        rec("object.pull.count", "counter", self.pulls_failed, {"result": "failed"})
        rec("object.pull.chunk_retries", "counter", self.chunks_retried, {},
            "chunks retried against an alternate source")
        rec("object.pull.inflight", "gauge", self._inflight_pulls, {},
            "object pulls currently in progress")
        rec("object.pull.inflight_bytes", "gauge", self._inflight_bytes, {},
            "chunk bytes currently in flight across all pulls")
        out.append(self._lat.record("object.pull.latency_s",
                                    "whole-object pull latency (seconds)", now))
        out.append(self._mbs.record("object.transfer.mb_s",
                                    "per-pull transfer throughput (MB/s)", now))
        return out


def _as_actor(b):
    from ray_tpu_torch.core.ids import ActorID

    return ActorID(b)
