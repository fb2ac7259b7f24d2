"""Public API: init/shutdown/remote/get/put/wait + cluster bootstrap.

Reference equivalents: ray.init/connect (python/ray/_private/worker.py:1406,
2437), @ray.remote dispatch (worker.py), and ray.cluster_utils.Cluster
(python/ray/cluster_utils.py:135) — the multi-node-on-one-machine test
harness: N in-process node daemons + one controller, with arbitrary fake
resources per node, so multi-node scheduling (including fake TPU slices) is
testable with zero TPUs (SURVEY §4).
"""
from __future__ import annotations

import asyncio
import atexit
import inspect
import os
import tempfile
import threading
import time
from typing import Any, Optional, Sequence

from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.config import Config, get_config
from ray_tpu_torch.core.controller import Controller
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.node import NodeDaemon
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.task_spec import ActorOptions, TaskOptions
from ray_tpu_torch.core.worker import ActorDiedError, CoreWorker

_global_worker: CoreWorker | None = None
_global_cluster: "Cluster | None" = None


class _ServiceHost:
    """Runs controller/daemons on a dedicated asyncio loop thread."""

    def __init__(self, name="raytpu-services"):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def call(self, coro, timeout=30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self):
        async def drain():
            tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            self.call(drain(), timeout=2)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


def _session_token_path(address: str) -> str:
    """Where the head publishes this session's auto-generated RPC token
    (mode 0600): same-host clients joining by address load it from here."""
    port = address.rsplit(":", 1)[-1]
    return os.path.join(tempfile.gettempdir(), f"raytpu_token_{port}")


def _write_session_token_file(address: str, token: str) -> str | None:
    """Publish the session token for same-host drivers; returns the path, or
    None if it couldn't be written safely (joiners then need
    RAYTPU_AUTH_TOKEN). O_EXCL|O_NOFOLLOW after unlink: an attacker-planted
    file or symlink at the predictable path must never receive the secret
    (O_CREAT|O_TRUNC would happily write into it with ITS mode)."""
    path = _session_token_path(address)
    try:
        os.unlink(path)
    except OSError:
        pass
    try:
        fd = os.open(
            path,
            os.O_WRONLY | os.O_CREAT | os.O_EXCL | getattr(os, "O_NOFOLLOW", 0),
            0o600,
        )
        with os.fdopen(fd, "w") as f:
            f.write(token)
        return path
    except OSError:
        return None


# Live in-process Clusters. The auth-token scrub on shutdown must not pull
# the shared session token out from under another Cluster that inherited it
# (both would be using the same process-global Config + rpc key).
_LIVE_CLUSTERS: list = []
# Every token ever auto-minted by THIS process (bounded: one per in-process
# cluster). Cluster bring-up and init(address=...) refuse to authenticate
# with one of these unless a live cluster still owns it — defense in depth
# over the shutdown scrub: no leak path can make a driver reuse a dead
# session's secret against a fresh cluster.
_MINTED_HISTORY: set = set()


def _token_owned_by_live_cluster(token: str) -> bool:
    """True only when a genuinely-live in-process Cluster owns ``token``.

    Compares against each cluster's token SNAPSHOT (``_session_token``,
    frozen at construction), never the live shared Config: every in-process
    Cluster aliases the process-global Config object, so ``c.config
    .auth_token == token`` was trivially true for ANY current token whenever
    a stale record survived in _LIVE_CLUSTERS — one leaked cluster record
    made this predicate veto every later scrub and stale-mint drop in the
    process (full-suite test_start_cli failures were this: the leaked
    record "owned" whatever token happened to be in the config). A cluster
    whose service thread is gone cannot be serving anyone either way."""
    return any(
        c._session_token and c._session_token == token
        and getattr(getattr(c, "host", None), "thread", None) is not None
        and c.host.thread.is_alive()
        for c in _LIVE_CLUSTERS
    )


def _drop_stale_minted_token(cfg) -> None:
    """Single home for the stale-mint predicate (used by Cluster bring-up
    AND the address-connect path): a token this process auto-minted whose
    session is gone must never authenticate anything new."""
    if (
        cfg.auth_token
        and cfg.auth_token in _MINTED_HISTORY
        and not _token_owned_by_live_cluster(cfg.auth_token)
    ):
        cfg.auth_token = ""


class Cluster:
    """Multi-node cluster on one machine (reference: cluster_utils.Cluster)."""

    def __init__(self, initialize_head: bool = True, head_node_args: dict | None = None,
                 config: Config | None = None, persist_path: str | None = None):
        self.config = config or get_config()
        # A DEAD in-process session's auto-minted secret may have survived
        # in this (shared) Config (a skipped scrub). Never build a new
        # cluster on a dead session's key: drop it so a fresh one mints.
        _drop_stale_minted_token(self.config)
        if not self.config.auth_token and os.environ.get("RAYTPU_AUTO_TOKEN", "1") != "0":
            # Auto-generated per-session RPC secret (reference: required auth
            # infrastructure, src/ray/rpc/authentication): the head mints a
            # token at cluster start, propagates it to daemons (in-process),
            # workers (env), and same-host drivers (session token file, see
            # _session_token_path). Pickle-over-TCP is never unauthenticated
            # by default; set RAYTPU_AUTO_TOKEN=0 to opt out, or
            # RAYTPU_AUTH_TOKEN to pin a cluster-wide token for multi-host.
            import secrets

            self.config.auth_token = secrets.token_hex(16)
            _MINTED_HISTORY.add(self.config.auth_token)
            # Minted into a (possibly process-global) Config: remember to
            # scrub it on shutdown, or the NEXT session in this process
            # inherits a dead cluster's token and fails every MAC check
            # against a freshly-tokened cluster (an order-sensitive start-CLI
            # ConnectionLost).
            self._minted_token = True
        else:
            self._minted_token = False
        # Ownership snapshot: the token THIS cluster serves with, frozen now.
        # _token_owned_by_live_cluster compares against this, not the live
        # (shared, mutable) Config field.
        self._session_token = self.config.auth_token
        from ray_tpu_torch.core import rpc as _rpc

        if self.config.auth_token:
            _rpc.set_auth_token(self.config.auth_token)
        # Transport knobs (vectored sends, MAC granularity, net shaping)
        # install alongside the token: the head process serves raw frames
        # too, so it must agree with the nodes it pushes this config to.
        _rpc.apply_transport_config(self.config)
        self.host = _ServiceHost()
        self.controller = Controller(self.config, persist_path=persist_path)
        self.controller_addr = self.host.call(self.controller.start())
        self._token_file = None
        if self.config.auth_token:
            self._token_file = _write_session_token_file(
                self.controller_addr, self.config.auth_token
            )
        self.daemons: list[NodeDaemon] = []
        _LIVE_CLUSTERS.append(self)
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        return self.controller_addr

    def add_node(
        self,
        num_cpus: float | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        env: dict | None = None,
        object_store_memory: int | None = None,
        **kw,
    ) -> NodeDaemon:
        res = dict(resources or {})
        if num_cpus is not None:
            res.setdefault("CPU", float(num_cpus))
        elif "CPU" not in res:
            res["CPU"] = 4.0
        daemon = NodeDaemon(
            self.controller_addr,
            config=self.config,
            resources=res,
            labels=labels,
            env=env,
            store_capacity=object_store_memory,
            # Hermetic by default: fake clusters advertise exactly what the
            # test passes, even on a real TPU host (kw override for prod).
            autodetect_accelerators=kw.get("autodetect_accelerators", False),
        )
        self.host.call(daemon.start())
        self.daemons.append(daemon)
        return daemon

    def restart_controller(self):
        """Stop the controller abruptly and start a fresh one on the same
        address (control-plane FT: the replacement restores from the snapshot
        and daemons/drivers re-register over their persistent connections —
        reference: GCS restart with Redis persistence, gcs_server.h:136)."""
        port = int(self.controller_addr.rsplit(":", 1)[1])
        persist = self.controller.persist_path
        self.host.call(self.controller.stop())
        self.controller = Controller(self.config, persist_path=persist)
        self.host.call(self.controller.start(port))

    def remove_node(self, daemon: NodeDaemon):
        if daemon in self.daemons:
            self.daemons.remove(daemon)
        self.host.call(daemon.stop())

    def shutdown(self):
        # The teardown steps can raise under load (hung daemon joins, dead
        # controller handles); the token scrub in the finally must run
        # regardless — a skipped scrub leaks this session's minted secret
        # into the process-global Config and every later init(address=...)
        # fails its MAC checks (the order-sensitive start-CLI flake).
        try:
            for d in list(self.daemons):
                try:
                    self.host.call(d.stop())
                except Exception:
                    pass
            self.daemons.clear()
            try:
                self.host.call(self.controller.stop())
            except Exception:
                pass
            self.host.stop()
        finally:
            if self._token_file:
                # In the finally: a raising teardown must not leave the
                # dead session's secret file at its predictable path (a
                # later driver would discover the dead token from it).
                try:
                    os.unlink(self._token_file)
                except OSError:
                    pass
                self._token_file = None
            if self in _LIVE_CLUSTERS:
                _LIVE_CLUSTERS.remove(self)
            # Hand the scrub duty to a later-created Cluster ONLY if it
            # actually shares this session's token (it adopted ours from the
            # shared config). Handing it to an arbitrary survivor — as the
            # old `_LIVE_CLUSTERS[0]` did — parked the duty on unrelated
            # (possibly stale) records that never scrub.
            sharers = [c for c in _LIVE_CLUSTERS if c._session_token == self._session_token]
            if self._minted_token and sharers:
                sharers[0]._minted_token = True
                self._minted_token = False
            if self._minted_token:
                # Restore whatever the environment pins (usually ""): a later
                # init(address=...) in this process must fall through to the
                # session-token-file / RAYTPU_AUTH_TOKEN discovery path instead
                # of reusing this dead session's secret. Scrub the rpc-module
                # copy too — the direct-Cluster path (no api.shutdown) must not
                # keep MAC-tagging frames with the dead secret — UNLESS a
                # genuinely-live (thread running) other Cluster still needs
                # the process-wide frame key for its own session.
                from ray_tpu_torch.core import rpc as _rpc

                self.config.auth_token = type(self.config)().apply_env().auth_token
                others_alive = any(
                    getattr(getattr(c, "host", None), "thread", None) is not None
                    and c.host.thread.is_alive()
                    for c in _LIVE_CLUSTERS
                )
                if not self.config.auth_token and not others_alive:
                    _rpc.set_auth_token(None)
                self._minted_token = False
            _disarm_profiler_if_idle()


def init(
    address: str | None = None,
    num_cpus: float | None = None,
    resources: dict | None = None,
    labels: dict | None = None,
    object_store_memory: int | None = None,
    config: Config | None = None,
    log_to_driver: bool = True,
    node_ip: str | None = None,
) -> dict:
    """Start (or connect to) a cluster and create the driver's CoreWorker.

    node_ip: the routable IP THIS process binds/advertises for its reply
    server. A driver on a different host than the cluster must set it (or
    RAYTPU_NODE_IP) — with the loopback default, remote workers could not
    dial results/objects back.
    """
    global _global_worker, _global_cluster
    if _global_worker is not None:
        return {"address": _global_worker.controller_addr}
    cfg = config or get_config()
    if node_ip:
        cfg.node_ip = node_ip
    if address is not None:
        # Stale auto-minted secret from a dead in-process session (a scrub
        # was skipped somewhere): connecting to an external cluster with it
        # would fail every MAC check. Drop it and rediscover below.
        _drop_stale_minted_token(cfg)
    if not cfg.auth_token and address is not None:
        # Same-host driver joining an auto-tokened cluster: pick the session
        # token up from the head's token file (multi-host joins pass
        # RAYTPU_AUTH_TOKEN explicitly). Trust the file ONLY if it is ours
        # and private — an attacker-planted token would let them MITM the
        # session (we'd authenticate to their endpoint).
        try:
            fd = os.open(
                _session_token_path(address),
                os.O_RDONLY | getattr(os, "O_NOFOLLOW", 0),
            )
            try:
                st = os.fstat(fd)
                if st.st_uid == os.getuid() and not (st.st_mode & 0o077):
                    cfg.auth_token = os.read(fd, 256).decode().strip()
            finally:
                os.close(fd)
        except OSError:
            pass
    if cfg.auth_token:  # external driver joining an authed cluster
        from ray_tpu_torch.core import rpc as _rpc

        _rpc.set_auth_token(cfg.auth_token)
    from ray_tpu_torch.core import rpc as _rpc_t

    _rpc_t.apply_transport_config(cfg)
    if address is None:
        _global_cluster = Cluster(
            initialize_head=True,
            head_node_args={
                "num_cpus": num_cpus,
                "resources": resources,
                "labels": labels,
                "object_store_memory": object_store_memory,
            },
            config=cfg,
        )
        address = _global_cluster.address
    worker = CoreWorker(mode="driver", controller_addr=address, config=cfg)
    worker.start_driver_sync()
    if log_to_driver:
        _subscribe_driver_logs(worker)
    _global_worker = worker
    atexit.register(shutdown)
    return {"address": address}


def _subscribe_driver_logs(worker: CoreWorker):
    """Print worker stdout/stderr on the driver, prefixed by the producing
    worker/node (reference UX: log_monitor lines surface on the driver
    terminal with a (pid=..., ip=...) prefix)."""
    import sys

    def _print_logs(_key, data):
        prefix = f"({data.get('worker_id', '')[:8]}, node={data.get('node_id', '')[:8]})"
        stream = sys.stderr if data.get("stream") == "stderr" else sys.stdout
        for line in data.get("lines", ()):
            print(f"{prefix} {line}", file=stream, flush=True)

    worker._run(worker.subscribe_channel("logs", _print_logs))


def init_cluster(cluster: Cluster) -> dict:
    """Connect the driver to an existing in-process Cluster (tests)."""
    return init(address=cluster.address)


def _disarm_profiler_if_idle():
    """Stop this process's continuous profiler once no session is left in it
    (no driver worker, no live in-process cluster). The core worker and the
    node daemon arm it; left armed after shutdown, its 19 Hz walk of every
    thread's frames keeps finished frames' locals alive a little longer, and
    a driver that goes on to train on the GPU measured a higher peak (a
    4-layer Gemma-2B step ran out of memory on an 80 GB card)."""
    if _global_worker is None and not _LIVE_CLUSTERS:
        from ray_tpu_torch.obs import profiler as _profiler

        _profiler.disarm()


def shutdown():
    global _global_worker, _global_cluster
    try:
        if _global_worker is not None:
            _global_worker.shutdown_sync()
    finally:
        # A raising worker teardown must not skip the cluster shutdown (and
        # with it the minted-token scrub) — that exact skip leaked session
        # secrets into later inits at full-suite load. Nested finally: a
        # raising CLUSTER teardown must equally not skip the config/rpc
        # restore below.
        _global_worker = None
        try:
            if _global_cluster is not None:
                _global_cluster.shutdown()
        finally:
            _global_cluster = None
            # The session token must not leak into a later session in this
            # process, whether it was MINTED by an in-process cluster
            # (scrubbed above) or DISCOVERED by an address-connected driver
            # (session token file / head handshake wrote it into the global
            # Config): restore whatever the environment pins (usually
            # empty) and drop the rpc module's key. EXCEPTION: a still-live
            # direct Cluster sharing the token keeps it — detaching a
            # driver must not pull the key out from under a serving
            # cluster's workers.
            from ray_tpu_torch.core import rpc as _rpc

            cfg = get_config()
            if not (cfg.auth_token and _token_owned_by_live_cluster(cfg.auth_token)):
                cfg.auth_token = type(cfg)().apply_env().auth_token
                if cfg.auth_token:
                    _rpc.set_auth_token(cfg.auth_token)
                else:
                    _rpc.set_auth_token(None)
            _disarm_profiler_if_idle()


def is_initialized() -> bool:
    return _global_worker is not None


def _set_global_worker(worker: CoreWorker):
    global _global_worker
    _global_worker = worker


def _require_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch not initialized; call ray_tpu_torch.init() first")
    return _global_worker


def remote(*args, **kwargs):
    """@remote decorator for functions and classes."""

    def wrap(obj):
        if inspect.isclass(obj):
            opts = ActorOptions()
            from ray_tpu_torch.core.remote_function import _apply_options

            return ActorClass(obj, _apply_options(opts, kwargs))
        opts = TaskOptions()
        from ray_tpu_torch.core.remote_function import _apply_options

        return RemoteFunction(obj, _apply_options(opts, kwargs))

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return wrap


def get(refs, timeout: float | None = None):
    return _require_worker().get_sync(refs, timeout=timeout)


async def get_async(ref: ObjectRef):
    core = _require_worker()
    fut = asyncio.run_coroutine_threadsafe(core._get_many([ref]), core.loop)
    result = await asyncio.wrap_future(fut)
    return result[0]


def put(value) -> ObjectRef:
    return _require_worker().put_sync(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1, timeout: float | None = None):
    return _require_worker().wait_sync(list(refs), num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _require_worker().kill_actor_sync(actor._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    core = _require_worker()
    info = core._run(core.controller.call("get_actor", {"name": name, "namespace": namespace}))
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"no live actor named {name!r} in namespace {namespace!r}")
    aid = ActorID(info["actor_id"])
    core._actor_conns.setdefault(aid, {"addr": info["worker_addr"], "conn": None, "seq": 0})
    return ActorHandle(aid, ActorOptions())


def list_named_actors(namespace: str | None = None) -> list[dict]:
    core = _require_worker()
    return core._run(core.controller.call("list_named_actors", {"namespace": namespace}))


def profile_worker(worker_addr: str, duration_s: float = 2.0) -> dict:
    """On-demand CPU profile of a running worker (stack sampling; reference:
    the dashboard reporter's py-spy endpoint). Shared by the dashboard's
    /api/profile and the `ray_tpu_torch profile` CLI."""
    core = _require_worker()

    async def go():
        conn = await core._peer_conn(worker_addr)
        return await conn.call(
            "profile_cpu", {"duration_s": duration_s}, timeout=duration_s + 30
        )

    return core._run(go())


def cluster_resources() -> dict:
    state = _cluster_state()
    total: dict = {}
    for n in state["nodes"].values():
        if n["state"] == "ALIVE":
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0) + v
    return total


def available_resources() -> dict:
    state = _cluster_state()
    total: dict = {}
    for n in state["nodes"].values():
        if n["state"] == "ALIVE":
            for k, v in n["resources_available"].items():
                total[k] = total.get(k, 0) + v
    return total


def nodes() -> list[dict]:
    state = _cluster_state()
    return [{"NodeID": nid, **info} for nid, info in state["nodes"].items()]


def _cluster_state() -> dict:
    core = _require_worker()
    return core._run(core.controller.call("get_cluster_state", {}))


def timeline() -> list[dict]:
    """Cluster-wide control events + task events (aggregated across all
    workers via the controller — see ray_tpu_torch.util.tracing for chrome-trace
    export of the same stream)."""
    from ray_tpu_torch.util.tracing import get_task_events

    core = _require_worker()
    events = core._run(core.controller.call("get_events", {}))
    return events + get_task_events()


class RuntimeContext:
    def __init__(self, core: CoreWorker):
        self._core = core

    @property
    def job_id(self):
        return self._core.job_id

    @property
    def node_id(self):
        return self._core.node_id

    @property
    def worker_id(self):
        return self._core.worker_id

    def get_actor_id(self):
        rt = self._core._actor_runtime
        return rt.spec.actor_id.hex() if rt else None

    def current_actor_name(self):
        rt = self._core._actor_runtime
        return rt.spec.name if rt else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_require_worker())
