"""`ray_tpu_torch start` / `ray_tpu_torch stop` — standalone cluster bootstrap.

Role-equivalent to the reference's `ray start` (python/ray/scripts/
scripts.py:682): turn THIS host into a head node (control plane + one node
daemon) or join an existing cluster by address, as long-lived OS processes —
no shared Python state, which is what makes a real multi-host GPU cluster
deployable (each host runs `start`, drivers connect by address). A node
advertises its cards (``GPU``) and their name as detected by
``accel.gpu.detect_gpu_resources`` unless started with
``--no-gpu-autodetect``.

Process model: `start` (without --block) re-execs itself detached with
--block; the blocking child runs an asyncio loop hosting the Controller (head
only) and a NodeDaemon, writes a state file under the cluster state dir, and
exits cleanly on SIGTERM. `stop` signals every recorded process. The
reference uses the same two-step shape (CLI → detached raylet/gcs binaries).

Token distribution: the head mints a session token (unless one is pinned via
--token / RAYTPU_AUTH_TOKEN) and publishes it (a) to same-host drivers via
the 0600 session-token file keyed by port (api._session_token_path), and
(b) to the operator on stdout as part of the join command — joining hosts
pass it via RAYTPU_AUTH_TOKEN or --token. Every RPC frame is MAC'd with it
(rpc.py), so a wrong/missing token fails loud at the first frame.

The state dir (``RAYTPU_TORCH_STATE_DIR``, default
``$TMPDIR/raytpu-torch-cluster-<uid>``) is this package's own: ``stop``
signals only the processes recorded there, and only while their command line
still names ``ray_tpu_torch``, so it never touches another package's daemons
on the same host.
"""
from __future__ import annotations


import json
import os
import signal
import subprocess
import sys
import tempfile
import time

DEFAULT_PORT = 6379
STATE_DIR_ENV = "RAYTPU_TORCH_STATE_DIR"


def state_dir() -> str:
    d = os.environ.get(STATE_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), f"raytpu-torch-cluster-{os.getuid()}"
    )
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def _state_path(pid: int) -> str:
    return os.path.join(state_dir(), f"proc-{pid}.json")


def _record_state(role: str, address: str, node_id: str = "") -> str:
    path = _state_path(os.getpid())
    with open(path, "w") as f:
        json.dump(
            {"pid": os.getpid(), "role": role, "address": address,
             "node_id": node_id, "started_at": time.time()},
            f,
        )
    return path


def head_address() -> str | None:
    """Most recent LIVE head recorded in the state dir (CLI --address
    default). Same liveness rules as stop: the pid must still be a ray_tpu_torch
    process (state files can outlive their process across reboots)."""
    best = None
    for name in os.listdir(state_dir()):
        if not name.startswith("proc-"):
            continue
        try:
            with open(os.path.join(state_dir(), name)) as f:
                st = json.load(f)
        except (OSError, ValueError):
            continue
        pid = st.get("pid")
        if (st.get("role") == "head" and st.get("address") and isinstance(pid, int)
                and _alive(pid) and _is_ours(pid)):
            if best is None or st.get("started_at", 0) > best.get("started_at", 0):
                best = st
    return best["address"] if best else None


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _is_ours(pid: int) -> bool:
    """Refuse to signal a recycled pid: the target must still be a ray_tpu_torch
    process (state files can outlive their process across reboots)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"ray_tpu_torch" in f.read()
    except OSError:
        return False


# ---------------------------------------------------------------------------
# blocking (child) mode: actually run the services
# ---------------------------------------------------------------------------

def _run_blocking(args) -> int:
    import asyncio

    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.api import _write_session_token_file
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.node import NodeDaemon

    cfg = Config().apply_env()
    if args.node_ip:
        cfg.node_ip = args.node_ip
    token = args.token or os.environ.get("RAYTPU_AUTH_TOKEN") or cfg.auth_token
    is_head = bool(args.head)
    if is_head and not token and os.environ.get("RAYTPU_AUTO_TOKEN", "1") != "0":
        import secrets

        token = secrets.token_hex(16)
    cfg.auth_token = token
    if token:
        rpc.set_auth_token(token)

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    labels = json.loads(args.labels) if args.labels else {}

    async def main() -> int:
        loop = asyncio.get_running_loop()
        stop_ev = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop_ev.set)

        controller = None
        token_file = None
        if is_head:
            from ray_tpu_torch.core.controller import Controller

            controller = Controller(cfg, persist_path=args.persist or None)
            addr = await controller.start(args.port)
            if token:
                # Same-host drivers pick the session token up from the 0600
                # token file (api.init does the ownership/mode checks).
                token_file = _write_session_token_file(addr, token)
        else:
            addr = args.address

        daemon = NodeDaemon(
            addr,
            config=cfg,
            resources=resources or None,
            labels=labels or None,
            store_capacity=args.object_store_memory,
            autodetect_accelerators=not args.no_gpu_autodetect,
        )
        await daemon.start()
        _record_state("head" if is_head else "node", addr, daemon.node_id)
        if args.address_file:
            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(addr)
            os.replace(tmp, args.address_file)  # atomic: readers never see a partial write
        print(f"ray_tpu_torch {'head' if is_head else 'node'} up: address={addr} "
              f"node_id={daemon.node_id[:12]}", flush=True)

        await stop_ev.wait()
        try:
            await daemon.stop()
        finally:
            if controller is not None:
                await controller.stop()
            if token_file:
                try:
                    os.unlink(token_file)
                except OSError:
                    pass
            try:
                os.unlink(_state_path(os.getpid()))
            except OSError:
                pass
        return 0

    return asyncio.run(main())


# ---------------------------------------------------------------------------
# detaching (parent) mode
# ---------------------------------------------------------------------------

def _child_args(args) -> list[str]:
    """Re-serialize the parsed start options for the --block child. The token
    deliberately rides env, not argv (argv is world-readable via ps/procfs)."""
    out = []
    if args.head:
        out.append("--head")
    if args.address:
        out.append(f"--address={args.address}")
    out += ["--port", str(args.port)]
    if args.node_ip:
        out += ["--node-ip", args.node_ip]
    if args.num_cpus is not None:
        out += ["--num-cpus", str(args.num_cpus)]
    if args.resources:
        out += ["--resources", args.resources]
    if args.labels:
        out += ["--labels", args.labels]
    if args.object_store_memory:
        out += ["--object-store-memory", str(args.object_store_memory)]
    if args.no_gpu_autodetect:
        out.append("--no-gpu-autodetect")
    if args.persist:
        out += ["--persist", args.persist]
    return out


def _spawn_detached(args) -> int:
    """Re-exec `start ... --block` as a detached session leader, wait for it
    to come up (address file), print the join/connect instructions."""
    addr_file = args.address_file or os.path.join(
        state_dir(), f"address-{os.getpid()}-{time.time_ns()}"
    )
    child_argv = [sys.executable, "-m", "ray_tpu_torch", "start", "--block",
                  "--address-file", addr_file] + _child_args(args)
    env = dict(os.environ)
    if args.token:
        env["RAYTPU_AUTH_TOKEN"] = args.token
    log_path = os.path.join(state_dir(), "start.log")
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            child_argv,
            env=env,
            start_new_session=True,  # survives this CLI + its terminal
            stdout=log,
            stderr=log,
        )
    deadline = time.time() + args.startup_timeout
    addr = None
    while time.time() < deadline:
        if os.path.exists(addr_file):
            with open(addr_file) as f:
                addr = f.read().strip()
            if addr:
                break
        if proc.poll() is not None:
            print(f"error: start child exited rc={proc.returncode}; log tail:",
                  file=sys.stderr)
            _tail(log_path)
            return 1
        time.sleep(0.1)
    if not addr:
        print(f"error: node did not come up within {args.startup_timeout}s; log tail:",
              file=sys.stderr)
        _tail(log_path)
        proc.terminate()
        return 1
    if not args.address_file:
        try:
            os.unlink(addr_file)
        except OSError:
            pass
    if args.head:
        print(f"ray_tpu_torch head started (pid {proc.pid}).")
        print(f"  cluster address: {addr}")
        print(f"  connect a driver:  ray_tpu_torch.init(address=\"{addr}\")  "
              f"# same host: token auto-discovered")
        token = args.token or os.environ.get("RAYTPU_AUTH_TOKEN")
        if not token:
            # auto-minted inside the child — read it back from the session
            # token file so we can print a complete join command.
            from ray_tpu_torch.core.api import _session_token_path

            try:
                with open(_session_token_path(addr)) as f:
                    token = f.read().strip()
            except OSError:
                token = None
        if token:
            print("  join another host:")
            print(f"    RAYTPU_AUTH_TOKEN={token} python -m ray_tpu_torch start --address={addr} "
                  f"--node-ip=<that host's IP>")
        print(f"  stop everything on this host:  python -m ray_tpu_torch stop")
    else:
        print(f"ray_tpu_torch node started (pid {proc.pid}), joined {addr}.")
    return 0


def _tail(path: str, n: int = 15):
    try:
        with open(path) as f:
            for line in f.readlines()[-n:]:
                print("  " + line.rstrip(), file=sys.stderr)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# CLI entry points
# ---------------------------------------------------------------------------

def add_start_parser(sub) -> None:
    sp = sub.add_parser("start", help="start a head node or join a cluster")
    sp.add_argument("--head", action="store_true",
                    help="start the control plane on this host")
    sp.add_argument("--address", default=None,
                    help="join the cluster whose head controller is at host:port")
    sp.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help=f"head controller port (default {DEFAULT_PORT}, 0 = random)")
    sp.add_argument("--node-ip", default=None,
                    help="routable IP to bind/advertise (default 127.0.0.1; "
                         "REQUIRED for multi-host)")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--resources", default=None, help='JSON, e.g. \'{"GPU": 4}\'')
    sp.add_argument("--labels", default=None, help="JSON node labels")
    sp.add_argument("--object-store-memory", type=int, default=None)
    sp.add_argument("--token", default=None,
                    help="pin the session auth token (else RAYTPU_AUTH_TOKEN, "
                         "else auto-minted on the head)")
    sp.add_argument("--no-gpu-autodetect", action="store_true",
                    help="don't advertise this host's GPUs and their name")
    sp.add_argument("--persist", default=None,
                    help="head: controller snapshot path (control-plane FT)")
    sp.add_argument("--block", action="store_true",
                    help="run in the foreground (default: detach)")
    sp.add_argument("--address-file", default=None,
                    help="write the node's address here once up")
    sp.add_argument("--startup-timeout", type=float, default=60.0)


def cmd_start(args) -> int:
    if args.head and args.address:
        print("error: pass --head OR --address, not both", file=sys.stderr)
        return 2
    if not args.head and not args.address:
        print("error: pass --head to start a cluster or --address=<head> to join one",
              file=sys.stderr)
        return 2
    if args.block:
        return _run_blocking(args)
    return _spawn_detached(args)


def cmd_stop(args) -> int:
    """Stop every ray_tpu_torch process recorded in the state dir (head + nodes)."""
    d = state_dir()
    stopped = 0
    for name in sorted(os.listdir(d)):
        if not name.startswith("proc-"):
            continue
        path = os.path.join(d, name)
        try:
            with open(path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            continue
        pid = st["pid"]
        if _alive(pid) and _is_ours(pid):
            print(f"stopping {st['role']} pid={pid} ({st['address']})")
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
            deadline = time.time() + args.grace
            while _alive(pid) and time.time() < deadline:
                time.sleep(0.05)
            if _alive(pid):
                print(f"  pid {pid} did not exit in {args.grace}s; SIGKILL")
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            stopped += 1
        try:
            os.unlink(path)
        except OSError:
            pass
    print(f"stopped {stopped} process(es)" if stopped else "nothing to stop")
    return 0


def add_stop_parser(sub) -> None:
    sp = sub.add_parser("stop", help="stop all ray_tpu_torch daemons started on this host")
    sp.add_argument("--grace", type=float, default=10.0,
                    help="seconds to wait for graceful exit before SIGKILL")


# ---------------------------------------------------------------------------
# state CLI: list | summary | memory | status | logs
# (reference: `ray list|summary|memory|status|logs` over python/ray/util/state)
# ---------------------------------------------------------------------------

def _connect_driver(address: str | None):
    """Connect this CLI process as a driver (token auto-discovery included)."""
    import ray_tpu_torch as rt

    addr = address or os.environ.get("RAYTPU_ADDRESS") or head_address()
    if not addr:
        print("error: no --address, RAYTPU_ADDRESS unset, and no local head "
              "(start one: python -m ray_tpu_torch start --head)", file=sys.stderr)
        sys.exit(2)
    rt.init(address=addr, log_to_driver=False)
    return rt


def _rows(title: str, header: list, rows: list, note: str = ""):
    print(f"== {title} ==")
    if not rows:
        print("  (none)")
    else:
        widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
        for r in [header] + rows:
            print("  " + "  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    if note:
        print(f"  {note}")


def _trunc_note(out: dict, shown: int) -> str:
    bits = []
    if out.get("truncated"):
        bits.append(f"showing {shown} of {out['total']} (use --limit)")
    if out.get("evicted"):
        bits.append(f"{out['evicted']} older records evicted from the bounded index")
    return "; ".join(bits)


def _task_duration(record: dict) -> str:
    """RUNNING->end wall time from the per-state timestamps, best effort."""
    times = record.get("times", {})
    start = times.get("RUNNING")
    end = times.get("exec_end") or times.get("FINISHED") or times.get("FAILED")
    if start is None:
        return "-"
    if end is None:
        return f"{max(0.0, time.time() - start):.1f}s+"
    return f"{max(0.0, end - start):.3f}s"


def cmd_list(args) -> None:
    _connect_driver(args.address)
    from ray_tpu_torch import state
    from ray_tpu_torch.core import api

    kind = args.kind
    if kind == "tasks":
        out = state.list_tasks(state=args.state, node=args.node, fn=args.fn,
                               job=args.job, limit=args.limit)
        rows = [
            # Full task id: TaskIDs are process-prefix + counter, so a short
            # prefix is identical for every task one submitter minted.
            [t["task_id"], t["attempt"], t.get("state", "?"),
             (t.get("fn") or "-")[:32],
             (t.get("node_id") or "-")[:12], (t.get("worker_id") or "-")[:12],
             _task_duration(t), t.get("error_type", "")]
            for t in out["tasks"]
        ]
        _rows("tasks", ["task_id", "att", "state", "fn", "node", "worker", "dur", "error"],
              rows, note=_trunc_note(out, len(rows)))
    elif kind == "actors":
        out = state.list_actors(state=args.state, node=args.node, name=args.fn,
                                job=args.job, limit=args.limit)
        rows = [
            [a["actor_id"][:12], a["state"], a["name"] or "-",
             (a.get("node_id") or "-")[:12], (a.get("worker_id") or "-")[:12],
             a["restarts"], (a.get("death_cause") or "")[:40]]
            for a in out["actors"]
        ]
        _rows("actors", ["actor_id", "state", "name", "node", "worker", "restarts", "death_cause"],
              rows, note=_trunc_note(out, len(rows)))
    elif kind == "objects":
        out = state.list_objects(node=args.node, limit=args.limit)
        rows = [
            [o["oid"][:16], o["size"], ",".join(n[:12] for n in o["locations"])]
            for o in out["objects"]
        ]
        _rows("objects (shared/shm directory)", ["object_id", "bytes", "nodes"], rows,
              note=_trunc_note(out, len(rows)) or f"{out['total']} objects, {out['total_bytes'] / 1e6:.1f} MB total")
    elif kind == "nodes":
        out = state.list_nodes(state=args.state, limit=args.limit)
        rows = []
        for n in out["nodes"]:
            store = n.get("store") or {}
            occ = (f"{store.get('used', 0) / 1e6:.1f}/{store.get('capacity', 0) / 1e6:.0f}MB"
                   if store else "-")
            res = " ".join(
                f"{k}:{n['resources_available'].get(k, 0):g}/{v:g}"
                for k, v in sorted(n["resources_total"].items())
            )
            rows.append([n["node_id"][:12],
                         n["state"] + (" (draining)" if n.get("draining") else ""),
                         n["address"], res, occ, n.get("workers", 0)])
        _rows("nodes", ["node_id", "state", "address", "avail/total", "store", "workers"],
              rows, note=_trunc_note(out, len(rows)))
    elif kind == "workers":
        out = state.list_workers(state=args.state, node=args.node, limit=args.limit)
        rows = [
            [w["worker_id"][:12], w["node_id"][:12], w["state"], w["address"], w["actors"]]
            for w in out["workers"]
        ]
        _rows("workers", ["worker_id", "node", "state", "address", "actors"],
              rows, note=_trunc_note(out, len(rows)))
    elif kind == "pgs":
        s = api._cluster_state()
        _rows("placement groups", ["pg_id", "state", "strategy", "bundles"], [
            [pid[:12], g["state"], g["strategy"], len(g["bundles"])]
            for pid, g in s["placement_groups"].items()
        ])
    elif kind == "jobs":
        from ray_tpu_torch.job import JobSubmissionClient

        _rows("jobs", ["job_id", "status", "entrypoint"], [
            [j["job_id"], j["status"], j["entrypoint"][:48]]
            for j in JobSubmissionClient().list_jobs()
        ])
    elif kind == "replicas":
        # Scale-plane view (serve controller): one row per replica plus a
        # per-deployment summary line with the last autoscale decision.
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

        try:
            ctl = rt.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        except ValueError:
            print("serve controller not running")
            return
        st = rt.get(ctl.get_serve_state.remote(), timeout=30)
        rows = []
        notes = []
        for app, deps in sorted(st.get("apps", {}).items()):
            for dname, d in sorted(deps.items()):
                for rep in d["replicas"]:
                    ongoing = rep.get("ongoing")
                    rows.append([app, dname, rep["name"],
                                 "-" if ongoing is None else f"{ongoing:g}",
                                 d["target"], d["status"]])
                if not d["replicas"]:
                    rows.append([app, dname, "-", "-", d["target"], d["status"]])
                last = (d.get("decisions") or [{}])[-1]
                if last.get("action"):
                    notes.append(
                        f"{app}/{dname}: last decision {last['action']}"
                        f"{'' if last.get('applied') else ' (suppressed)'} "
                        f"-> {last.get('to')} ({last.get('reason')})"
                        + (f"; unmet={d['unmet_replicas']}" if d.get("unmet_replicas") else "")
                    )
        _rows("serve replicas", ["app", "deployment", "replica", "ongoing", "target", "status"],
              rows, note="; ".join(notes))
    elif kind == "checkpoints":
        # --fn filters by publication channel; --state by committed/aborted.
        out = state.list_checkpoints(channel=args.fn, status=args.state,
                                     limit=args.limit)
        rows = [
            [c["ckpt_id"], c.get("step", "-"), c.get("channel") or "-",
             c.get("status", "?"), f"{c.get('bytes_total', 0) / 1e6:.1f}",
             f"{c.get('dedup_ratio', 0.0) * 100:.0f}%", c.get("workers", 1)]
            for c in out["checkpoints"]
        ]
        live = " ".join(f"{ch}->{cid}" for ch, cid in sorted(out.get("channels", {}).items()))
        _rows("checkpoints", ["ckpt_id", "step", "channel", "status", "MB", "dedup", "workers"],
              rows, note=_trunc_note(out, len(rows)) or (f"live: {live}" if live else ""))


def cmd_summary(args) -> None:
    _connect_driver(args.address)
    from ray_tpu_torch import state
    from ray_tpu_torch.core import task_state as ts

    out = state.summary_tasks(job=args.job)
    states = list(ts.STATES)
    rows = []
    for fn, ent in sorted(out["summary"].items(), key=lambda kv: -kv[1]["total"]):
        rows.append([fn[:40], ent["total"]] + [ent["states"].get(s, 0) for s in states])
    _rows("task summary (by function)", ["fn", "total"] + states, rows,
          note=(f"{out['total_tasks']} indexed task attempts"
                + (f"; {out['evicted']} evicted from the bounded index" if out["evicted"] else "")))


def cmd_memory(args) -> None:
    _connect_driver(args.address)
    from ray_tpu_torch import state

    out = state.memory_summary(limit=args.limit)

    def render_worker(w: dict, indent: str = "  "):
        if "error" in w:
            print(f"{indent}worker {w.get('worker_id', '?')[:12]}: error: {w['error']}")
            return
        who = w["worker_id"][:12]
        if w.get("actor_name") or w.get("actor_id"):
            who += f" (actor {w.get('actor_name') or w['actor_id'][:12]})"
        q = w.get("queued", {})
        print(f"{indent}worker {who}  owned={w['owned_total']} borrowed={w['borrowed_total']} "
              f"memstore={w['memory_store_objects']} lineage={w['lineage']['tasks']}"
              f"/{w['lineage']['bytes']}B queued={q.get('submitter', 0)}+{q.get('actor_pump', 0)}")
        for o in w.get("owned", []):
            if args.all or o["borrowers"] > 0 or o["size"] >= 1024:
                print(f"{indent}  owns {o['oid'][:16]}  {o['size']}B {o['where']} "
                      f"state={o['state']} local_refs={o['local_refs']} borrowers={o['borrowers']}")
        if w.get("owned_truncated"):
            print(f"{indent}  ... {w['owned_truncated']} more owned (use --limit)")
        for b in w.get("borrowed", []):
            print(f"{indent}  borrows {b['oid'][:16]}  from {b['owner_addr']} refs={b['refs']}")
        if w.get("borrowed_truncated"):
            print(f"{indent}  ... {w['borrowed_truncated']} more borrowed (use --limit)")

    for node in out.get("nodes", []):
        store = node.get("store", {})
        print(f"node {node.get('node_id', '?')[:12]}  store "
              f"{store.get('used', 0) / 1e6:.1f}/{store.get('capacity', 0) / 1e6:.0f}MB "
              f"({store.get('num_objects', 0)} objects)")
        for w in node.get("workers", []):
            render_worker(w)
    if "driver" in out:
        print("driver")
        render_worker(out["driver"])


def cmd_status(args) -> None:
    """Cluster resources + pending demand (reference: `ray status` — node
    table from GCS + autoscaler ClusterResourceState demand)."""
    _connect_driver(args.address)
    from ray_tpu_torch import state
    from ray_tpu_torch.core import api

    core = api._require_worker()
    s = api._cluster_state()
    auto = core._run(core.controller.call("get_autoscaler_state", {}))
    nodes = s["nodes"]
    alive = [n for n in nodes.values() if n["state"] == "ALIVE"]
    print(f"nodes: {len(alive)} alive / {len(nodes)} total")
    total: dict = {}
    avail: dict = {}
    for n in alive:
        for k, v in n["resources_total"].items():
            total[k] = total.get(k, 0) + v
        for k, v in n["resources_available"].items():
            avail[k] = avail.get(k, 0) + v
    print("resources:")
    for k in sorted(total):
        print(f"  {k}: {total[k] - avail.get(k, 0):g}/{total[k]:g} used")
    stores = [n.get("store") or {} for n in state.list_nodes()["nodes"]]
    used = sum(st.get("used", 0) for st in stores)
    cap = sum(st.get("capacity", 0) for st in stores)
    print(f"object store: {used / 1e6:.1f}/{cap / 1e6:.0f} MB across "
          f"{len(stores)} node(s); {s['objects']['count']} shared objects "
          f"({s['objects']['bytes'] / 1e6:.1f} MB tracked)")
    print("pending demand:")
    pending = auto.get("pending", [])
    gangs = auto.get("pending_gangs", [])
    if not pending and not gangs:
        print("  (none — no queued leases, actors, or gangs)")
    for item in pending:
        sel = f" selector={item['label_selector']}" if item.get("label_selector") else ""
        print(f"  {item['kind']}: {item['demand']}{sel}")
    for gang in gangs:
        print(f"  gang ({gang['strategy']}): {gang['bundles']}")
    n_alive_actors = sum(1 for a in s["actors"].values() if a["state"] == "ALIVE")
    print(f"actors: {n_alive_actors} alive / {len(s['actors'])} total; "
          f"placement groups: {len(s['placement_groups'])}")
    slo = core._run(core.controller.call("slo_summary", {}))
    if slo.get("total"):
        # One line, worst news first (details: `raytpu slo` / /api/slo).
        alert = ",".join(slo["alert"]) or "-"
        burning = ",".join(slo["burning"]) or "-"
        print(f"slo: {slo['ok']}/{slo['total']} ok; alert: {alert}; burning: {burning}")
    try:
        # One line on the always-on sampler fleet (details: /api/profile
        # ?summary=1 / `raytpu profile`). Best-effort: status must not
        # fail because a daemon is mid-restart.
        prof = core._run(core.controller.call("profile_collect", {"status": 1}))
        agg = prof.get("aggregate") or {}
    except Exception:
        agg = {}
    if agg.get("procs"):
        print(f"profiler: {agg['armed']}/{agg['procs']} armed @ "
              f"{agg.get('hz', 0):g}Hz; buffer {agg.get('occupancy', 0):.0%} "
              f"({agg.get('stacks', 0)} stacks); "
              f"{agg.get('samples_dropped', 0):g} samples dropped")


def cmd_logs(args) -> None:
    """Fetch (and optionally follow) one worker's or actor's logs: the
    backlog comes from the hosting daemon's log files (tail_worker_log),
    live lines from the controller's `logs` pubsub (log_monitor feed)."""
    rt = _connect_driver(args.address)
    from ray_tpu_torch import state
    from ray_tpu_torch.core import api

    core = api._require_worker()
    target = args.target
    worker_id = node_id = ""
    for w in state.list_workers()["workers"]:
        if w["worker_id"].startswith(target):
            worker_id, node_id = w["worker_id"], w["node_id"]
            break
    if not worker_id:
        for a in state.list_actors(limit=1000)["actors"]:
            if a["name"] == target or a["actor_id"].startswith(target):
                worker_id, node_id = a["worker_id"], a["node_id"]
                break
    if not worker_id:
        print(f"error: no worker or actor matching {target!r} "
              f"(see `list workers` / `list actors`)", file=sys.stderr)
        sys.exit(2)
    nodes = {n["node_id"]: n for n in state.list_nodes()["nodes"]
             if n["state"] == "ALIVE"}
    node = nodes.get(node_id)
    # A dead/restarted record loses its node attribution; the log files may
    # still exist on whichever daemon hosted the worker — ask them all.
    candidates = [node] if node is not None else list(nodes.values())
    if not candidates:
        print(f"error: no live node to ask for {worker_id[:12]}'s logs", file=sys.stderr)
        sys.exit(2)

    async def backlog(addr):
        conn = await core._daemon_conn(addr)
        return await conn.call(
            "tail_worker_log", {"worker_id": worker_id, "max_bytes": args.max_bytes}
        )

    tail = {}
    for cand in candidates:
        try:
            tail = core._run(backlog(cand["address"]))
        except Exception:
            continue
        if tail:
            break
    for wid, streams in tail.items():
        for stream in ("stdout", "stderr"):
            for line in streams.get(stream, []):
                print(f"[{stream}] {line}")
    if not args.follow:
        return
    print(f"-- following {worker_id[:12]} (ctrl-c to stop) --", flush=True)

    def on_logs(_key, data):
        if not str(data.get("worker_id", "")).startswith(worker_id[:12]):
            return
        stream = data.get("stream", "stdout")
        for line in data.get("lines", ()):
            print(f"[{stream}] {line}", flush=True)

    core._run(core.subscribe_channel("logs", on_logs))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def add_state_parsers(sub) -> None:
    lp = sub.add_parser("list", help="list tasks/actors/objects/nodes/workers/pgs/jobs/checkpoints/replicas")
    lp.add_argument("kind", choices=["tasks", "actors", "objects", "nodes",
                                     "workers", "pgs", "jobs", "checkpoints",
                                     "replicas"])
    lp.add_argument("--state", default=None,
                    help="filter by FSM state (tasks: RUNNING, FINISHED, ...; "
                         "actors: ALIVE, DEAD, ...; checkpoints: committed, aborted)")
    lp.add_argument("--node", default=None, help="filter by node id prefix")
    lp.add_argument("--fn", default=None,
                    help="filter by function/actor-name substring")
    lp.add_argument("--job", default=None, help="filter by job id prefix")
    lp.add_argument("--limit", type=int, default=100)
    sp = sub.add_parser("summary", help="per-function task rollup")
    sp.add_argument("kind", nargs="?", default="tasks", choices=["tasks"])
    sp.add_argument("--job", default=None)
    mp = sub.add_parser("memory", help="cluster-wide object ownership/reference tables")
    mp.add_argument("--limit", type=int, default=200)
    mp.add_argument("--all", action="store_true",
                    help="print every owned object (default: borrowed/large only)")
    sub.add_parser("status", help="cluster resources + pending demand")
    gp = sub.add_parser("logs", help="fetch/follow a worker's or actor's logs")
    gp.add_argument("target", help="worker id prefix, actor name, or actor id prefix")
    gp.add_argument("-f", "--follow", action="store_true",
                    help="keep streaming new lines via the logs pubsub")
    gp.add_argument("--max-bytes", type=int, default=64 * 1024,
                    help="backlog bytes to fetch per stream")


