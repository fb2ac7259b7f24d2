"""`python -m ray_tpu_torch` — cluster state CLI.

Role-equivalent to the reference's `ray status` / `ray list ...` state CLI
(python/ray/util/state, scripts/): connects to a running cluster by address
(--address or RAYTPU_ADDRESS) and prints tables of nodes/actors/PGs/jobs,
events, metrics, or submits/inspects jobs.
"""
from __future__ import annotations

import argparse
import json
import sys


def _connect(address: str | None):
    from ray_tpu_torch import scripts

    # One connect helper for every CLI subcommand (discovery chain:
    # --address -> RAYTPU_ADDRESS -> live local head).
    return scripts._connect_driver(address)


def cmd_events(args):
    rt = _connect(args.address)
    from ray_tpu_torch.core import api

    core = api._require_worker()
    for e in core._run(core.controller.call("get_events", {"limit": args.limit})):
        print(json.dumps(e, default=str))


def cmd_metrics(args):
    rt = _connect(args.address)
    from ray_tpu_torch.core import api
    from ray_tpu_torch.util.metrics import prometheus_text

    core = api._require_worker()
    series = core._run(core.controller.call("get_metrics", {}))
    print(prometheus_text(series))


def cmd_job(args):
    rt = _connect(args.address)
    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient()
    if args.job_cmd == "submit":
        job_id = client.submit_job(args.entrypoint)
        print(job_id)
        if args.wait:
            print(client.wait_until_finished(job_id))
    elif args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.job_id), end="")
    elif args.job_cmd == "stop":
        print(client.stop_job(args.job_id))


def cmd_timeline(args):
    rt = _connect(args.address)
    from ray_tpu_torch.util.tracing import export_timeline

    n = export_timeline(args.out)
    print(f"wrote {n} trace events to {args.out} (open in chrome://tracing or Perfetto)")


def cmd_dashboard(args):
    rt = _connect(args.address)
    from ray_tpu_torch.dashboard import start_dashboard

    port = start_dashboard(args.port)
    print(f"dashboard at http://127.0.0.1:{port}/ (ctrl-c to stop)")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def cmd_drain(args):
    """Operator drain/undrain (reference: `ray drain-node`): a draining node
    accepts no new work but keeps serving what it runs."""
    rt = _connect(args.address)
    from ray_tpu_torch.core import api

    core = api._require_worker()
    method = "undrain_node" if args.undo else "drain_node"
    reply = core._run(core.controller.call(method, {"node_id": args.node_id}))
    if not reply.get("ok"):
        raise SystemExit(f"{method} failed: {reply}")
    if args.undo:
        print(f"node {args.node_id[:12]} reopened for scheduling")
    else:
        print(
            f"node {args.node_id[:12]} draining "
            f"({'idle — safe to terminate' if reply.get('idle') else 'still running work'})"
        )


def cmd_slo(args):
    """SLO objective status: state, multi-window burn rates, alert counts."""
    rt = _connect(args.address)
    from ray_tpu_torch.core import api

    core = api._require_worker()
    rows = core._run(core.controller.call("slo_status", {}))
    if args.json:
        print(json.dumps(rows, default=str))
        return
    if not rows:
        print("no SLO objectives registered "
              "(serve.register_slo(...) or config slo_spec)")
        return
    for r in rows:
        o = r["objective"]
        scope = "/".join(x for x in (o["app"], o["deployment"], o["cls"], o["tenant"]) if x) or "*"
        bf = "-" if r["burn_fast"] is None else f"{r['burn_fast']:.1f}"
        bs = "-" if r["burn_slow"] is None else f"{r['burn_slow']:.1f}"
        print(f"{o['name']:28s} {r['state']:8s} {o['metric']:12s} scope={scope} "
              f"burn fast={bf} slow={bs} alerts={r['alerts_fired']}")


def cmd_debug(args):
    """Observability debug verbs. `debug dump <worker_addr>` asks one worker
    to write a manual flight-recorder dump and prints where it landed;
    `debug obs <worker_addr>` prints the worker's ground-truth observability
    snapshot (event counters, recorder ring, profiler status) so 'never
    recorded' and 'never flushed' are distinguishable without waiting on
    reporter ticks."""
    rt = _connect(args.address)
    from ray_tpu_torch.core import api

    core = api._require_worker()

    if args.debug_cmd == "obs":
        async def go_obs():
            conn = await core._peer_conn(args.worker_addr)
            return await conn.call(
                "debug_observability", {"tail": args.tail}, timeout=30)

        out = core._run(go_obs())
        fl = out.get("flight", {})
        prof = out.get("profiler", {})
        print(f"worker {out.get('worker_id', '?')}:")
        print(f"  task events: {out.get('task_events_len', 0)} buffered, "
              f"{out.get('events_reported', 0):g} reported, "
              f"{out.get('events_dropped', 0):g} dropped")
        print(f"  flight ring: {fl.get('len', '?')} held, "
              f"{fl.get('events_evicted', 0):g} evicted, "
              f"{fl.get('dumps_written', 0):g} dumps written")
        print(f"  profiler: {'running' if prof.get('running') else 'stopped'} "
              f"({prof.get('samples', 0):g} samples)")
        for ev in out.get("tail", []):
            print(f"  tail: {ev}")
        return

    async def go():
        conn = await core._peer_conn(args.worker_addr)
        return await conn.call("flight_dump", {"reason": args.reason}, timeout=30)

    out = core._run(go())
    if not out.get("path"):
        raise SystemExit(f"dump failed (recorder disabled or dir unwritable): {out}")
    print(f"flight dump: {out['path']}")
    print(f"  ring: {out.get('len', '?')} events held, "
          f"{out.get('events_evicted', 0):g} evicted, "
          f"{out.get('dumps_written', 0):g} dumps written by this process")


def cmd_trace(args):
    """`trace export <trace_id>`: reassemble a FULL trace from every live
    per-process flight recorder plus the controller index — works even after
    the bounded index evicted the trace — and write a Perfetto timeline."""
    rt = _connect(args.address)
    from ray_tpu_torch import obs
    from ray_tpu_torch.util import tracing

    res = obs.collect_flight_trace(args.trace_id)
    events = res.get("events", [])
    if not events:
        if res.get("evicted"):
            raise SystemExit(
                f"trace {args.trace_id} was evicted from the controller index "
                "and no live recorder still holds it (the rings are bounded)")
        raise SystemExit(f"trace {args.trace_id}: no events anywhere — unknown trace id?")
    n = tracing.render_timeline(events, args.out)
    note = " (recovered after index eviction)" if res.get("evicted") else ""
    print(f"wrote {n} events from {res.get('sources', 0)} recorder(s) to {args.out}{note}")
    for err in res.get("errors", []):
        print(f"  warning: {err}")


def _print_fold(fold: dict, args):
    """Human rendering of a (merged) profile fold: header, plane split,
    leaf self-time table."""
    from ray_tpu_torch.obs import profiler as _profiler

    procs = fold.get("procs") or [fold.get("proc", "?")]
    print(f"{fold.get('samples', 0)} samples from {len(procs)} process(es) "
          f"({fold.get('stacks_evicted', 0):g} stacks evicted, "
          f"{fold.get('samples_dropped', 0):g} samples dropped)")
    planes = _profiler.plane_split(fold)
    if planes:
        print("  planes: " + "  ".join(f"{k}={v:.0%}" for k, v in planes))
    for frame, count in _profiler.top_frames(fold, args.top):
        print(f"  {count:6d}  {frame}")
    for err in fold.get("errors") or []:
        print(f"  warning: {err}")


def cmd_profile(args):
    """Continuous-profiling plane front door.

    - `raytpu profile` — merged cluster flamegraph from the always-on
      sampler rings (last --window seconds).
    - `raytpu profile --seconds N` — fresh blocking capture on every proc.
    - `--trace ID` one request's per-trace fold; `--node ID` one node.
    - `raytpu profile render FOLD.json` — offline: fold JSON (from --out
      ... --json or an incident dump's "profile" key) to collapsed-stack
      text (or a d3 tree with --json). Never connects.
    - `raytpu profile IP:PORT` / `--worker IP:PORT` — legacy single-worker
      py-spy-style capture.
    """
    import json as _json

    from ray_tpu_torch.obs import profiler as _profiler

    if args.target == "render":
        if not args.fold_json:
            raise SystemExit("usage: raytpu profile render FOLD.json [--json] [--out F]")
        with open(args.fold_json) as f:
            fold = _json.load(f)
        if "profile" in fold and "stacks" not in fold:
            fold = fold["profile"]  # incident/flight dump wrapper
        text = (_json.dumps(_profiler.to_tree(fold), indent=1) if args.json
                else _profiler.to_collapsed(fold))
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
            print(f"wrote {args.out}")
        else:
            print(text, end="")
        return

    rt = _connect(args.address)
    worker_addr = args.worker or (args.target if ":" in args.target else "")
    if worker_addr:
        from ray_tpu_torch.core.api import profile_worker

        prof = profile_worker(worker_addr, args.duration)
        top = sorted(prof["stacks"].items(), key=lambda kv: -kv[1])[: args.top]
        print(f"{prof['samples']} samples over {prof['duration_s']}s:")
        depth = max(0, args.depth)
        for stack, count in top:
            frames = stack.split(";")
            print(f"  {count:6d}  {frames[-1]}")
            for f in reversed(frames[:-1][-depth:] if depth else []):
                print(f"          ^ {f}")
        return

    from ray_tpu_torch import obs

    fold = obs.profile_cluster(window_s=args.window, seconds=args.seconds,
                               trace_id=args.trace, node_id=args.node)
    if args.out:
        with open(args.out, "w") as f:
            f.write(_json.dumps(fold) if args.json
                    else _profiler.to_collapsed(fold))
        print(f"wrote {args.out}")
        return
    if args.json:
        print(_json.dumps(fold, indent=1))
        return
    _print_fold(fold, args)


def main(argv=None):
    from ray_tpu_torch import scripts

    from ray_tpu_torch.analysis.cli import add_lint_parser, cmd_lint

    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    p.add_argument("--address", default=None, help="controller address host:port")
    sub = p.add_subparsers(dest="cmd", required=True)
    scripts.add_start_parser(sub)
    scripts.add_stop_parser(sub)
    scripts.add_state_parsers(sub)  # list | summary | memory | status | logs
    add_lint_parser(sub)  # pure source-tree pass; never connects
    from ray_tpu_torch.chaos import add_chaos_parser, cmd_chaos

    add_chaos_parser(sub)  # seeded fault-injection scenario runner
    from ray_tpu_torch.obs.ledger import add_report_parser, cmd_report

    add_report_parser(sub)  # offline run-ledger render/diff/gate; never connects
    ep = sub.add_parser("events")
    ep.add_argument("--limit", type=int, default=100)
    sub.add_parser("metrics")
    jp = sub.add_parser("job")
    jsub = jp.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("entrypoint")
    js.add_argument("--wait", action="store_true")
    for name in ("status", "logs", "stop"):
        x = jsub.add_parser(name)
        x.add_argument("job_id")
    tp = sub.add_parser("timeline")
    tp.add_argument("--out", default="timeline.json")
    dp = sub.add_parser("dashboard")
    dp.add_argument("--port", type=int, default=8265)
    dr = sub.add_parser("drain")
    dr.add_argument("node_id")
    dr.add_argument("--undo", action="store_true", help="reopen the node")
    pr = sub.add_parser("profile")
    pr.add_argument("target", nargs="?", default="",
                    help="'render' for offline fold rendering, a worker "
                         "IP:PORT for legacy single-worker capture, or "
                         "omitted for the merged cluster flamegraph")
    pr.add_argument("fold_json", nargs="?", default="",
                    help="fold JSON path (render mode only)")
    pr.add_argument("--seconds", type=float, default=None,
                    help="fresh blocking capture window instead of the ring")
    pr.add_argument("--window", type=float, default=60.0,
                    help="ring lookback seconds (default 60)")
    pr.add_argument("--trace", default="", help="per-trace fold for one request")
    pr.add_argument("--node", default="", help="restrict to one node id prefix")
    pr.add_argument("--worker", default="", help="legacy worker IP:PORT capture")
    pr.add_argument("--json", action="store_true",
                    help="raw fold JSON (render mode: d3 tree JSON)")
    pr.add_argument("--out", default="", help="write instead of printing")
    pr.add_argument("--duration", type=float, default=2.0)
    pr.add_argument("--top", type=int, default=10)
    pr.add_argument("--depth", type=int, default=4)
    sp = sub.add_parser("slo", help="SLO objective status (burn rates, alerts)")
    sp.add_argument("--json", action="store_true", help="raw status rows")
    dbg = sub.add_parser("debug", help="observability debug verbs")
    dsub = dbg.add_subparsers(dest="debug_cmd", required=True)
    dd = dsub.add_parser("dump", help="manual flight-recorder dump of one worker")
    dd.add_argument("worker_addr", help="worker IP:PORT (see `list workers`)")
    dd.add_argument("--reason", default="manual CLI dump")
    do = dsub.add_parser("obs", help="ground-truth observability snapshot of one worker")
    do.add_argument("worker_addr", help="worker IP:PORT (see `list workers`)")
    do.add_argument("--tail", type=int, default=5, help="recent task events to include")
    tr = sub.add_parser("trace", help="trace reassembly from live flight recorders")
    trsub = tr.add_subparsers(dest="trace_cmd", required=True)
    te = trsub.add_parser("export", help="rebuild one trace, write a Perfetto timeline")
    te.add_argument("trace_id")
    te.add_argument("--out", default="trace.json")
    args = p.parse_args(argv)
    if args.cmd == "lint":
        sys.exit(cmd_lint(args))
    if args.cmd == "chaos":
        sys.exit(cmd_chaos(args))
    if args.cmd == "report":
        sys.exit(cmd_report(args))
    if args.cmd == "start":
        sys.exit(scripts.cmd_start(args))
    if args.cmd == "stop":
        sys.exit(scripts.cmd_stop(args))
    {
        "status": scripts.cmd_status,
        "list": scripts.cmd_list,
        "summary": scripts.cmd_summary,
        "memory": scripts.cmd_memory,
        "logs": scripts.cmd_logs,
        "events": cmd_events,
        "metrics": cmd_metrics,
        "job": cmd_job,
        "timeline": cmd_timeline,
        "dashboard": cmd_dashboard,
        "drain": cmd_drain,
        "profile": cmd_profile,
        "slo": cmd_slo,
        "debug": cmd_debug,
        "trace": cmd_trace,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
