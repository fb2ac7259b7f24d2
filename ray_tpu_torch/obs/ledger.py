"""Run ledger: the diffable REPORT artifact of a day-in-the-life replay.

One run produces a lot of exhaust — per-request outcomes from the replayer,
SLO burn trajectories, shed/expired/swap counters, autoscaler decisions,
autopsy hop shares, the chaos injection log, the timeline action log. This
module folds all of it into ONE canonical JSON document so that:

* ``raytpu report render LEDGER`` prints the run like a post-mortem page;
* ``raytpu report diff OLD NEW --thresholds '{...}'`` compares two ledgers
  per class x phase and exits nonzero on a regression (the CI gate: commit
  a baseline ledger, diff every candidate against it);
* :func:`gate` judges a single ledger against absolute floors (storm-phase
  interactive p99/goodput, weight-swap blip, burn trajectory present for
  every objective) — the scenario asserts this before declaring success.

The document is canonical JSON (sorted keys) so ledgers diff cleanly in
git too. Everything here is offline — no cluster connection; the scenario
hands ``build()`` data it already collected.
"""
from __future__ import annotations

import json
from typing import Optional

FORMAT = "raytpu-report"
VERSION = 1

# diff() knobs: a metric regresses only when it moves by BOTH the relative
# and the absolute margin (tiny absolute wiggles on a fast baseline are not
# regressions; neither is a big relative move measured in microseconds).
DEFAULT_THRESHOLDS = {
    "p99_latency_pct": 25.0,     # p99 may grow this % over baseline...
    "p99_latency_abs_s": 0.05,   # ...and must also grow this many seconds
    "ttft_p95_pct": 30.0,
    "ttft_p95_abs_s": 0.05,
    "goodput_drop": 0.05,        # absolute goodput-fraction drop allowed
}

# gate() floors for the quick-mode day_in_the_life run.
DEFAULT_GATES = {
    "interactive_storm_p99_s": 1.5,     # protected class stays interactive
    "interactive_storm_goodput": 0.5,   # even mid-storm
    "swap_blip_errors_max": 10,         # weight swap must not error-storm
    "require_swap": True,               # the mid-run publication happened
    "require_burn_history": True,       # trajectory for every objective
}


def build(*, meta: dict, spans: dict, load: dict, slo: Optional[dict] = None,
          counters: Optional[dict] = None, autoscaler: Optional[dict] = None,
          autopsy: Optional[dict] = None, chaos: Optional[dict] = None,
          timeline: Optional[list] = None) -> dict:
    """Assemble the REPORT document. ``load`` is the replayer's
    ``summarize()`` output (total + per class x tenant x phase buckets);
    ``slo`` carries {"status": rows, "history": name->trajectory};
    ``counters`` are run DELTAS of the relevant process-global counters
    (shed/expired/swaps/injections), not absolute values."""
    return {
        "format": FORMAT, "version": VERSION,
        "meta": dict(meta),
        "phases": {name: [lo, hi] for name, (lo, hi) in spans.items()},
        "load": load,
        "slo": slo or {"status": [], "history": {}},
        "counters": dict(counters or {}),
        "autoscaler": autoscaler or {"decisions": [], "dropped": 0},
        "autopsy": autopsy or {},
        "chaos": chaos or {"injections": [], "count": 0},
        "timeline": list(timeline or []),
    }


def save(path: str, ledger: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(ledger, f, sort_keys=True, indent=1)
        f.write("\n")


def load(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a {FORMAT} document")
    if int(doc.get("version", -1)) > VERSION:
        raise ValueError(f"report version {doc.get('version')} is newer than "
                         f"this reader (max {VERSION})")
    return doc


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------

def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}{unit}"
    return f"{v}{unit}"


def render(ledger: dict) -> str:
    """Human-readable post-mortem of one run."""
    out = []
    m = ledger.get("meta", {})
    out.append(f"== {FORMAT} v{ledger.get('version')} :: "
               f"{m.get('scenario', '?')} seed={m.get('seed')} "
               f"warp={m.get('time_warp')} requests={m.get('requests')}")
    if m.get("trace_sha256"):
        out.append(f"   trace sha256 {m['trace_sha256'][:16]}…")
    out.append("-- phases (trace seconds)")
    for name, (lo, hi) in sorted(ledger.get("phases", {}).items(),
                                 key=lambda kv: kv[1][0]):
        out.append(f"   {name:<10} [{lo:7.2f}, {hi:7.2f})")
    load_doc = ledger.get("load", {})
    tot = load_doc.get("total", {})
    out.append(f"-- load: n={tot.get('n')} goodput={_fmt(tot.get('goodput'))} "
               f"shed={tot.get('shed')} expired={tot.get('expired')} "
               f"errors={tot.get('errors')} "
               f"client_dropped={tot.get('client_dropped')}")
    hdr = f"   {'class/phase':<24}{'n':>6}{'good':>7}{'shed':>6}{'exp':>5}" \
          f"{'err':>5}{'p50':>8}{'p99':>8}{'ttft95':>8}"
    out.append(hdr)
    for cls, entry in sorted(load_doc.get("classes", {}).items()):
        rows = [("_total", entry.get("_total", {}))]
        rows += sorted(entry.get("phases", {}).items())
        for label, b in rows:
            out.append(f"   {cls + '/' + label:<24}{b.get('n', 0):>6}"
                       f"{_fmt(b.get('goodput')):>7}{b.get('shed', 0):>6}"
                       f"{b.get('expired', 0):>5}{b.get('errors', 0):>5}"
                       f"{_fmt(b.get('p50_s')):>8}{_fmt(b.get('p99_s')):>8}"
                       f"{_fmt(b.get('ttft_p95_s')):>8}")
    slo_doc = ledger.get("slo", {})
    if slo_doc.get("status"):
        out.append("-- slo")
        for row in slo_doc["status"]:
            name = row.get("objective", {}).get("name", "?")
            pts = slo_doc.get("history", {}).get(name, {}).get("points", [])
            peak = max((p["burn_fast"] for p in pts
                        if p.get("burn_fast") is not None), default=None)
            out.append(f"   {name:<24} state={row.get('state'):<8} "
                       f"alerts={row.get('alerts_fired')} "
                       f"burn_fast={_fmt(row.get('burn_fast'))} "
                       f"peak_fast={_fmt(peak)} trajectory={len(pts)}pts")
    if ledger.get("counters"):
        out.append("-- counter deltas")
        for k, v in sorted(ledger["counters"].items()):
            out.append(f"   {k:<44}{_fmt(v):>10}")
    dec = ledger.get("autoscaler", {})
    out.append(f"-- autoscaler: {len(dec.get('decisions', []))} decisions "
               f"({dec.get('dropped', 0)} dropped)")
    out.append(f"-- chaos: {ledger.get('chaos', {}).get('count', 0)} "
               f"injections recorded")
    for e in ledger.get("timeline", []):
        out.append(f"   timeline t={e.get('t'):.2f} {e.get('action'):<20} "
                   f"ok={e.get('ok')} late={_fmt(e.get('late_s'), 's')}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# diff: two ledgers -> regressions
# ---------------------------------------------------------------------------

def _buckets(ledger: dict):
    """Yield (label, bucket) for every comparable stat bucket: the grand
    total, each class total, and each class x phase."""
    load_doc = ledger.get("load", {})
    if load_doc.get("total"):
        yield "total", load_doc["total"]
    for cls, entry in sorted(load_doc.get("classes", {}).items()):
        if entry.get("_total"):
            yield cls, entry["_total"]
        for phase, b in sorted(entry.get("phases", {}).items()):
            yield f"{cls}/{phase}", b


def diff(old: dict, new: dict, thresholds: Optional[dict] = None) -> dict:
    """Compare ``new`` against the ``old`` baseline bucket-by-bucket.
    Returns {"ok", "regressions": [...], "compared": n}; a regression names
    the bucket, metric, both values, and the margin it blew through."""
    th = dict(DEFAULT_THRESHOLDS)
    th.update(thresholds or {})
    old_b = dict(_buckets(old))
    regressions = []
    compared = 0

    def worse_latency(metric, pct_key, abs_key, label, ob, nb):
        ov, nv = ob.get(metric), nb.get(metric)
        if ov is None or nv is None:
            return
        grew = nv - ov
        if grew > ov * th[pct_key] / 100.0 and grew > th[abs_key]:
            regressions.append({
                "bucket": label, "metric": metric, "old": ov, "new": nv,
                "margin": f">{th[pct_key]}% and >{th[abs_key]}s over baseline",
            })

    for label, nb in _buckets(new):
        ob = old_b.get(label)
        if ob is None:
            continue
        compared += 1
        worse_latency("p99_s", "p99_latency_pct", "p99_latency_abs_s",
                      label, ob, nb)
        worse_latency("ttft_p95_s", "ttft_p95_pct", "ttft_p95_abs_s",
                      label, ob, nb)
        og, ng = ob.get("goodput"), nb.get("goodput")
        if og is not None and ng is not None and og - ng > th["goodput_drop"]:
            regressions.append({
                "bucket": label, "metric": "goodput", "old": og, "new": ng,
                "margin": f">{th['goodput_drop']} absolute drop",
            })
    return {"ok": not regressions, "compared": compared,
            "thresholds": th, "regressions": regressions}


# ---------------------------------------------------------------------------
# gate: absolute floors for one ledger
# ---------------------------------------------------------------------------

def gate(ledger: dict, gates: Optional[dict] = None) -> dict:
    """Judge one ledger on its own (no baseline): the run-level invariants
    the day_in_the_life scenario promises. Returns {"ok", "checks": [...]}."""
    g = dict(DEFAULT_GATES)
    g.update(gates or {})
    checks = []

    def check(name, ok, detail):
        checks.append({"name": name, "ok": bool(ok), "detail": detail})

    storm = (ledger.get("load", {}).get("classes", {})
             .get("interactive", {}).get("phases", {}).get("storm"))
    if storm is None:
        check("interactive_storm_present", False,
              "no interactive/storm bucket in the ledger")
    else:
        p99 = storm.get("p99_s")
        check("interactive_storm_p99",
              p99 is not None and p99 <= g["interactive_storm_p99_s"],
              f"p99={p99} (floor {g['interactive_storm_p99_s']}s)")
        gp = storm.get("goodput")
        check("interactive_storm_goodput",
              gp is not None and gp >= g["interactive_storm_goodput"],
              f"goodput={gp} (floor {g['interactive_storm_goodput']})")
    if g.get("require_swap"):
        swaps = ledger.get("counters", {}).get("ckpt.publish.swaps_total", 0)
        check("weight_swap_happened", swaps >= 1, f"swaps_total delta={swaps}")
        # The blip: a hot swap may slow requests but must not error-storm —
        # count recovery-phase hard errors across every class.
        blip = sum(entry.get("phases", {}).get("recovery", {}).get("errors", 0)
                   for entry in ledger.get("load", {}).get("classes", {}).values())
        check("swap_blip_bounded", blip <= g["swap_blip_errors_max"],
              f"recovery-phase errors={blip} "
              f"(max {g['swap_blip_errors_max']})")
    if g.get("require_burn_history"):
        slo_doc = ledger.get("slo", {})
        names = [row.get("objective", {}).get("name", "?")
                 for row in slo_doc.get("status", [])]
        missing = [n for n in names
                   if not slo_doc.get("history", {}).get(n, {}).get("points")]
        check("burn_trajectory_per_objective",
              bool(names) and not missing,
              f"objectives={names} missing_trajectory={missing}")
    return {"ok": all(c["ok"] for c in checks), "checks": checks}


# ---------------------------------------------------------------------------
# CLI: raytpu report {render,diff,gate}
# ---------------------------------------------------------------------------

def add_report_parser(sub) -> None:
    p = sub.add_parser("report", help="render/diff/gate day-in-the-life run ledgers")
    rs = p.add_subparsers(dest="report_cmd", required=True)
    pr = rs.add_parser("render", help="print one ledger as a post-mortem page")
    pr.add_argument("ledger")
    pd = rs.add_parser("diff", help="diff a candidate ledger against a baseline "
                                    "(exit 1 on regression)")
    pd.add_argument("baseline")
    pd.add_argument("candidate")
    pd.add_argument("--thresholds", default="",
                    help='JSON overrides, e.g. \'{"p99_latency_pct": 10}\'')
    pg = rs.add_parser("gate", help="judge one ledger against absolute floors "
                                    "(exit 1 on failure)")
    pg.add_argument("ledger")
    pg.add_argument("--gates", default="", help="JSON overrides of the floors")


def cmd_report(args) -> int:
    if args.report_cmd == "render":
        print(render(load(args.ledger)))
        return 0
    if args.report_cmd == "diff":
        th = json.loads(args.thresholds) if args.thresholds else None
        res = diff(load(args.baseline), load(args.candidate), th)
        for r in res["regressions"]:
            print(f"REGRESSION {r['bucket']} {r['metric']}: "
                  f"{r['old']} -> {r['new']} ({r['margin']})")
        print(f"compared {res['compared']} buckets: "
              f"{'OK' if res['ok'] else str(len(res['regressions'])) + ' regression(s)'}")
        return 0 if res["ok"] else 1
    if args.report_cmd == "gate":
        gs = json.loads(args.gates) if args.gates else None
        res = gate(load(args.ledger), gs)
        for c in res["checks"]:
            print(f"{'PASS' if c['ok'] else 'FAIL'} {c['name']}: {c['detail']}")
        return 0 if res["ok"] else 1
    return 2
