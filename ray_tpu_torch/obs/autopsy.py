"""Critical-path autopsy: where did THIS request's wall time actually go.

The trace index answers "what happened" (span slices on a timeline); this
module answers the operator's sharper question — a per-request HOP
decomposition of the serve critical path, derived entirely from events the
tracing/FSM plane already records (zero new instrumentation on the request
path beyond the one `qos.admitted` point event the handle drops on traced
requests):

    proxy     routing + admission control inside the proxy, before the
              handle starts waiting for a replica slot
    admission handle fair-queue wait (the `qos.admitted` event's waited_s)
    dispatch  task submitted -> pushed to a leased worker (scheduler/lease
              queue on the caller side)
    wire      dispatch -> executor picks it up (rpc transit + the worker's
              inbox)
    exec      user code on the replica (the serve.replica.<dep> span)
    drain     reply/stream drain back through the proxy after exec ended

plus ``unattributed`` = total - sum(hops): the residue the decomposition
cannot name (clock skew between processes can make individual hops read
slightly negative; they clamp to 0 and the residue absorbs the skew).

Aggregation inverts the question per deployment: "where does p99 go" —
per-hop totals and shares across every indexed trace of one deployment.
"""
from __future__ import annotations

from typing import Optional

HOPS = ("proxy", "admission", "dispatch", "wire", "exec", "drain")


def _first(events, **match) -> Optional[dict]:
    for ev in events:
        if all(ev.get(k) == v for k, v in match.items()):
            return ev
    return None


def _span_events(events) -> list[dict]:
    return [e for e in events if e.get("kind") == "span"]


def autopsy(events: list[dict]) -> dict:
    """Decompose one trace's events into the serve critical-path hops.

    Tolerant of partial traces (reporter ticks land asynchronously): hops
    whose anchors are missing are omitted rather than guessed, and the
    result names which anchors were found. Events may come from the
    controller trace index, a flight dump, or a live-recorder reassembly —
    any list in the shared event shape works."""
    events = sorted(events, key=lambda e: e.get("ts", 0.0))
    spans = _span_events(events)
    root = None
    for s in spans:
        if s.get("name") == "serve.request":  # graftlint: disable=metric-contract  serve.request is the root SPAN name (tracing.span in serve/replica.py), not a metric series
            root = s
            break
    if root is None and spans:
        # Fall back to the outermost span (earliest start, no parent here).
        root = min(spans, key=lambda s: s.get("ts", 0.0))
    if root is None:
        return {"error": "no spans in trace", "hops": [], "total_s": 0.0}
    t0 = root["ts"]
    total = root.get("dur", 0.0)
    t_end = t0 + total

    replica = None
    for s in spans:
        if str(s.get("name", "")).startswith("serve.replica."):
            replica = s
            break
    admitted = _first(events, kind="span", name="qos.admitted") or \
        _first(events, name="qos.admitted")
    submitted = _first(events, kind="task_submitted")
    dispatched = _first(events, kind="task_dispatched")
    exec_start = _first(events, kind="task_exec_start")

    hops: list[dict] = []

    def hop(name: str, start: float, dur: float):
        hops.append({"hop": name, "start_s": max(0.0, start - t0),
                     "dur_s": max(0.0, dur)})

    # proxy: root start -> the moment the handle began waiting (admission
    # event carries waited_s, so the wait START is ts - waited_s).
    if admitted is not None:
        waited = float((admitted.get("attrs") or {}).get("waited_s", 0.0))
        hop("proxy", t0, (admitted["ts"] - waited) - t0)
        hop("admission", admitted["ts"] - waited, waited)
    anchor = submitted["ts"] if submitted else None
    if submitted is not None and dispatched is not None:
        hop("dispatch", anchor, dispatched["ts"] - anchor)
    if exec_start is not None:
        w_from = dispatched["ts"] if dispatched is not None else anchor
        if w_from is not None:
            hop("wire", w_from, exec_start["ts"] - w_from)
    if replica is not None:
        hop("exec", replica["ts"], replica.get("dur", 0.0))
        exec_end = replica["ts"] + replica.get("dur", 0.0)
        hop("drain", exec_end, t_end - exec_end)
    attributed = sum(h["dur_s"] for h in hops)
    return {
        "trace_id": root.get("trace_id", ""),
        "root": root.get("name", ""),
        "deployment": (str(replica["name"]).split("serve.replica.", 1)[1]
                       if replica is not None else ""),
        "total_s": total,
        "hops": hops,
        "attributed_s": attributed,
        "unattributed_s": max(0.0, total - attributed),
        "anchors": {
            "admitted": admitted is not None,
            "submitted": submitted is not None,
            "dispatched": dispatched is not None,
            "exec_start": exec_start is not None,
            "replica_span": replica is not None,
        },
    }


def aggregate(autopsies: list[dict]) -> dict:
    """Per-deployment 'where does the time go' rollup over many requests:
    for each hop, total seconds, share of summed wall time, and the max
    single-request contribution (a cheap p100 that points at outliers)."""
    by_dep: dict[str, dict] = {}
    for a in autopsies:
        if not a.get("hops"):
            continue
        dep = a.get("deployment") or "?"
        agg = by_dep.setdefault(dep, {
            "deployment": dep, "requests": 0, "total_s": 0.0,
            "hops": {h: {"total_s": 0.0, "max_s": 0.0} for h in HOPS},
            "unattributed_s": 0.0,
        })
        agg["requests"] += 1
        agg["total_s"] += a.get("total_s", 0.0)
        agg["unattributed_s"] += a.get("unattributed_s", 0.0)
        for h in a["hops"]:
            rec = agg["hops"].setdefault(h["hop"], {"total_s": 0.0, "max_s": 0.0})
            rec["total_s"] += h["dur_s"]
            rec["max_s"] = max(rec["max_s"], h["dur_s"])
    for agg in by_dep.values():
        denom = agg["total_s"] or 1.0
        for rec in agg["hops"].values():
            rec["share"] = rec["total_s"] / denom
    return by_dep
