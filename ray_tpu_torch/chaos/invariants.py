"""Post-scenario cluster invariants.

A chaos scenario is only a pass when the cluster it tortured converges back
to a clean state — these checks are the definition of "clean". Each check
returns a dict ``{"ok": bool, "detail": ...}``; the runner aggregates them
into the scenario report. Checks poll with a deadline where the property is
eventually-consistent (task events ride a debounced flush; metrics ride the
reporter tick) — an invariant that can only pass "if you check at the right
moment" would be a timing race of its own.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from ray_tpu_torch.chaos import plan as _plan

# Task-index states that mean "still in flight". After a quiesced workload
# every indexed attempt must be FINISHED or FAILED — a record stuck in any
# of these is a lost task the state API would misreport forever.
_NON_TERMINAL = ("PENDING_ARGS_AVAIL", "PENDING_NODE_ASSIGNMENT",
                 "SUBMITTED_TO_WORKER", "RUNNING")


def no_stuck_tasks(core, timeout_s: float = 10.0) -> dict:
    """Every task attempt the state index knows about reached a terminal
    state (superseded retry attempts included — they close with a terminal
    task_failed event; a non-terminal ghost means an emitter lost a
    transition under the injected faults)."""
    deadline = time.monotonic() + timeout_s
    stuck: list = []
    while True:
        core._run(core._flush_task_events())
        stuck = []
        for state in _NON_TERMINAL:
            out = core._run(core.controller.call(
                "list_tasks", {"state": state, "limit": 50}
            ))
            stuck.extend(
                {"task_id": t["task_id"], "attempt": t.get("attempt"),
                 "state": t.get("state"), "fn": t.get("fn")}
                for t in out.get("tasks", [])
            )
        if not stuck or time.monotonic() > deadline:
            break
        time.sleep(0.3)
    return {"ok": not stuck, "detail": {"stuck": stuck}}


def transfer_plane_quiesced(cluster) -> dict:
    """No pull is still admitted, no chunk bytes are still counted in
    flight, and no per-oid transfer future is still registered on any
    in-process daemon — leaked admission/pins would starve later pulls."""
    leaks = []
    for d in getattr(cluster, "daemons", []):
        pm = d.pull_manager
        if pm._inflight_pulls or pm._inflight_bytes or pm._pulls:
            leaks.append({
                "node": d.node_id[:12],
                "inflight_pulls": pm._inflight_pulls,
                "inflight_bytes": pm._inflight_bytes,
                "open_transfers": len(pm._pulls),
            })
    return {"ok": not leaks, "detail": {"leaks": leaks}}


def stores_consistent(cluster, timeout_s: float = 5.0) -> dict:
    """Arena sanity + directory consistency for in-process daemons: used
    bytes within capacity, and every directory entry naming a live node is
    actually resident (or spilled) there — an unsealed/aborted entry left
    behind by an injected fault shows up as a directory lie."""
    deadline = time.monotonic() + timeout_s
    problems: list = []
    while True:
        problems = []
        daemons = {d.node_id: d for d in getattr(cluster, "daemons", [])}
        for d in daemons.values():
            if d.store is None:
                continue
            if d.store.used > d.store.capacity:
                problems.append({"node": d.node_id[:12], "why": "used > capacity",
                                 "used": d.store.used, "capacity": d.store.capacity})
        controller = getattr(cluster, "controller", None)
        if controller is not None:
            from ray_tpu_torch.core.ids import ObjectID

            for oid_bin, node_ids in list(controller.object_dir.items()):
                for nid in list(node_ids):
                    d = daemons.get(nid)
                    if d is None or d.store is None:
                        continue
                    if not d.store.contains_or_spilled(ObjectID(oid_bin)):
                        problems.append({
                            "node": nid[:12], "why": "directory entry not resident",
                            "oid": ObjectID(oid_bin).hex()[:16],
                        })
        if not problems or time.monotonic() > deadline:
            break
        time.sleep(0.25)  # in-flight deletes/reports settle
    return {"ok": not problems, "detail": {"problems": problems}}


def faults_visible_in_metrics(core, min_count: int, timeout_s: float = 8.0) -> dict:
    """chaos.injected_total on the controller's merged /metrics view sums to
    at least ``min_count`` — no silent injection. (Faults injected by a
    process the fault itself killed can never report; callers pass the
    count of injections whose process survived.)"""
    deadline = time.monotonic() + timeout_s
    total = 0.0
    while True:
        core._run(core._report_metrics())
        series = core._run(core.controller.call("get_metrics", {}))
        total = sum(
            rec.get("value", 0.0) for rec in series
            if rec.get("name") == "chaos.injected_total"
        )
        if total >= min_count or time.monotonic() > deadline:
            break
        time.sleep(0.3)
    return {"ok": total >= min_count, "detail": {"metric_total": total, "expected_min": min_count}}


def injections_recorded(min_count: int) -> dict:
    """This process's injection log saw at least min_count faults — the
    scenario actually exercised its schedule (a schedule that never fires
    is a green-by-vacuity trap)."""
    n = len(_plan.injection_log())
    return {"ok": n >= min_count, "detail": {"logged": n, "expected_min": min_count}}


def check_all(core, cluster, *, min_injections: int = 1,
              min_metric_injections: Optional[int] = None) -> dict:
    """The standard post-scenario battery. min_metric_injections defaults to
    min_injections; pass 0 when every injecting process was killed by its
    own fault (worker-kill scenarios)."""
    out: dict[str, Any] = {
        "no_stuck_tasks": no_stuck_tasks(core),
        "transfer_plane_quiesced": transfer_plane_quiesced(cluster),
        "stores_consistent": stores_consistent(cluster),
        "injections_recorded": injections_recorded(min_injections),
    }
    mmin = min_injections if min_metric_injections is None else min_metric_injections
    if mmin > 0:
        out["faults_visible_in_metrics"] = faults_visible_in_metrics(core, mmin)
    out["ok"] = all(v["ok"] for v in out.values() if isinstance(v, dict))
    return out
