"""State introspection API: live task/actor/object/node/worker state.

Role-equivalent to the reference's State Observability API
(python/ray/util/state — `ray.util.state.list_tasks/list_actors/...` and the
`ray list|summary|memory` CLI, backed by GcsTaskManager's per-task lifecycle
index). Here the controller holds the indexes (controller.py state-API
handlers) and this module is the thin, driver-side query surface the CLI
(`raytpu list|summary|memory|status`), the dashboard (`/api/tasks|...`), and
user code all share.

Semantics callers can rely on:

* Every list endpoint filters SERVER-side and returns explicit truncation
  markers: ``{"<kind>": [...], "total": N, "truncated": M}`` — ``total``
  counts everything that matched, ``truncated`` what the limit cut. Task
  queries additionally return ``evicted`` — records the bounded index has
  dropped (config ``task_index_size``); zero means the view is complete.
* Task state is the per-attempt lifecycle FSM of core/task_state.py
  (PENDING_ARGS_AVAIL -> PENDING_NODE_ASSIGNMENT -> SUBMITTED_TO_WORKER ->
  RUNNING -> FINISHED | FAILED{error_type}); each record carries per-state
  timestamps in ``times`` on the shared tracing clock (tracing.now()), so
  they interleave exactly with span timings.
* Freshness: this process's event buffer is flushed before task queries;
  OTHER workers' transitions land within ``task_event_flush_interval_s``
  (default 0.5s) of happening — a just-started remote task appears RUNNING
  after at most that debounce.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "get_task",
    "get_task_events",
    "list_actors",
    "list_checkpoints",
    "list_nodes",
    "list_objects",
    "list_tasks",
    "list_workers",
    "memory_summary",
    "summary_tasks",
]


def _core():
    from ray_tpu_torch.core import api

    return api._require_worker()


def _call(method: str, payload: dict, flush: bool = False) -> Any:
    core = _core()
    if flush:
        # Driver-submitted transitions become visible immediately; remote
        # workers' events ride their debounced flush (see module docstring).
        core._run(core._flush_task_events())
    return core._run(core.controller.call(method, payload))


def _filters(state, node, fn, job, limit, **extra) -> dict:
    p = {k: v for k, v in
         (("state", state), ("node", node), ("fn", fn), ("job", job), *extra.items())
         if v}
    p["limit"] = int(limit)
    return p


def list_tasks(state: Optional[str] = None, node: Optional[str] = None,
               fn: Optional[str] = None, job: Optional[str] = None,
               task_id: Optional[str] = None, limit: int = 100) -> dict:
    """Indexed task attempts, newest first: ``{"tasks": [...], "total",
    "truncated", "evicted"}``. Filters: FSM ``state``, ``node``/``job``/
    ``task_id`` prefixes, ``fn`` name substring."""
    return _call("list_tasks",
                 _filters(state, node, fn, job, limit, task_id=task_id), flush=True)


def summary_tasks(job: Optional[str] = None) -> dict:
    """Per-function rollup: ``{"summary": {fn: {"total", "states": {state:
    n}}}, "total_tasks", "evicted"}`` (the `ray summary tasks` equivalent)."""
    p = {"job": job} if job else {}
    return _call("summary_tasks", p, flush=True)


def get_task(task_id: str) -> list[dict]:
    """Every indexed attempt of one task (id prefix accepted)."""
    return _call("get_task", {"task_id": task_id}, flush=True)


def list_actors(state: Optional[str] = None, node: Optional[str] = None,
                name: Optional[str] = None, job: Optional[str] = None,
                limit: int = 100) -> dict:
    """Actor records from the controller FSM: ``{"actors": [...], "total",
    "truncated"}``. ``name`` matches actor name or class substring."""
    return _call("list_actors", _filters(state, node, None, job, limit, name=name))


def list_objects(node: Optional[str] = None, limit: int = 100) -> dict:
    """Directory view of shared (shm-resident) objects, largest first:
    ``{"objects": [{"oid", "size", "locations"}], "total", "truncated",
    "total_bytes"}``. In-process memory-store values are per-owner; see
    memory_summary for those."""
    return _call("list_objects", _filters(None, node, None, None, limit))


def list_nodes(state: Optional[str] = None, limit: int = 1000) -> dict:
    """Node table with object-store occupancy and worker counts."""
    return _call("list_nodes", _filters(state, None, None, None, limit))


def list_workers(state: Optional[str] = None, node: Optional[str] = None,
                 limit: int = 1000) -> dict:
    """Per-node worker tables (daemon heartbeat piggyback): ``{"workers":
    [{"node_id", "worker_id", "state", "address", "actors"}], ...}``."""
    return _call("list_workers", _filters(state, node, None, None, limit))


def memory_summary(limit: int = 200, include_driver: bool = True) -> dict:
    """Cluster-wide `ray memory` equivalent: per-worker ownership tables
    (owned objects with pin/borrower counts, objects borrowed from other
    owners, lineage pins, queued submissions) grouped by node, plus each
    node's store occupancy. ``driver`` is THIS process's own table — the
    driver registers with no daemon, so the cluster fan-out can't see it."""
    out = _call("memory_summary", {"limit": int(limit)})
    if include_driver:
        core = _core()
        out["driver"] = core.memory_summary(limit=limit)
    return out


def list_checkpoints(channel: Optional[str] = None, status: Optional[str] = None,
                     limit: int = 100) -> dict:
    """Checkpoint-plane registry, newest first: ``{"checkpoints": [{"ckpt_id",
    "step", "channel", "status" (committed|aborted), "bytes_total",
    "dedup_ratio", ...}], "total", "truncated", "evicted", "channels"}``.
    ``channels`` maps each publication channel to its live ckpt_id."""
    p: dict = {"limit": int(limit)}
    if channel:
        p["channel"] = channel
    if status:
        p["status"] = status
    return _call("ckpt_list", p)


def get_task_events(since: Optional[int] = None, limit: int = 20000) -> dict | list:
    """Raw aggregated task events. With ``since`` (an absolute cursor; start
    at 0), returns ``{"events", "next", "missed", "truncated"}`` and copies
    only events after the cursor — the polling form the dashboard and CLI
    --follow use. Without it, the plain recent-events list."""
    p: dict = {"limit": int(limit)}
    if since is not None:
        p["since"] = int(since)
    return _call("get_task_events", p, flush=True)
