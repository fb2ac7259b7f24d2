"""Live N->M resize orchestration: the controller-side half of the elastic
train plane.

Flow (TrainController calls these after its graceful stop+settle): every
gang member parks its last keep_live() snapshot (``reshard_export``), the
target membership is computed (survivors keep their actors — dying hosts
are sources only; a grow spawns fresh members), every target rank pulls its
slice of the new layout over the raw lane (``reshard_pull``), and the train
fn restarts in place with ``train.live_resume()`` carrying params/optimizer
windows/step meta — the blob store is never touched.

Every attempt is fenced by a cluster-wide resize epoch
(controller ``elastic_resize_epoch``): a stale controller's attempt fails
the bump and falls back instead of racing a newer incarnation's transfer.

Preemption interaction: ``preempted_members`` maps a node drain
notice (node ``draining``/``DEAD``) onto gang members so
the controller can shrink DURING the grace window, and a shrink registers
the lost footprint in the core controller's external-demand table — the
node autoscaler sees it and replaces the preempted capacity, after which
the scaling policy grows the gang back.

Any failure on this path returns None (with cleanup): the caller falls
back to the checkpoint-restore restart, which is exactly the behavior this
plane replaces when healthy.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

_epoch_gauge = _metrics.Gauge(
    "elastic.resize.epoch", "current elastic resize epoch per experiment",
    tag_keys=("experiment",))


def _core():
    from ray_tpu_torch.core import api as _api

    return _api._require_worker()


def bump_resize_epoch(experiment: str, expect: Optional[int] = None) -> Optional[int]:
    """Fence + bump the experiment's cluster-wide resize epoch. Returns the
    new epoch, or None when ``expect`` is stale (another controller
    incarnation resized since — abandon this attempt)."""
    core = _core()
    reply = core._run(core.controller.call(
        "elastic_resize_epoch", {"experiment": experiment, "expect": expect}))
    if not reply.get("ok"):
        return None
    epoch = int(reply["epoch"])
    _epoch_gauge.set(float(epoch), tags={"experiment": experiment})
    return epoch


def unavailable_nodes() -> set:
    """Node ids currently draining (preemption grace window) or DEAD."""
    core = _core()
    state = core._run(core.controller.call("get_cluster_state", {}))
    return {
        nid for nid, n in state.get("nodes", {}).items()
        if n.get("draining") or n.get("state") == "DEAD"
    }


def preempted_members(group) -> list[int]:
    """Indices of gang members sitting on draining/dead nodes (the
    preemption notice surface: a drained node -> daemon
    drain -> grace -> drop)."""
    bad = unavailable_nodes()
    return [i for i, nid in enumerate(group.node_ids) if nid and nid in bad]


def set_lost_capacity_demand(experiment: str, worker_resources: dict,
                             count: int) -> None:
    """Shrink bookkeeping: advertise the preempted workers' footprint as
    external pending demand so the node autoscaler launches replacement
    capacity (count=0 clears — the gang grew back)."""
    core = _core()
    try:
        core._run(core.controller.call("set_external_demand", {
            "source": f"elastic:{experiment}",
            "items": [{"demand": dict(worker_resources)}] * count,
        }))
    except Exception:
        pass  # advisory only: autoscaling hint, never resize-blocking


def live_resize(group, new_n: int, *, experiment: str,
                train_fn: Callable, config: dict,
                datasets: Optional[dict] = None,
                epoch_expect: Optional[int] = None) -> Optional[dict]:
    """Execute one live N->M resize against a stopped gang. Returns a stats
    dict on success (the group now runs the train fn at world ``new_n``),
    or None after cleanup — the caller falls back to checkpoint restart.

    Preconditions (TrainController's RESIZING block): stop_all() issued and
    final reports absorbed, so every rank's snapshot sits at its last step
    boundary."""
    import ray_tpu_torch as rt

    if group.pg is not None:
        return None  # PG-pinned gangs can't resize in place (see WorkerGroup)
    epoch = bump_resize_epoch(experiment, epoch_expect)
    if epoch is None:
        return None
    tid = f"{experiment}-e{epoch}-{uuid.uuid4().hex[:8]}"
    old_n = len(group.workers)
    with _tracing.span("elastic.resize", experiment=experiment, epoch=epoch,
                       old=old_n, new=new_n):
        # 1. Park every member's snapshot (dying hosts included — during
        # the preemption grace window they are still the only holders of
        # their optimizer windows).
        refs = [(i, w.reshard_export.remote(tid)) for i, w in enumerate(group.workers)]
        exports: dict[int, dict] = {}
        for i, r in refs:
            try:
                m = rt.get(r, timeout=30)
            except Exception:
                m = None  # dead member: source lost; coverage math decides
            if m is not None:
                exports[i] = m
        if not exports:
            return None  # fn never registered live state -> ckpt fallback
        # Consistent cut: only exports at the newest step boundary are
        # sources (a rank that stopped a step early must not mix stale
        # bytes into the new gang; if the newest-seq holders can't cover,
        # the CoverageError below falls back to checkpoints).
        top = max(m["seq"] for m in exports.values())
        sources = {i: m for i, m in exports.items() if m["seq"] == top}

        # 2. Target membership: survivors (live exports off dying nodes
        # keep their actors) in old-rank order, extras spawned for a grow.
        old_workers = list(group.workers)
        dying = set(preempted_members(group))
        survivor_idx = [i for i in range(old_n)
                        if i not in dying and i in exports]
        keep = survivor_idx[:new_n]
        spawned: list = []
        try:
            if len(keep) < new_n:
                spawned = group.spawn_extra(new_n - len(keep))
            # (actor, old_rank) pairs in new-rank order.
            members = [(group.workers[i], i) for i in keep] + \
                      [(w, None) for w in spawned]
            member_nodes = [group.node_ids[i] for i in keep] + \
                group.node_ids[len(group.node_ids) - len(spawned):]
            src_list = list(sources.values())
            # 3. Every target rank pulls its slice (self-runs are local).
            pulls = [
                w.reshard_pull.remote(
                    tid, src_list, new_n, new_rank,
                    old_rank if old_rank in sources else None)
                for new_rank, (w, old_rank) in enumerate(members)
            ]
            core = _core()
            stats = [rt.get(r, timeout=core.config.elastic_transfer_timeout_s
                            * 4 + 30) for r in pulls]
        except Exception:
            for w in spawned:
                try:
                    rt.kill(w)
                except Exception:
                    pass
            _release_exports(old_workers, tid, exports)
            _tracing.event("elastic.resize.fallback", experiment=experiment,
                           epoch=epoch)
            return None
        # 4. Swap membership + resume the fn at the new world size. The session
        # re-keys the gang coordinator automatically (train:<exp>:w<M>).
        group.adopt([w for w, _i in members], member_nodes)
        shards = group.make_shards(datasets, new_n)
        rt.get([
            w.restart_live.remote(train_fn, config, r, new_n, shards[r])
            for r, (w, _i) in enumerate(members)
        ], timeout=60)
        _release_exports(old_workers, tid, exports)
        wire = sum(s.get("wire_bytes", 0) for s in stats)
        total = sum(s.get("bytes", 0) for s in stats)
        elapsed = max((s.get("elapsed_s", 0.0) for s in stats), default=0.0)
        return {"epoch": epoch, "tid": tid, "old_n": old_n, "new_n": new_n,
                "bytes": total, "wire_bytes": wire,
                "mb_s": (total / 1e6 / elapsed) if elapsed > 0 else 0.0,
                "per_rank": stats}


def _release_exports(old_workers: list, tid: str, exports: dict) -> None:
    """Best-effort export release on every member that parked state (dead
    members' exports die with their process)."""
    for i in exports:
        if i < len(old_workers):
            try:
                old_workers[i].reshard_release.remote(tid)
            except Exception:
                pass
