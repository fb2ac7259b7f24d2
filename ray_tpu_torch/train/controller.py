"""TrainController: the training run's state machine.

Role-equivalent to the reference's TrainController actor
(python/ray/train/v2/_internal/execution/controller/
controller.py:102; responsibilities listed at :103-112): start the worker
gang, poll it, funnel reports into the CheckpointManager, and apply the
FailurePolicy — SPMD gang semantics, so ANY worker failure restarts the WHOLE
group from the latest checkpoint (reference failure_handling/ + the
gang-restart behavior of v2).

Runs as an actor (like the reference, pinned near the driver) so a driver
process crash doesn't orphan the gang silently; `TrainRunner` below is the
driver-side blocking wrapper.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class Result:
    """Reference: ray.train.Result (metrics + best/latest checkpoint + error)."""

    metrics: dict
    checkpoint: Optional[Checkpoint]
    best_checkpoint: Optional[Checkpoint]
    error: Optional[str]
    metrics_history: list

    @property
    def success(self) -> bool:
        return self.error is None


class TrainController:
    """State machine: INIT -> RUNNING -> (RESTARTING -> RUNNING)* -> DONE|ERRORED."""

    def __init__(self, train_fn: Callable, train_config: dict,
                 scaling: ScalingConfig, run_config: RunConfig,
                 poll_interval_s: float = 0.2, settle_period_s: float = 5.0,
                 datasets: Optional[dict] = None, scaling_policy=None):
        from ray_tpu_torch.train.scaling_policy import FixedScalingPolicy

        self.train_fn = train_fn
        self.train_config = train_config
        self.scaling = scaling
        self.run_config = run_config
        self.scaling_policy = scaling_policy or FixedScalingPolicy(scaling)
        self.datasets = datasets or {}
        self.poll_interval_s = poll_interval_s
        self.settle_period_s = settle_period_s
        self.storage_path = run_config.resolved_storage_path()
        cc = run_config.checkpoint_config
        self.ckpt_manager = CheckpointManager(
            self.storage_path,
            num_to_keep=cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order,
        )
        self.state = "INIT"
        self.failures = 0
        self.resizes = 0
        self.live_resizes = 0
        self.last_live_resize: Optional[dict] = None  # stats of the newest one
        # Elastic-live bookkeeping: last fenced resize epoch (0 = never
        # resized; the first bump passes expect=None) + preemption-probe
        # rate limit (one cluster-state RPC per second, not per poll).
        self._resize_epoch = 0
        self._last_preempt_probe = 0.0
        self.metrics_history: list[dict] = []
        self.latest_metrics: dict = {}
        # Seqs absorbed from the CURRENT gang (reset per restart: a restarted
        # gang re-reports from seq 1 and that re-done work is real).
        self._seen_ckpt_seqs: set[int] = set()
        # seq -> (metrics_history index, came-from-rank-0): lets rank 0's
        # canonical metrics replace a non-canonical fallback absorbed earlier.
        self._metric_entries: dict[int, tuple[int, bool]] = {}
        self._max_metric_seq = -1

    # -- main loop ---------------------------------------------------------
    def run(self) -> Result:
        error: Optional[str] = None
        group: Optional[WorkerGroup] = None
        name = self.run_config.name or "train_run"
        max_failures = self.run_config.failure_config.max_failures
        # World sizes this run started gangs at: each has its own collective
        # coordinator (train:<name>:w<n>, see session.collective_group) to
        # reap when the run ends — an elastic resize changes the size.
        gang_sizes: set[int] = set()
        while True:
            try:
                if group is None:
                    # The policy sizes every (re)start: fixed = configured n;
                    # elastic = fit the gang to current cluster capacity
                    # (reference: make_decision_for_non_running_worker_group).
                    decision = self.scaling_policy.make_decision_for_non_running_worker_group()
                    if decision.num_workers != self.scaling.num_workers:
                        self.scaling = dataclasses.replace(
                            self.scaling, num_workers=decision.num_workers
                        )
                    self._seen_ckpt_seqs.clear()
                    self._metric_entries.clear()
                    self._max_metric_seq = -1
                    group = WorkerGroup(
                        self.scaling, name, self.storage_path,
                        # Elastic-live gangs schedule by plain resources: a
                        # live resize keeps surviving actors and changes
                        # membership, which a fixed-bundle PG can't express.
                        gang_pg=not self.run_config.elastic_live,
                    )
                    gang_sizes.add(self.scaling.num_workers)
                    group.start()
                    resume = self.ckpt_manager.latest
                    group.run(
                        self.train_fn,
                        self.train_config,
                        resume.path if resume else None,
                        datasets=self.datasets,
                    )
                    self.state = "RUNNING"
                status = group.poll()
            except Exception:
                status = None
                err_text = traceback.format_exc()
                if group is not None:
                    # Drain surviving ranks' reports first — rank 0's last
                    # persisted checkpoint is the restart point.
                    try:
                        self._absorb_reports(group.poll())
                    except Exception:
                        pass
                    group.shutdown()
                group = None
                self.failures += 1
                if max_failures != -1 and self.failures > max_failures:
                    error = f"worker group failed:\n{err_text}"
                    self.state = "ERRORED"
                    break
                self.state = "RESTARTING"
                continue

            worker_error = next((s["error"] for s in status if s["error"]), None)
            self._absorb_reports(status)
            if worker_error is not None:
                # Let surviving ranks settle (finish or fail) before teardown
                # so their last checkpoints are absorbed — restarting the
                # gang without rank 0's newest checkpoint replays work and
                # can re-hit the same failure.
                deadline = time.monotonic() + self.settle_period_s
                while time.monotonic() < deadline and not all(
                    s["finished"] or s["error"] for s in status
                ):
                    time.sleep(self.poll_interval_s)
                    try:
                        status = group.poll()
                        self._absorb_reports(status)
                    except Exception:
                        break
                group.shutdown()
                group = None
                self.failures += 1
                if max_failures != -1 and self.failures > max_failures:
                    error = worker_error
                    self.state = "ERRORED"
                    break
                self.state = "RESTARTING"
                continue
            if all(s["finished"] for s in status):
                self.state = "DONE"
                break
            decision = None
            if self.run_config.elastic_live:
                # Preemption notice beats the scaling policy: a draining
                # host's state must move DURING the grace window.
                decision = self._preempt_decision(group)
            if decision is None:
                decision = self.scaling_policy.make_decision_for_running_worker_group(status)
            if (
                getattr(decision, "num_workers", None) is not None
                and decision.num_workers != len(group.workers)
            ):
                # Elastic resize (reference: _execute_resize_decision,
                # controller.py:183): graceful-stop the gang so every rank's
                # final report/checkpoint is absorbed, then EITHER reshard
                # the live state in place (elastic_live) or rebuild at the
                # new size from the latest checkpoint.
                # NOT a failure: does not consume the failure budget.
                self.state = "RESIZING"
                self.resizes += 1
                old_n = len(group.workers)
                group.stop_all()
                deadline = time.monotonic() + self.settle_period_s
                while time.monotonic() < deadline:
                    try:
                        status = group.poll()
                        self._absorb_reports(status)
                        if all(s["finished"] or s["error"] for s in status):
                            break
                    except Exception:
                        break
                    time.sleep(self.poll_interval_s)
                if self.run_config.elastic_live:
                    if self._live_resize(group, decision.num_workers, name, old_n):
                        gang_sizes.add(self.scaling.num_workers)
                        self.state = "RUNNING"
                        continue
                group.shutdown()
                group = None
                continue
            time.sleep(self.poll_interval_s)

        if group is not None:
            group.shutdown()
        # Reap the run's collective coordinators (no-op when the train fn
        # never called grad_sync()/sharded_optimizer(): destroying a group
        # whose named actor doesn't exist returns immediately).
        from ray_tpu_torch import collective as col

        for n in gang_sizes:
            try:
                col.destroy_collective_group(f"train:{name}:w{n}")
            except Exception:
                pass  # best-effort: the coordinator dies with the cluster anyway
        return Result(
            metrics=self.latest_metrics,
            checkpoint=self.ckpt_manager.latest,
            best_checkpoint=self.ckpt_manager.best,
            error=error,
            metrics_history=self.metrics_history,
        )

    def _preempt_decision(self, group):
        """Map draining/dead gang nodes (the preemption notice surface)
        onto a shrink decision. Rate-limited: one cluster-state RPC per
        second, not one per 5Hz poll."""
        from ray_tpu_torch.train.scaling_policy import ResizeDecision

        now = time.monotonic()
        if now - self._last_preempt_probe < 1.0:
            return None
        self._last_preempt_probe = now
        try:
            from ray_tpu_torch.elastic import resize as _er

            dying = _er.preempted_members(group)
        except Exception:
            return None
        if not dying:
            return None
        min_w = max(1, int(getattr(self.scaling_policy, "min_workers", 1)))
        target = max(min_w, len(group.workers) - len(dying))
        if target == len(group.workers):
            return None  # can't shrink below min: the failure path covers it
        return ResizeDecision(
            target, f"preemption notice: {len(dying)} member(s) draining")

    def _live_resize(self, group, new_n: int, name: str, old_n: int) -> bool:
        """Attempt the in-place reshard; on success the SAME group object
        runs the fn at the new world size (seq bookkeeping resets like a
        restart — the resumed fn re-reports from seq 1)."""
        from ray_tpu_torch.elastic import resize as _er

        try:
            stats = _er.live_resize(
                group, new_n, experiment=name,
                train_fn=self.train_fn, config=self.train_config,
                datasets=self.datasets,
                epoch_expect=self._resize_epoch or None)
        except Exception:
            traceback.print_exc()
            stats = None
        if stats is None:
            return False
        self._resize_epoch = stats["epoch"]
        self.live_resizes += 1
        self.last_live_resize = stats
        self.scaling = dataclasses.replace(self.scaling, num_workers=new_n)
        self._seen_ckpt_seqs.clear()
        self._metric_entries.clear()
        self._max_metric_seq = -1
        # Preemption shrink: advertise the lost footprint so the node
        # autoscaler replaces the capacity; a grow clears it.
        try:
            _er.set_lost_capacity_demand(
                name, self.scaling.worker_resources(), max(0, old_n - new_n))
        except Exception:
            pass
        return True

    def _drop_staged(self, path: str) -> None:
        """Remove a duplicate checkpoint dir — but ONLY if it is a staging
        dir this controller owns; per-rank sharded checkpoint dirs elsewhere
        under storage_path are user data."""
        import shutil

        staging = os.path.join(os.path.abspath(self.storage_path), ".staging")
        if os.path.abspath(path).startswith(staging + os.sep):
            shutil.rmtree(path, ignore_errors=True)

    def _absorb_reports(self, status: list[dict]) -> None:
        # Group per-worker reports by seq; rank 0's metrics are canonical
        # (SPMD), checkpoints may come from any rank (rank 0 by convention).
        # _seen_*_seqs dedupe across poll cycles: the same seq can arrive
        # from different ranks in different polls.
        by_seq: dict[int, dict] = {}
        for st in status:
            for rep in st["reports"]:
                ent = by_seq.setdefault(rep["seq"], {"metrics": None, "ckpt": None})
                if rep["world_rank"] == 0:
                    ent["metrics"] = rep["metrics"]
                if rep.get("checkpoint_dir"):
                    already = (
                        rep["seq"] in self._seen_ckpt_seqs
                        or (ent["ckpt"] and ent["ckpt"][0] != rep["checkpoint_dir"])
                    )
                    if already:
                        # Several ranks persisted the same seq (SPMD: identical
                        # state); keep one, drop duplicates' STAGING dirs only.
                        self._drop_staged(rep["checkpoint_dir"])
                    else:
                        ent["ckpt"] = (rep["checkpoint_dir"], rep["metrics"])
        for seq in sorted(by_seq):
            ent = by_seq[seq]
            canonical = ent["metrics"] is not None  # rank 0 reported this seq
            metrics = ent["metrics"] or (ent["ckpt"][1] if ent["ckpt"] else {})
            if ent["ckpt"] and seq not in self._seen_ckpt_seqs:
                self._seen_ckpt_seqs.add(seq)
                # A lost/corrupt checkpoint dir must not kill the run: the
                # metrics are still valid, and training continues from the
                # previous registered checkpoint.
                try:
                    self.ckpt_manager.register(ent["ckpt"][0], metrics)
                except OSError:
                    traceback.print_exc()
            if not metrics:
                continue
            prev = self._metric_entries.get(seq)
            if prev is None:
                self.metrics_history.append(metrics)
                self._metric_entries[seq] = (len(self.metrics_history) - 1, canonical)
            elif canonical and not prev[1]:
                # Rank 0's metrics arrived a poll later than another rank's
                # checkpoint fallback: canonical wins.
                self.metrics_history[prev[0]] = metrics
                self._metric_entries[seq] = (prev[0], True)
            else:
                continue
            if seq >= self._max_metric_seq:
                self._max_metric_seq = seq
                self.latest_metrics = metrics

    def get_state(self) -> dict:
        return {
            "state": self.state,
            "failures": self.failures,
            "resizes": self.resizes,
            "live_resizes": self.live_resizes,
            "resize_epoch": self._resize_epoch,
            "world_size": self.scaling.num_workers,
            "reported": len(self.metrics_history),
            "latest_metrics": self.latest_metrics,
        }
