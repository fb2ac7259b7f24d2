"""Scaling policies: decide the worker-gang size before start and while
running (elastic training).

Role-equivalent to the reference's ScalingPolicy layer
(python/ray/train/v2/_internal/execution/scaling_policy/ —
`ScalingPolicy.make_decision_for_{non_running,running}_worker_group` and the
controller's `_execute_resize_decision`, controller.py:183). SPMD semantics:
a resize rebuilds the WHOLE gang (new world size) and resumes from the
latest checkpoint — the checkpoint plane's resharded restore re-lays the
state out over the new gang, so no per-worker state migration is needed. That makes resize
cheap to reason about: it is exactly the failure-restart path, minus the
failure.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.config import ScalingConfig


@dataclasses.dataclass
class NoopDecision:
    reason: str = ""


@dataclasses.dataclass
class ResizeDecision:
    num_workers: int
    reason: str = ""


class ScalingPolicy:
    """Interface. Stateful: the controller calls the two hooks from its poll
    loop; implementations may track cooldowns internally."""

    def __init__(self, scaling_config: ScalingConfig):
        self.scaling_config = scaling_config

    def make_decision_for_non_running_worker_group(self) -> ResizeDecision:
        """Gang size for a fresh (re)start."""
        return ResizeDecision(self.scaling_config.num_workers, "fixed size")

    def make_decision_for_running_worker_group(self, status: list) -> "NoopDecision | ResizeDecision":
        """Called every controller poll while the gang is healthy. Returning
        ResizeDecision(n) with n != current size triggers a gang rebuild."""
        return NoopDecision()


class FixedScalingPolicy(ScalingPolicy):
    """Default: the configured num_workers, forever (reference:
    scaling_policy/fixed.py)."""


class ElasticScalingPolicy(ScalingPolicy):
    """Grow the gang whenever the cluster can fit more workers, within
    [min_workers, max_workers]; shrink below current size only on the
    restart path (a lost node makes the old size infeasible, and the
    non-running decision fits the gang to what the cluster can hold).

    Matches the reference's elastic direction (ScalingPolicy reserves the
    interface; the controller executes resize between checkpoints) with a
    concrete capacity-driven implementation.
    """

    def __init__(self, scaling_config: ScalingConfig, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 resize_cooldown_s: float = 10.0,
                 probe_interval_s: float = 2.0):
        super().__init__(scaling_config)
        self.min_workers = min_workers
        self.max_workers = max_workers if max_workers is not None else scaling_config.num_workers
        self.resize_cooldown_s = resize_cooldown_s
        # Capacity probes are rate-limited: the controller poll loop runs at
        # ~5Hz and must not turn into 5 available_resources RPCs per second.
        self.probe_interval_s = probe_interval_s
        self._current = 0
        self._last_resize = 0.0
        self._last_probe = 0.0

    def _capacity_fit(self) -> int:
        """How many workers fit in currently-available resources (ONE RPC)."""
        res = self.scaling_config.worker_resources()
        try:
            avail = rt.available_resources()
        except Exception:
            return 0
        fit = 10**9
        for k, v in res.items():
            if v > 0:
                fit = min(fit, int(avail.get(k, 0.0) // v))
        return fit

    def make_decision_for_non_running_worker_group(self) -> ResizeDecision:
        # Fit the gang to current capacity within [min, max]: a restart after
        # losing a node must come back smaller instead of wedging on the old
        # size, and a restart after gaining nodes starts bigger.
        fit = min(self._capacity_fit(), self.max_workers)
        n = max(self.min_workers, min(self.max_workers, fit))
        self._current = n
        self._last_resize = time.monotonic()
        return ResizeDecision(n, f"capacity fit: {fit} (clamped to [{self.min_workers}, {self.max_workers}])")

    def make_decision_for_running_worker_group(self, status: list):
        self._current = max(self._current, len(status))
        if self._current >= self.max_workers:
            return NoopDecision("at max_workers")
        now = time.monotonic()
        if now - self._last_resize < self.resize_cooldown_s:
            return NoopDecision("cooldown")
        if now - self._last_probe < self.probe_interval_s:
            return NoopDecision("probe interval")
        self._last_probe = now
        # One RPC, arithmetic fit (no per-increment probes).
        grow_to = min(self.max_workers, self._current + max(0, self._capacity_fit()))
        if grow_to > self._current:
            self._last_resize = now
            self._current = grow_to
            return ResizeDecision(grow_to, "cluster capacity grew")
        return NoopDecision("no spare capacity")
