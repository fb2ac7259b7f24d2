"""Trial schedulers: FIFO, ASHA (async successive halving), PBT.

Role-equivalent to the reference's scheduler suite
(python/ray/tune/schedulers/async_hyperband.py ASHA,
schedulers/pbt.py PopulationBasedTraining, trial_scheduler.py decisions).
Schedulers see every trial result and return a decision; PBT additionally
rewrites a trial's config + restart checkpoint (exploit/explore).
"""
from __future__ import annotations

import math
import random
from typing import Any, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: restart the SAME trial with new config/checkpoint.
PERTURB = "PERTURB"


class TrialScheduler:
    def on_trial_result(self, trial, metrics: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, metrics: Optional[dict]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async successive halving: at each rung (grace_period * rf^k), stop
    trials not in the top 1/reduction_factor of that rung so far."""

    def __init__(self, metric: str, mode: str = "max", max_t: int = 100,
                 grace_period: int = 1, reduction_factor: float = 4,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung level -> {trial_id: metric at the step the trial crossed it}
        self._rungs: dict[int, dict[str, float]] = {}
        levels = []
        t = grace_period
        while t < max_t:
            levels.append(int(t))
            t *= reduction_factor
        self._levels = levels

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def on_trial_result(self, trial, metrics: dict) -> str:
        t = int(metrics.get(self.time_attr, 0))
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for level in self._levels:
            if t < level:
                break
            rung = self._rungs.setdefault(level, {})
            if trial.trial_id in rung:
                continue  # milestone recorded once, at its crossing time
            rung[trial.trial_id] = float(value)
            # Cutoff: top 1/rf of results recorded at this rung continue.
            values = sorted(rung.values(), reverse=(self.mode == "max"))
            k = max(1, int(math.ceil(len(values) / self.rf)))
            cutoff = values[k - 1]
            if len(values) >= self.rf and self._better(cutoff, float(value)):
                return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far falls below the median of the
    other trials' RUNNING AVERAGES at comparable time (Vizier's median
    stopping; reference: tune/schedulers/median_stopping_rule.py).

    Gentler than successive halving: a trial is judged against smoothed
    peers, never a fixed rung cutoff, so noisy-but-promising trials survive
    early wobbles."""

    def __init__(self, metric: str, mode: str = "max", grace_period: int = 4,
                 min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        # trial_id -> [(t, value)] in arrival order
        self._results: dict[str, list[tuple[int, float]]] = {}

    def _running_avg(self, trial_id: str, upto_t: int) -> Optional[float]:
        vals = [v for (t, v) in self._results.get(trial_id, []) if t <= upto_t]
        return sum(vals) / len(vals) if vals else None

    def on_trial_result(self, trial, metrics: dict) -> str:
        value = metrics.get(self.metric)
        t = int(metrics.get(self.time_attr, 0))
        if value is None:
            return CONTINUE
        self._results.setdefault(trial.trial_id, []).append((t, float(value)))
        if t < self.grace_period:
            return CONTINUE
        others = [
            avg for tid in self._results if tid != trial.trial_id
            for avg in [self._running_avg(tid, t)] if avg is not None
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        n = len(others)
        median = (others[n // 2] if n % 2 else
                  0.5 * (others[n // 2 - 1] + others[n // 2]))
        own = [v for (_, v) in self._results[trial.trial_id]]
        best = max(own) if self.mode == "max" else min(own)
        worse = best < median if self.mode == "max" else best > median
        return STOP if worse else CONTINUE

    def on_trial_complete(self, trial, metrics):
        # Keep the history: completed trials still define the median bar.
        pass


class PopulationBasedTraining(TrialScheduler):
    """PBT: every perturbation_interval, bottom-quantile trials clone a
    top-quantile trial's checkpoint (exploit) and mutate hyperparams
    (explore). Reference: tune/schedulers/pbt.py."""

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        # trial_id -> (last metric value, last perturb time)
        self._scores: dict[str, float] = {}
        self._last_perturb: dict[str, int] = {}

    def _quantiles(self) -> tuple[list[str], list[str]]:
        if len(self._scores) < 2:
            return [], []
        ordered = sorted(self._scores, key=self._scores.get,
                         reverse=(self.mode == "max"))
        k = max(1, int(len(ordered) * self.quantile))
        return ordered[:k], ordered[-k:]

    def on_trial_result(self, trial, metrics: dict) -> str:
        value = metrics.get(self.metric)
        t = int(metrics.get(self.time_attr, 0))
        if value is None:
            return CONTINUE
        self._scores[trial.trial_id] = float(value)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        top, bottom = self._quantiles()
        if trial.trial_id not in bottom or trial.trial_id in top:
            return CONTINUE
        # Exploit: clone a random top trial. The controller applies this.
        donor_id = self.rng.choice(top)
        trial.pbt_exploit = donor_id
        return PERTURB

    def explore(self, config: dict) -> dict:
        from ray_tpu_torch.tune.search import mutate_config

        return mutate_config(config, self.mutations, self.rng)

    def on_trial_complete(self, trial, metrics):
        self._scores.pop(trial.trial_id, None)
