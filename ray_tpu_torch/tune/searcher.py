"""Pluggable search algorithms: the Searcher interface + a TPE implementation.

Role-equivalent to the reference's Searcher ABC and its model-based plugins
(python/ray/tune/search/searcher.py — suggest /
on_trial_complete contract; tune/search/optuna/ et al. provide the models).
The TPE searcher is a native implementation of the Tree-structured Parzen
Estimator (the algorithm behind hyperopt/optuna's default): split observed
trials into good/bad by score quantile, model each numeric dimension with
Parzen (Gaussian-kernel) densities l(x) (good) and g(x) (bad), and suggest
the candidate maximizing l(x)/g(x). Categorical dimensions use smoothed
category frequencies from the good split.
"""
from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.search import (
    Choice,
    Domain,
    LogUniform,
    Randint,
    Uniform,
    _is_grid,
    _set_path,
    _walk,
    generate_variants,
)


class Searcher:
    """suggest/observe contract (reference: searcher.py). Stateful; driven by
    the TuneController. Implementations must tolerate out-of-order completes
    and may return None from suggest() to signal exhaustion."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, metrics: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, metrics: Optional[dict]) -> None:
        pass

    # Sweep resume: searchers persist their observations with the sweep
    # state (reference: Searcher.save/restore).
    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid/random search behind the Searcher interface (reference:
    basic_variant.py). Pre-expands the whole variant list."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: Optional[int] = None, metric: Optional[str] = None,
                 mode: str = "max"):
        super().__init__(metric, mode)
        self._configs = generate_variants(param_space, num_samples, seed)
        self._next = 0

    @property
    def total(self) -> int:
        return len(self._configs)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._next >= len(self._configs):
            return None
        cfg = self._configs[self._next]
        self._next += 1
        return cfg

    def get_state(self) -> dict:
        return {"next": self._next}

    def set_state(self, state: dict) -> None:
        self._next = state.get("next", 0)


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over a param_space of Domains.

    Independent 1-D models per dimension (the classic TPE factorization):
    numeric domains are modeled in their natural space (log space for
    LogUniform) by Parzen windows centered on observed values; categorical
    domains by add-one-smoothed frequencies. The first `n_initial` suggestions
    are random (seeding the model), after which each suggestion draws
    `n_candidates` samples from the good-split density and keeps the one
    with the best l(x)/g(x) ratio.
    """

    def __init__(self, param_space: dict, metric: str, mode: str = "max",
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.space = param_space
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._dims: list[tuple[tuple, Domain]] = []
        for path, v in _walk(param_space):
            if _is_grid(v):
                raise ValueError("TPESearcher does not support grid_search dims; "
                                 "use Domains (uniform/loguniform/randint/choice)")
            if isinstance(v, Domain):
                self._dims.append((path, v))
        # trial_id -> config (pending observation); observations: (config, score)
        self._pending: dict[str, dict] = {}
        self._observations: list[tuple[dict, float]] = []

    # -- modeling helpers ---------------------------------------------------
    def _to_model_space(self, dom: Domain, v: float) -> float:
        return math.log(v) if isinstance(dom, LogUniform) else float(v)

    def _from_model_space(self, dom: Domain, x: float):
        if isinstance(dom, LogUniform):
            out = math.exp(x)
            return min(max(out, dom.low), dom.high)
        if isinstance(dom, Randint):
            return min(max(int(round(x)), dom.low), dom.high - 1)
        return min(max(x, dom.low), dom.high)

    @staticmethod
    def _bandwidth(xs: list[float], span: float) -> float:
        """Silverman-flavored kernel width, floored so sparse splits still
        explore and capped so the model is never flatter than the prior."""
        if len(xs) < 2:
            return 0.25 * span
        mean = sum(xs) / len(xs)
        sd = (sum((v - mean) ** 2 for v in xs) / len(xs)) ** 0.5
        bw = 1.06 * (sd or 0.1 * span) * len(xs) ** -0.2
        return min(max(bw, 0.02 * span), 0.5 * span)

    @staticmethod
    def _parzen_pdf(xs: list[float], bw: float, x: float) -> float:
        if not xs:
            return 1e-12
        s = 0.0
        for c in xs:
            z = (x - c) / bw
            s += math.exp(-0.5 * z * z)
        return s / (len(xs) * bw * math.sqrt(2 * math.pi)) + 1e-12

    def _split(self) -> tuple[list[dict], list[dict]]:
        obs = sorted(
            self._observations,
            key=lambda cs: cs[1],
            reverse=(self.mode == "max"),
        )
        n_good = max(1, int(self.gamma * len(obs)))
        return [c for c, _ in obs[:n_good]], [c for c, _ in obs[n_good:]]

    def _get_path(self, cfg: dict, path: tuple):
        for k in path:
            cfg = cfg[k]
        return cfg

    # -- Searcher interface -------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[dict]:
        from ray_tpu_torch.tune.search import _copy_structure

        cfg = _copy_structure(self.space)
        if len(self._observations) < self.n_initial or not self._dims:
            for path, dom in self._dims:
                _set_path(cfg, path, dom.sample(self.rng))
        else:
            good, bad = self._split()
            for path, dom in self._dims:
                if isinstance(dom, Choice):
                    # Smoothed frequency draw from the good split.
                    counts = {c: 1.0 for c in dom.categories}
                    for g in good:
                        counts[self._get_path(g, path)] = counts.get(self._get_path(g, path), 1.0) + 1.0
                    total = sum(counts.values())
                    r = self.rng.random() * total
                    acc = 0.0
                    for cat, w in counts.items():
                        acc += w
                        if r <= acc:
                            _set_path(cfg, path, cat)
                            break
                    continue
                g_xs = [self._to_model_space(dom, self._get_path(c, path)) for c in good]
                b_xs = [self._to_model_space(dom, self._get_path(c, path)) for c in bad]
                lo = self._to_model_space(dom, dom.low)
                hi = self._to_model_space(dom, dom.high - 1 if isinstance(dom, Randint) else dom.high)
                span = max(hi - lo, 1e-9)
                bw_g = self._bandwidth(g_xs, span)
                bw_b = self._bandwidth(b_xs, span)
                best_x, best_ratio = None, -1.0
                for _ in range(self.n_candidates):
                    center = self.rng.choice(g_xs) if g_xs else self.rng.uniform(lo, hi)
                    # Resample out-of-range draws (clamping would pile point
                    # mass on the bounds and the argmax degenerates there).
                    for _try in range(8):
                        x = self.rng.gauss(center, bw_g)
                        if lo <= x <= hi:
                            break
                    else:
                        x = min(max(x, lo), hi)
                    ratio = self._parzen_pdf(g_xs, bw_g, x) / self._parzen_pdf(b_xs, bw_b, x)
                    if ratio > best_ratio:
                        best_x, best_ratio = x, ratio
                _set_path(cfg, path, self._from_model_space(dom, best_x))
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, metrics: Optional[dict]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not metrics or self.metric not in metrics:
            return
        self._observations.append((cfg, float(metrics[self.metric])))

    def get_state(self) -> dict:
        # _pending too: a trial in flight at checkpoint time completes after
        # resume, and its (config, score) must still reach the model.
        return {"observations": self._observations, "rng": self.rng.getstate(),
                "pending": self._pending}

    def set_state(self, state: dict) -> None:
        self._observations = [
            (c, float(s)) for c, s in state.get("observations", [])
        ]
        self._pending = dict(state.get("pending", {}))
        rng_state = state.get("rng")
        if rng_state is not None:
            # JSON round-trips tuples as lists; Random.setstate needs tuples.
            self.rng.setstate(tuple(
                tuple(x) if isinstance(x, list) else x for x in rng_state
            ))


class BOHBSearcher(TPESearcher):
    """BOHB-style model-based search (Falkner et al. 2018; reference:
    tune/search/bohb/ TuneBOHB paired with schedulers/hb_bohb.py).

    The BOHB coupling: TPE densities are fitted PER BUDGET from every
    INTERMEDIATE result (on_trial_result, keyed by ``time_attr``), and
    suggestions always come from the LARGEST budget that has accumulated
    ``min_points_in_model`` observations — early rungs seed the model
    cheaply, deep rungs refine it. Pair with ASHAScheduler, the async
    successive-halving counterpart of BOHB's HyperBand: the scheduler
    allocates budgets, this searcher learns from every rung it produces.
    (Plain TPESearcher only learns from terminal results.)
    """

    def __init__(self, param_space: dict, metric: str, mode: str = "max",
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24,
                 min_points_in_model: Optional[int] = None,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        super().__init__(param_space, metric, mode, n_initial, gamma,
                         n_candidates, seed)
        self.time_attr = time_attr
        self.min_points = min_points_in_model or (len(self._dims) + 2)
        # budget -> [(config, score at that budget)]
        self._budget_obs: dict[int, list[tuple[dict, float]]] = {}
        # (trial_id, budget) pairs already recorded: the controller reports
        # the FINAL result through on_trial_result AND on_trial_complete —
        # without dedup every completed trial would be double-weighted in
        # its rung's density model.
        self._seen: set = set()

    def _record(self, trial_id: str, metrics: Optional[dict], pop: bool) -> None:
        cfg = (self._pending.pop(trial_id, None) if pop
               else self._pending.get(trial_id))
        if cfg is None or not metrics or self.metric not in metrics:
            return
        budget = int(metrics.get(self.time_attr, 0))
        if (trial_id, budget) in self._seen:
            return
        self._seen.add((trial_id, budget))
        self._budget_obs.setdefault(budget, []).append(
            (cfg, float(metrics[self.metric]))
        )
        # Model pool <- the deepest budget with enough points (BOHB's rule).
        for b in sorted(self._budget_obs, reverse=True):
            if len(self._budget_obs[b]) >= self.min_points:
                self._observations = self._budget_obs[b]
                return

    def on_trial_result(self, trial_id: str, metrics: dict) -> None:
        self._record(trial_id, metrics, pop=False)

    def on_trial_complete(self, trial_id: str, metrics: Optional[dict]) -> None:
        self._record(trial_id, metrics, pop=True)

    def get_state(self) -> dict:
        state = super().get_state()
        state["budget_obs"] = {str(b): obs for b, obs in self._budget_obs.items()}
        state["seen"] = sorted(list(p) for p in self._seen)
        return state

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        self._budget_obs = {
            int(b): [(c, float(s)) for c, s in obs]
            for b, obs in state.get("budget_obs", {}).items()
        }
        self._seen = {(t, int(b)) for t, b in state.get("seen", [])}
        for b in sorted(self._budget_obs, reverse=True):
            if len(self._budget_obs[b]) >= self.min_points:
                self._observations = self._budget_obs[b]
                break
