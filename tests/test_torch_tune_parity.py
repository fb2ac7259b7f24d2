"""The port's Tune against ``ray_tpu.tune``: every draw in Tune is Python's
``random``, so with one seed both packages give the same variants, the same
scheduler decisions and PBT perturbations on one scripted report sequence,
the same TPE and BOHB suggestions after the same observations, and the same
ResultGrid for a grid sweep of a pure-Python trainable on a port cluster
and a ``ray_tpu`` cluster. Exact equality throughout.
"""
import json
import random

import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

import ray_tpu
import ray_tpu.tune as j_tune
import ray_tpu_torch
import ray_tpu_torch.tune as t_tune
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.tune import schedulers as j_sched
from ray_tpu.tune import search as j_search
from ray_tpu_torch.train import RunConfig as TRunConfig
from ray_tpu_torch.tune import schedulers as t_sched
from ray_tpu_torch.tune import search as t_search

PACKAGES = ((t_tune, t_sched, t_search), (j_tune, j_sched, j_search))


def _space(tune):
    return {
        "lr": tune.loguniform(1e-5, 1e-1),
        "depth": tune.grid_search([2, 4]),
        "width": tune.randint(16, 256),
        "act": tune.choice(["relu", "gelu", "silu"]),
        "opt": {"name": tune.grid_search(["sgd", "adam"]), "momentum": tune.uniform(0.0, 1.0)},
        "wd": tune.sample_from(lambda cfg: cfg["lr"] * 0.1),
    }


@pytest.mark.parametrize("seed", [0, 7, None])
def test_generate_variants_equal(seed):
    if seed is None:
        # Unseeded: both draw from a fresh random.Random(None) — only the
        # structure can agree.
        got, want = (p[2].generate_variants(_space(p[0]), num_samples=3) for p in PACKAGES)
        assert [sorted(c) for c in got] == [sorted(c) for c in want]
        return
    got, want = (p[2].generate_variants(_space(p[0]), num_samples=3, seed=seed) for p in PACKAGES)
    assert got == want and len(got) == 12


def test_mutate_config_equal():
    cfg = {"lr": 0.01, "batch": 32, "fixed": "x", "w": 8}
    outs = []
    for tune, _, search in PACKAGES:
        rng = random.Random(3)
        muts = {"lr": tune.loguniform(1e-4, 1.0), "batch": [16, 32, 64], "w": tune.randint(1, 64)}
        outs.append([search.mutate_config(cfg, muts, rng) for _ in range(20)])
    assert outs[0] == outs[1]


class _T:
    def __init__(self, tid):
        self.trial_id = tid
        self.pbt_exploit = None


def _script(n_trials=6, steps=12, seed=5):
    """One report sequence: trials interleaved step by step with seeded
    scores (ties included)."""
    rng = random.Random(seed)
    out = []
    for t in range(1, steps + 1):
        for i in range(n_trials):
            out.append((f"t{i}", {"score": round(rng.uniform(0, 1) * (i + 1) + 0.1 * t, 2),
                                  "training_iteration": t}))
    return out


def _decisions(make):
    """Decisions (and PBT's donor and mutated config) of one package's
    scheduler over the script."""
    sched = make()
    trials, out = {}, []
    for tid, metrics in _script():
        trial = trials.setdefault(tid, _T(tid))
        d = sched.on_trial_result(trial, dict(metrics))
        row = [tid, metrics["training_iteration"], d]
        if trial.pbt_exploit is not None:
            row += [trial.pbt_exploit, sched.explore({"lr": 0.01, "momentum": 0.9})]
            trial.pbt_exploit = None
        out.append(row)
    for tid in sorted(trials)[:2]:
        sched.on_trial_complete(trials[tid], None)
    out.append([sched.on_trial_result(trials["t5"], {"score": 0.5, "training_iteration": 13})])
    return out


@pytest.mark.parametrize("kind", ["asha", "median", "pbt"])
def test_scheduler_decisions_equal(kind):
    def maker(tune, sched):
        if kind == "asha":
            return lambda: tune.ASHAScheduler(metric="score", mode="max", max_t=12, grace_period=1,
                                              reduction_factor=2)
        if kind == "median":
            return lambda: tune.MedianStoppingRule(metric="score", mode="max", grace_period=2,
                                                   min_samples_required=2)
        return lambda: tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3, quantile_fraction=0.34, seed=11,
            hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-1), "momentum": [0.8, 0.9, 0.99]})

    got, want = (_decisions(maker(tune, sched)) for tune, sched, _ in PACKAGES)
    assert got == want
    decisions = {row[2] for row in want if len(row) > 2}
    assert decisions - {t_sched.CONTINUE}, f"the script exercises no {kind} decision"


@pytest.mark.parametrize("kind", ["tpe", "bohb"])
def test_searcher_suggestions_equal(kind):
    def run(tune):
        space = {"x": tune.uniform(-2.0, 2.0), "lr": tune.loguniform(1e-5, 1.0),
                 "act": tune.choice(["a", "b", "c"]), "n": tune.randint(1, 9)}
        if kind == "tpe":
            s = tune.TPESearcher(space, metric="m", mode="max", n_initial=4, seed=3)
        else:
            s = tune.BOHBSearcher(space, metric="m", mode="max", n_initial=4, min_points_in_model=3, seed=3)
        out = []
        for i in range(14):
            cfg = s.suggest(f"t{i}")
            out.append(cfg)
            score = -abs(cfg["x"] - 0.3) - 0.1 * cfg["n"]
            if kind == "bohb":
                for it in (1, 2):
                    s.on_trial_result(f"t{i}", {"m": score + 0.01 * it, "training_iteration": it})
            if i % 3 != 2:  # some trials never complete
                s.on_trial_complete(f"t{i}", {"m": score, "training_iteration": 2})
        out.append(json.loads(json.dumps(s.get_state())))
        return out

    got, want = run(t_tune), run(j_tune)
    assert got == want


def _trainable(tune):
    def fn(config):
        for it in range(1, 4):
            tune.report({"score": -((config["x"] - 3) ** 2) + it, "x2": config["x"] * config["k"]})

    return fn


def _sweep(rt, tune, RunConfig, path):
    rt.init(num_cpus=4)
    try:
        grid = tune.Tuner(
            _trainable(tune),
            param_space={"x": tune.grid_search([0, 1, 3, 5]), "k": tune.choice([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=2, seed=4),
            run_config=RunConfig(name="parity", storage_path=path)).fit()
    finally:
        rt.shutdown()
    best = grid.get_best_result()
    return ([(r.trial_id, r.config, r.metrics, r.metrics_history, r.error) for r in grid],
            (best.trial_id, best.config, best.metrics))


def test_grid_sweep_result_grid_equal(tmp_path):
    got = _sweep(ray_tpu_torch, t_tune, TRunConfig, str(tmp_path / "port"))
    want = _sweep(ray_tpu, j_tune, JRunConfig, str(tmp_path / "ref"))
    assert got == want
    assert len(want[0]) == 4 and want[1][1]["x"] == 3
