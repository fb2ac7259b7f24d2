"""``tests/test_tune_search.py`` on ``ray_tpu_torch.tune`` and a port
cluster, case for case (module-level slow, as there). The resume case's
controller script imports the port and no jax.

Tune search layer: Searcher ABC plumbing, TPE model-based search beating
random on a seeded synthetic objective, and sweep-level resume after the
controller dies mid-sweep (reference: tune/search/searcher.py contract,
optuna-style model-based plugins, experiment-state restore)."""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

# Search-algorithm batteries (TPE/BOHB/median-stopping statistical runs dominate the tier-1 budget); tier-1 runs -m "not slow".
pytestmark = pytest.mark.slow

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: E402,F401

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune import TPESearcher, TuneConfig, Tuner


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=8)
    yield
    rt.shutdown()


def _objective(config):
    # Smooth unimodal bowl: best at x=0.3, lr=1e-2.
    x = config["x"]
    lr = config["lr"]
    score = -((x - 0.3) ** 2) - (np.log10(lr) + 2.0) ** 2
    tune.report({"score": float(score)})


def _run_search(search_alg, num_samples, seed, tmp):
    tuner = Tuner(
        _objective,
        param_space={"x": tune.uniform(-2.0, 2.0), "lr": tune.loguniform(1e-5, 1.0)},
        tune_config=TuneConfig(
            num_samples=num_samples, metric="score", mode="max",
            search_alg=search_alg, max_concurrent_trials=1, seed=seed,
        ),
        run_config=RunConfig(name=f"s{seed}-{'tpe' if search_alg else 'rnd'}",
                             storage_path=tmp),
    )
    grid = tuner.fit()
    return max(r.metrics["score"] for r in grid if r.error is None)


def test_tpe_beats_random_on_synthetic_objective(tmp_path):
    n = 24
    best_tpe = _run_search(
        TPESearcher(
            {"x": tune.uniform(-2.0, 2.0), "lr": tune.loguniform(1e-5, 1.0)},
            metric="score", mode="max", n_initial=6, seed=0,
        ),
        n, 0, str(tmp_path),
    )
    best_rnd = _run_search(None, n, 0, str(tmp_path))
    # Same budget: the model-based searcher concentrates near the optimum.
    assert best_tpe > best_rnd, (best_tpe, best_rnd)
    assert best_tpe > -0.4, f"TPE best {best_tpe} nowhere near the optimum"


def test_searcher_observes_and_suggests():
    sp = {"x": tune.uniform(0.0, 1.0)}
    s = TPESearcher(sp, metric="m", mode="max", n_initial=3, seed=1)
    for i in range(6):
        cfg = s.suggest(f"t{i}")
        assert 0.0 <= cfg["x"] <= 1.0
        s.on_trial_complete(f"t{i}", {"m": -abs(cfg["x"] - 0.5)})
    # Post-warmup suggestions are model-based: clustered near 0.5.
    sugg = [s.suggest(f"p{i}")["x"] for i in range(8)]
    assert np.mean(np.abs(np.asarray(sugg) - 0.5)) < 0.35
    # State round-trips through JSON (sweep persistence).
    state = json.loads(json.dumps(s.get_state()))
    s2 = TPESearcher(sp, metric="m", mode="max", n_initial=3, seed=1)
    s2.set_state(state)
    assert len(s2._observations) == len(s._observations)


def test_bohb_learns_from_intermediate_budgets():
    """BOHB's defining behavior vs plain TPE: intermediate results at rung
    budgets feed the model, and the model pool tracks the DEEPEST budget
    with enough observations (reference: tune/search/bohb/ TuneBOHB)."""
    from ray_tpu_torch.tune import BOHBSearcher

    sp = {"x": tune.uniform(0.0, 1.0)}
    s = BOHBSearcher(sp, metric="m", mode="max", n_initial=3,
                     min_points_in_model=3, seed=1)
    # Three trials report at budgets 1 and 2 WITHOUT completing.
    for i in range(3):
        cfg = s.suggest(f"t{i}")
        s.on_trial_result(f"t{i}", {"m": -abs(cfg["x"] - 0.5), "training_iteration": 1})
        s.on_trial_result(f"t{i}", {"m": -abs(cfg["x"] - 0.5), "training_iteration": 2})
    # Model is live from intermediate results alone (budget 2 has 3 points).
    assert len(s._observations) == 3
    assert s._budget_obs.keys() == {1, 2}
    # The controller reports the FINAL result via on_trial_result AND
    # on_trial_complete — the pool must not double-count it.
    s.on_trial_complete("t0", {"m": 0.0, "training_iteration": 2})
    assert len(s._budget_obs[2]) == 3, "final result double-recorded"
    sugg = [s.suggest(f"p{i}")["x"] for i in range(8)]
    assert np.mean(np.abs(np.asarray(sugg) - 0.5)) < 0.35
    # State round-trips (sweep persistence), budgets intact.
    state = json.loads(json.dumps(s.get_state()))
    s2 = BOHBSearcher(sp, metric="m", mode="max", n_initial=3,
                      min_points_in_model=3, seed=1)
    s2.set_state(state)
    assert {int(k) for k in s2._budget_obs} == {1, 2}
    assert len(s2._observations) == 3


def test_bohb_with_asha_end_to_end(tmp_path):
    """BOHB + ASHA sweep through the Tuner: multi-iteration trials report
    per-iteration scores; the sweep finds a near-optimal x and the searcher
    accumulated rung observations along the way."""
    from ray_tpu_torch.tune import ASHAScheduler, BOHBSearcher

    def trainable(config):
        for it in range(1, 5):
            # Score improves with budget; ordering by |x-0.3| is stable.
            tune.report({"score": -abs(config["x"] - 0.3) + 0.01 * it,
                         "training_iteration": it})

    space = {"x": tune.uniform(-2.0, 2.0)}
    searcher = BOHBSearcher(space, metric="score", mode="max",
                            n_initial=4, min_points_in_model=4, seed=3)
    tuner = Tuner(
        trainable,
        param_space=space,
        tune_config=TuneConfig(
            num_samples=16, metric="score", mode="max",
            search_alg=searcher,
            scheduler=ASHAScheduler(metric="score", mode="max", max_t=4,
                                    grace_period=1, reduction_factor=2),
            max_concurrent_trials=1, seed=3,
        ),
        run_config=RunConfig(name="bohb-asha", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    best = max(r.metrics["score"] for r in grid if r.error is None and r.metrics)
    assert best > -0.3, f"BOHB+ASHA best {best} nowhere near optimum"
    assert searcher._budget_obs, "no rung observations reached the searcher"


def test_median_stopping_rule_unit():
    from ray_tpu_torch.tune import MedianStoppingRule
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP

    class T:
        def __init__(self, tid):
            self.trial_id = tid

    rule = MedianStoppingRule(metric="score", mode="max", grace_period=2,
                              min_samples_required=2)
    # Two healthy trials establish the median bar.
    for t in (1, 2, 3):
        assert rule.on_trial_result(T("good1"), {"score": 10.0, "training_iteration": t}) == CONTINUE
        assert rule.on_trial_result(T("good2"), {"score": 9.0, "training_iteration": t}) == CONTINUE
    # Within grace: a bad trial survives.
    assert rule.on_trial_result(T("bad"), {"score": 1.0, "training_iteration": 1}) == CONTINUE
    # Past grace and below the median of running averages: stopped.
    assert rule.on_trial_result(T("bad"), {"score": 1.0, "training_iteration": 2}) == STOP
    # A trial ABOVE the median keeps going at the same step.
    assert rule.on_trial_result(T("good3"), {"score": 12.0, "training_iteration": 2}) == CONTINUE


def test_median_stopping_in_sweep(tmp_path):
    """End-to-end: bad trials stop early (fewer iterations reported), good
    trials run to completion."""
    from ray_tpu_torch.tune import MedianStoppingRule

    def trainable(config):
        import time as _t

        base = config["q"]
        for it in range(1, 7):
            tune.report({"score": base, "training_iteration": it})
            _t.sleep(0.4)  # let the controller poll between reports

    tuner = Tuner(
        trainable,
        param_space={"q": tune.grid_search([1.0, 1.0, 10.0, 10.0])},
        tune_config=TuneConfig(
            num_samples=1, metric="score", mode="max",
            scheduler=MedianStoppingRule(metric="score", mode="max",
                                         grace_period=2, min_samples_required=2),
            max_concurrent_trials=4, seed=0,
        ),
        run_config=RunConfig(name="medstop", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    by_q = {}
    for r in grid:
        if r.error is None and r.metrics:
            by_q.setdefault(r.config["q"], []).append(
                int(r.metrics.get("training_iteration", 0)))
    assert max(by_q[10.0]) == 6, by_q  # good trials ran out the budget
    assert min(by_q[1.0]) < 6, by_q  # at least one bad trial stopped early


_RESUME_SCRIPT = """
import os, sys, json, tempfile
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import TuneConfig, Tuner

MARKS = {marks!r}

def slow_trainable(config):
    import time, uuid, os, json, tempfile
    open(os.path.join(MARKS, f"{{config['i']}}-{{uuid.uuid4().hex[:6]}}"), "w").close()
    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            start = json.load(open(os.path.join(d, "s.json")))["it"] + 1
    for it in range(start, 4):
        time.sleep({sleep})
        d = tempfile.mkdtemp()
        json.dump({{"it": it}}, open(os.path.join(d, "s.json"), "w"))
        tune.report({{"score": config["i"] * 10 + it}}, checkpoint=Checkpoint.from_directory(d))

rt.init(num_cpus=4)
tuner = Tuner(
    slow_trainable,
    param_space={{"i": tune.grid_search([0, 1, 2, 3])}},
    tune_config=TuneConfig(num_samples=1, metric="score", mode="max",
                           max_concurrent_trials=1),
    run_config=RunConfig(name="resume_sweep", storage_path={storage!r}),
    resume={resume},
)
grid = tuner.fit()
print("RESULTS", json.dumps([{{ "id": r.trial_id, "err": bool(r.error), "score": r.metrics.get("score") }} for r in grid]))
rt.shutdown()
"""


def test_sweep_resumes_after_controller_killed(tmp_path):
    repo = str(Path(__file__).resolve().parents[1])
    storage = str(tmp_path / "sweep")
    marks = str(tmp_path / "marks")
    os.makedirs(marks)
    env = dict(os.environ)
    # Phase 1: kill the controller process mid-sweep (trial 0/1 done or
    # running, later trials not started).
    p = subprocess.Popen(
        [sys.executable, "-c",
         _RESUME_SCRIPT.format(repo=repo, marks=marks, storage=storage,
                               sleep=0.4, resume=False)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    deadline = time.time() + 120
    state_file = os.path.join(storage, "resume_sweep", "tune_state.json")
    while time.time() < deadline:
        if os.path.exists(state_file):
            st = json.load(open(state_file))
            if any(t["state"] == "TERMINATED" for t in st["trials"]):
                break
        time.sleep(0.3)
    else:
        p.kill()
        raise AssertionError("no trial terminated before kill window")
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=30)
    runs_phase1 = os.listdir(marks)
    st = json.load(open(state_file))
    done_phase1 = {t["trial_id"] for t in st["trials"] if t["state"] == "TERMINATED"}
    assert done_phase1, st

    # Phase 2: resume completes the sweep without re-running finished trials.
    out = subprocess.run(
        [sys.executable, "-c",
         _RESUME_SCRIPT.format(repo=repo, marks=marks, storage=storage,
                               sleep=0.05, resume=True)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULTS"))
    results = json.loads(line[len("RESULTS "):])
    assert len(results) == 4 and all(not r["err"] for r in results), results
    assert {r["score"] for r in results} == {3, 13, 23, 33}  # all completed through it=3
    # Finished trials did NOT restart: no new marker for their trial index.
    new_runs = set(os.listdir(marks)) - set(runs_phase1)
    done_idx = {int(t.rsplit("_", 1)[-1]) for t in done_phase1}
    for m in new_runs:
        assert int(m.split("-")[0]) not in done_idx, (
            f"finished trial re-executed: {m} (done: {done_idx})"
        )
