"""Tune layer: variant generation, ASHA, PBT, trial fault tolerance.

``tests/test_tune.py`` copied case for case onto ``ray_tpu_torch.tune`` and a
port cluster (the port's ``shared_ray`` fixture)."""
import os

import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune.search import generate_variants, grid_search, mutate_config


def test_generate_variants_grid_and_sample():
    space = {
        "lr": tune.loguniform(1e-4, 1e-1),
        "depth": grid_search([2, 4]),
        "opt": {"name": grid_search(["sgd", "adam"]), "momentum": tune.uniform(0, 1)},
    }
    cfgs = generate_variants(space, num_samples=3, seed=0)
    assert len(cfgs) == 3 * 2 * 2
    assert {c["depth"] for c in cfgs} == {2, 4}
    assert {c["opt"]["name"] for c in cfgs} == {"sgd", "adam"}
    assert all(1e-4 <= c["lr"] <= 1e-1 for c in cfgs)
    assert all(0 <= c["opt"]["momentum"] <= 1 for c in cfgs)
    # Deterministic under the same seed.
    assert generate_variants(space, num_samples=3, seed=0) == cfgs


def test_mutate_config():
    import random

    cfg = {"lr": 0.01, "batch": 32, "fixed": "x"}
    out = mutate_config(
        cfg, {"lr": tune.uniform(0.001, 1.0), "batch": [16, 32, 64]},
        random.Random(0),
    )
    assert out["fixed"] == "x"
    assert out["lr"] in (0.008, 0.012) or 0.001 <= out["lr"] <= 1.0
    assert out["batch"] in (16, 32, 64)


def test_tuner_grid_sweep(shared_ray, tmp_path):
    from ray_tpu_torch.train import RunConfig

    def trainable(config):
        score = -((config["x"] - 3) ** 2)
        tune.report({"score": score})

    grid = tune.Tuner(
        trainable,
        param_space={"x": grid_search([0, 1, 2, 3, 4, 5])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="grid", storage_path=str(tmp_path)),
    )
    results = grid.fit()
    assert len(results) == 6
    assert not results.errors
    best = results.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 0


class _FakeTrial:
    def __init__(self, trial_id):
        self.trial_id = trial_id


def test_asha_rung_pruning_unit():
    """Deterministic ASHA semantics: a trial crossing a rung below the
    cutoff stops; rung leaders continue (async-optimism)."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP

    asha = tune.ASHAScheduler(metric="acc", mode="max", max_t=16,
                              grace_period=2, reduction_factor=2)
    strong, weak = _FakeTrial("strong"), _FakeTrial("weak")
    # Strong trial races ahead through rungs 2, 4, 8 — first at each rung,
    # so it always continues.
    for t, acc in [(2, 2.0), (4, 4.0), (8, 8.0)]:
        assert asha.on_trial_result(strong, {"acc": acc, "training_iteration": t}) == CONTINUE
    # Weak trial now crosses rung 2 with a worse value -> pruned.
    assert asha.on_trial_result(weak, {"acc": 0.2, "training_iteration": 2}) == STOP
    # A third trial beating the rung-2 cutoff continues.
    ok = _FakeTrial("ok")
    assert asha.on_trial_result(ok, {"acc": 3.0, "training_iteration": 2}) == CONTINUE
    # max_t is a hard stop for everyone.
    assert asha.on_trial_result(strong, {"acc": 99.0, "training_iteration": 16}) == STOP


def test_asha_sweep_end_to_end(shared_ray, tmp_path):
    from ray_tpu_torch.train import RunConfig

    def trainable(config):
        import time

        for step in range(1, 21):
            tune.report({"acc": config["quality"] * step,
                         "training_iteration": step})
            time.sleep(0.02)

    results = tune.Tuner(
        trainable,
        param_space={"quality": grid_search([0.1, 0.2, 0.5, 1.0])},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max",
            scheduler=tune.ASHAScheduler(
                metric="acc", mode="max", max_t=20, grace_period=2,
                reduction_factor=2,
            ),
        ),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    ).fit()
    assert not results.errors
    best = results.get_best_result()
    assert best.config["quality"] == 1.0
    assert best.metrics["acc"] == pytest.approx(20.0)


def test_trial_checkpoint_and_retry(shared_ray, tmp_path):
    """A crashing trial restarts from its checkpoint when retries remain."""
    from ray_tpu_torch.train import Checkpoint, RunConfig

    def trainable(config):
        import json
        import tempfile

        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["step"]
        for step in range(start + 1, 6):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            tune.report({"step": step}, checkpoint=Checkpoint.from_directory(d))
            if step == 3 and start == 0:
                raise RuntimeError("injected crash at step 3")

    results = tune.Tuner(
        trainable,
        param_space={"x": grid_search([1])},
        tune_config=tune.TuneConfig(metric="step", mode="max",
                                    max_failures_per_trial=1),
        run_config=RunConfig(name="retry", storage_path=str(tmp_path)),
    ).fit()
    assert not results.errors
    r = results[0]
    assert r.metrics["step"] == 5
    # Restarted from step 3's checkpoint: steps 4,5 after the crash, not 1..5.
    steps = [m["step"] for m in r.metrics_history]
    assert steps == [1, 2, 3, 4, 5]


def test_max_concurrent_trials(shared_ray, tmp_path):
    from ray_tpu_torch.train import RunConfig

    def trainable(config):
        tune.report({"ok": 1})

    results = tune.Tuner(
        trainable,
        param_space={"x": grid_search(list(range(5)))},
        tune_config=tune.TuneConfig(metric="ok", mode="max",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="conc", storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 5 and not results.errors

