"""Tune and RL on the GPU: each RL learner's update on the card against its
update on the CPU (the same seed-0 parameters, minibatch and, for SAC and
CQL, the same draws; ``chip_smoke.rl_case``), and a Tune trial given
{"GPU": 0.5} that trains on the card.

Runs only where a CUDA device exists (``-m cuda``); elsewhere each test
skips with the reason. On the card, run with ``--noconftest`` (the repo
conftest imports jax).
"""
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the learners' GPU path and GPU trials run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 against the CPU's fp32
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", cs.RL_LEARNERS)
def test_learner_on_the_card_matches_its_cpu_update(dev, name):
    case = cs.rl_case(name)
    gpu, cpu = cs.rl_learner(name, case, dev), cs.rl_learner(name, case, "cpu")
    assert all(t.is_cuda for t in gpu.params.values())
    for i in range(cs.RL_UPDATES):
        got, want = cs.rl_update(name, gpu, case, i), cs.rl_update(name, cpu, case, i)
        for k in want:
            assert abs(got[k] - want[k]) <= cs.RL_TOL * abs(want[k]), (name, i, k, got[k], want[k])
    assert cs.rl_rel_l2(cs.rl_leaves(name, gpu), cs.rl_leaves(name, cpu)) <= cs.RL_TOL


def test_half_card_trial_sees_cuda(dev, tmp_path):
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    def _gpu_trainable(config):  # nested: pickled by value into the trial
        import torch

        x = torch.full((1024,), float(config["x"]), device="cuda")
        tune.report({"sum": float(x.sum()), "cuda": torch.cuda.is_available()})

    rt.init(num_cpus=2, resources={"GPU": 1})
    try:
        grid = tune.Tuner(
            _gpu_trainable, param_space={"x": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(metric="sum", mode="max", resources_per_trial={"GPU": 0.5},
                                        max_concurrent_trials=2),
            run_config=RunConfig(name="cuda-trial", storage_path=str(tmp_path))).fit()
    finally:
        rt.shutdown()
    assert not grid.errors, grid.errors
    assert sorted(r.metrics["sum"] for r in grid) == [1024.0, 2048.0]
    assert all(r.metrics["cuda"] for r in grid)
