"""PBT sweep over four fake nodes (own cluster: init/shutdown).

``tests/test_tune_pbt.py`` on ``ray_tpu_torch``. The reference's nodes are
fake v4-16 TPU slices and each trial asks for {"TPU": 4.0}; the port has
no TPU labels (``ray_tpu.accel.tpu``), so each node here carries one unit
of a custom resource and each trial asks for it: one trial per node, as
there."""
import os

import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune.search import grid_search


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_pbt_improves_population(tmp_path):
    """PBT on four fake nodes: bad lr trials clone good ones and the
    whole population converges (BASELINE.md Tune target)."""
    from ray_tpu_torch.core.api import Cluster
    from ray_tpu_torch.train import Checkpoint, RunConfig

    cluster = Cluster(initialize_head=False)
    nodes = [cluster.add_node(num_cpus=1, resources={"slot": 1.0}) for _ in range(4)]
    rt.init(address=cluster.address)
    try:
        def trainable(config):
            import json
            import tempfile
            import time

            ckpt = tune.get_checkpoint()
            theta = 0.0
            if ckpt:
                with open(os.path.join(ckpt.path, "s.json")) as f:
                    theta = json.load(f)["theta"]
            for step in range(1, 17):
                time.sleep(0.25)  # pace steps so the controller sees
                                  # mid-run results (PBT acts on them)
                # Good lr -> fast approach to 10; lr near 0 -> crawl.
                theta = theta + config["lr"] * (10.0 - theta)
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "s.json"), "w") as f:
                    json.dump({"theta": theta}, f)
                tune.report({"obj": theta, "training_iteration": step},
                            checkpoint=Checkpoint.from_directory(d))

        pbt = tune.PopulationBasedTraining(
            metric="obj", mode="max", perturbation_interval=4,
            hyperparam_mutations={"lr": tune.uniform(0.05, 0.9)},
            quantile_fraction=0.25, seed=0,
        )
        results = tune.Tuner(
            trainable,
            param_space={"lr": grid_search([0.001, 0.002, 0.5, 0.6])},
            tune_config=tune.TuneConfig(
                metric="obj", mode="max", scheduler=pbt,
                resources_per_trial={"slot": 1.0},
            ),
            run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
        ).fit()
        assert not results.errors
        finals = sorted(r.metrics["obj"] for r in results)
        # Without PBT, lr=0.001 ends at ~0.16; with exploit/explore every
        # trial must end well above that.
        assert finals[0] > 2.0, finals
        assert results.get_best_result().metrics["obj"] > 9.0
    finally:
        rt.shutdown()
        cluster.shutdown()


