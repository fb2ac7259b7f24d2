"""The port's elastic plane on port clusters: the cases of
``tests/test_train_elastic.py``, case for case.

Elastic train: ScalingPolicy-driven gang resize (reference:
train/v2/_internal/execution/scaling_policy/ + controller.py:183
_execute_resize_decision). A fake cluster gains a node mid-run; the gang
grows to the new capacity, resumes from the latest checkpoint, and finishes
without losing progress or consuming the failure budget."""
import json
import os
import tempfile
import time

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch import train
from ray_tpu_torch.core.api import Cluster
from ray_tpu_torch.train import (
    Checkpoint,
    DataParallelTrainer,
    ElasticScalingPolicy,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)


@pytest.fixture
def elastic_cluster():
    cluster = Cluster(initialize_head=False)
    cluster.add_node(num_cpus=1)  # head: room for exactly ONE train worker
    rt.init(address=cluster.address)
    yield cluster
    rt.shutdown()
    cluster.shutdown()


def _elastic_fn(config):
    ctx = train.get_context()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            start = json.load(open(os.path.join(d, "state.json")))["step"] + 1
    for i in range(start, config["steps"]):
        time.sleep(0.3)  # slow steps: give the resize a window
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp()
            json.dump({"step": i}, open(os.path.join(d, "state.json"), "w"))
            train.report(
                {"step": i, "world_size": ctx.get_world_size()},
                checkpoint=Checkpoint.from_directory(d),
            )
            marker = config.get("progress_marker")
            if marker and i >= 2:
                open(marker, "w").close()
        else:
            train.report({"step": i, "world_size": ctx.get_world_size()})


def test_gang_grows_when_cluster_gains_a_node(elastic_cluster):
    tmp = tempfile.mkdtemp()
    marker = os.path.join(tmp, "progress")
    trainer = DataParallelTrainer(
        _elastic_fn,
        train_loop_config={"steps": 12, "progress_marker": marker},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(
            name="elastic", storage_path=tmp,
            failure_config=FailureConfig(max_failures=0),  # resize must not consume this
        ),
        scaling_policy=ElasticScalingPolicy(
            ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
            min_workers=1, max_workers=2, resize_cooldown_s=0.5,
        ),
        controller_as_actor=False,  # in-driver controller: we add the node mid-run
    )

    import threading

    def add_node_later():
        # Deterministic trigger: wait until the 1-worker gang has really made
        # progress (rank 0 marks step >= 2), THEN grow the cluster.
        deadline = time.time() + 60
        while not os.path.exists(marker) and time.time() < deadline:
            time.sleep(0.1)
        elastic_cluster.add_node(num_cpus=1)

    t = threading.Thread(target=add_node_later, daemon=True)
    t.start()
    result = trainer.fit()
    t.join()
    assert result.error is None
    # Finished all steps; final checkpoint is the last step.
    with result.checkpoint.as_directory() as d:
        assert json.load(open(os.path.join(d, "state.json")))["step"] == 11
    sizes = [m["world_size"] for m in result.metrics_history]
    steps = [m["step"] for m in result.metrics_history]
    # Started at capacity (1 worker), grew to 2 after the node joined.
    assert sizes[0] == 1
    assert sizes[-1] == 2, sizes
    # No lost progress: every step 0..11 reported exactly once in order.
    assert steps == list(range(12)), steps


def test_fixed_policy_never_resizes(elastic_cluster):
    tmp = tempfile.mkdtemp()
    trainer = DataParallelTrainer(
        _elastic_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="fixed", storage_path=tmp),
        controller_as_actor=False,
    )
    elastic_cluster.add_node(num_cpus=1)  # capacity appears; fixed policy ignores it
    result = trainer.fit()
    assert result.error is None
    assert all(m["world_size"] == 1 for m in result.metrics_history)


def _chaos_fn(config):
    """Dies once at step 4 (first incarnation only) while the cluster is
    simultaneously gaining a node — the resize/failure race."""
    ctx = train.get_context()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            start = json.load(open(os.path.join(d, "state.json")))["step"] + 1
    for i in range(start, config["steps"]):
        time.sleep(0.25)
        die_marker = config["die_marker"]
        if ctx.get_world_rank() == 0 and i == 4 and not os.path.exists(die_marker):
            open(die_marker, "w").close()
            os._exit(1)  # hard kill mid-gang, no cleanup
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp()
            json.dump({"step": i}, open(os.path.join(d, "state.json"), "w"))
            train.report(
                {"step": i, "world_size": ctx.get_world_size()},
                checkpoint=Checkpoint.from_directory(d),
            )
            marker = config.get("progress_marker")
            if marker and i >= 2:
                open(marker, "w").close()
        else:
            train.report({"step": i, "world_size": ctx.get_world_size()})


def test_resize_racing_worker_failure(elastic_cluster):
    """Chaos: a node joins (upscale trigger) in the same window a worker
    hard-dies. The gang must restart from the checkpoint, the resize must
    still land, and no step may be lost (VERDICT r3 weak #8)."""
    tmp = tempfile.mkdtemp()
    marker = os.path.join(tmp, "progress")
    die_marker = os.path.join(tmp, "died_once")
    trainer = DataParallelTrainer(
        _chaos_fn,
        train_loop_config={"steps": 10, "progress_marker": marker,
                           "die_marker": die_marker},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(
            name="chaos", storage_path=tmp,
            failure_config=FailureConfig(max_failures=2),
        ),
        scaling_policy=ElasticScalingPolicy(
            ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
            min_workers=1, max_workers=2, resize_cooldown_s=0.5,
        ),
        controller_as_actor=False,
    )

    import threading

    def add_node_when_progressing():
        deadline = time.time() + 60
        while not os.path.exists(marker) and time.time() < deadline:
            time.sleep(0.1)
        # Node joins JUST before the step-4 death: the upscale decision and
        # the gang failure land in the same window.
        elastic_cluster.add_node(num_cpus=1)

    t = threading.Thread(target=add_node_when_progressing, daemon=True)
    t.start()
    result = trainer.fit()
    t.join()
    assert result.error is None, result.error
    assert os.path.exists(die_marker), "failure injection never fired"
    with result.checkpoint.as_directory() as d:
        assert json.load(open(os.path.join(d, "state.json")))["step"] == 9
    steps = [m["step"] for m in result.metrics_history]
    sizes = [m["world_size"] for m in result.metrics_history]
    # Every step reached the metrics stream (restart resumes from the last
    # checkpoint, so repeats are legal; holes are not).
    assert set(steps) >= set(range(10)), steps
    assert steps[-1] == 9
    # The resize survived the chaos: the run ends at the grown world size.
    assert sizes[-1] == 2, sizes
