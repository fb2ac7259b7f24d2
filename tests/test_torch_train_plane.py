"""The port's train plane on port clusters: the cases of
``tests/test_train.py`` but two, with ``test_jax_trainer_end_to_end`` as
``test_torch_trainer_end_to_end`` (``TorchTrainer`` on the port's tiny CPU
model, checkpoints through ``save_pytree``/``load_pytree``; ``slow``, as the
reference's case is). Left out, for they need TPU slices, which have no GPU
counterpart: ``test_tpu_slice_gang_scheduling`` and
``test_slice_reservation_release_allows_rereserve``.

Train layer tests: gang training, reports, checkpoints, failure recovery.

Multi-node + fake-TPU-topology technique per SURVEY.md §4 (reference:
test_jax_trainer.py:17-57 fakes v6e-8 slices with env vars + resources).
"""
import json
import os
import time

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch import train


def _simple_fn(config):
    ctx = train.get_context()
    for i in range(config["steps"]):
        train.report({"step": i, "rank": ctx.get_world_rank(), "loss": 1.0 / (i + 1)})


def test_data_parallel_trainer_basic(shared_ray, tmp_path):
    trainer = DataParallelTrainer(
        _simple_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="basic", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3
    assert result.metrics["rank"] == 0  # rank-0 metrics are canonical


def _ckpt_fn(config):
    import tempfile

    ctx = train.get_context()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            start = json.load(open(os.path.join(d, "state.json")))["step"] + 1
    for i in range(start, config["steps"]):
        if config.get("die_at") is not None and i == config["die_at"] and not ckpt:
            raise RuntimeError("boom")
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp()
            json.dump({"step": i}, open(os.path.join(d, "state.json"), "w"))
            train.report({"step": i}, checkpoint=Checkpoint.from_directory(d))
        else:
            train.report({"step": i})


def test_checkpoint_and_gang_restart(shared_ray, tmp_path):
    """Worker failure -> whole gang restarts and resumes from checkpoint."""
    trainer = DataParallelTrainer(
        _ckpt_fn,
        train_loop_config={"steps": 5, "die_at": 3},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(
            name="restart", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    with result.checkpoint.as_directory() as d:
        assert json.load(open(os.path.join(d, "state.json")))["step"] == 4
    # resumed from step 3's checkpoint: steps 0,1,2 then 3,4 after restart
    steps = [m["step"] for m in result.metrics_history]
    assert steps[-1] == 4 and 3 in steps


def test_failure_budget_exhausted(shared_ray, tmp_path):
    def bad_fn(config):
        raise ValueError("always fails")

    trainer = DataParallelTrainer(
        bad_fn,
        scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(
            name="fail", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.error is not None and "always fails" in result.error


def test_checkpoint_manager_topk(tmp_path):
    from ray_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(
        str(tmp_path / "runs"), num_to_keep=2,
        score_attribute="acc", score_order="max",
    )
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        src = tmp_path / f"src{i}"
        src.mkdir()
        (src / "x.txt").write_text(str(acc))
        mgr.register(str(src), {"acc": acc})
    assert mgr.best.metrics["acc"] == 0.9
    kept = sorted(p.name for p in (tmp_path / "runs").iterdir() if p.is_dir())
    assert len(kept) == 2  # 0.1 evicted


def _torch_train_fn(config):
    """End-to-end: the port's transformer train loop + save_pytree checkpoint."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.train import Checkpoint, load_pytree, save_pytree

    ctx = train.get_context()
    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, d_ff=64,
        max_seq_len=16, dtype=torch.float32, attention_impl="reference",
    )
    init_state, train_step = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            meta = json.load(open(os.path.join(d, "meta.json")))
            start = meta["step"] + 1
            saved = load_pytree(os.path.join(d, "state"), {"params": state["params"]})
            with torch.no_grad():
                for k, t in saved["params"]["layers"].items():
                    state["params"]["layers"][k].copy_(t)
                for k in ("embed", "final_norm", "lm_head"):
                    state["params"][k].copy_(saved["params"][k])
            state["step"] = int(saved["step"])
    tokens = torch.randint(0, cfg.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    for i in range(start, config["steps"]):
        m = train_step(state, {"tokens": tokens})
        if ctx.get_world_rank() == 0:
            import tempfile

            d = tempfile.mkdtemp()
            save_pytree({"params": state["params"], "step": state["step"]},
                        os.path.join(d, "state"))
            json.dump({"step": i}, open(os.path.join(d, "meta.json"), "w"))
            train.report(
                {"step": i, "loss": float(m["loss"])},
                checkpoint=Checkpoint.from_directory(d),
            )
        else:
            train.report({"step": i, "loss": float(m["loss"])})


@pytest.mark.slow  # heavy battery; tier-1 budget (see CHANGES PR-13)
def test_torch_trainer_end_to_end(shared_ray, tmp_path):
    from ray_tpu_torch.train import TorchTrainer

    trainer = TorchTrainer(
        _torch_train_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(
            name="torch_e2e", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=2),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]
    # top-K retention: only 2 checkpoint dirs remain
    ckpts = [
        p for p in os.listdir(str(tmp_path / "torch_e2e"))
        if p.startswith("checkpoint_") and os.path.isdir(str(tmp_path / "torch_e2e" / p))
    ]
    assert len(ckpts) == 2
    # restored state round-trips through save_pytree/load_pytree
    from ray_tpu_torch.train import load_pytree

    restored = load_pytree(os.path.join(result.checkpoint.path, "state"))
    assert int(restored["step"]) == 3


def test_pg_label_selector_constrains_bundles(fresh_cluster):
    if rt.is_initialized():
        rt.shutdown()
    cluster = fresh_cluster
    cluster.add_node(num_cpus=4, labels={"zone": "a"})
    cluster.add_node(num_cpus=4, labels={"zone": "b"})
    rt.init(address=cluster.address)
    try:
        pg = rt.placement_group(
            [{"CPU": 1}, {"CPU": 1}], strategy="PACK", label_selector={"zone": "b"}
        )
        assert pg.ready(timeout=10)
        zone_b = {
            n["NodeID"] for n in rt.nodes() if n.get("labels", {}).get("zone") == "b"
        }
        assert set(pg.bundle_nodes()) <= zone_b
    finally:
        rt.shutdown()
