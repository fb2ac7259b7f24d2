"""Trainers: DataParallelTrainer (generic gang) + TorchTrainer.

Role-equivalent to the reference's DataParallelTrainer
(python/ray/train/v2/api/data_parallel_trainer.py:67, fit at
:155 — wraps the user fn, starts a TrainController actor, blocks on its run)
and TorchTrainer (v2/torch/torch_trainer.py). ``ray_tpu`` has a JaxTrainer in
its place; the backend wiring (the torch.distributed rendezvous) lives in
WorkerGroup.
"""
from __future__ import annotations

from typing import Callable, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import Result, TrainController


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict] = None,
        controller_as_actor: bool = True,
        scaling_policy=None,
    ):
        self.train_fn = train_loop_per_worker
        self.train_config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        # Optional elastic policy (ray_tpu_torch.train.ElasticScalingPolicy);
        # None = FixedScalingPolicy(scaling_config).
        self.scaling_policy = scaling_policy
        # {name: ray_tpu_torch.data.Dataset}; each gets streaming_split across the
        # gang, consumed in the train fn via train.get_dataset_shard(name)
        # (reference: DataParallelTrainer datasets= + data_config.py:13).
        self.datasets = datasets or {}
        self.controller_as_actor = controller_as_actor

    def fit(self) -> Result:
        if not rt.is_initialized():
            rt.init()
        if self.controller_as_actor:
            # Controller runs as an actor (reference pins it to the driver
            # node); its long-running run() must not block poll-style calls,
            # hence a tiny max_concurrency bump.
            Controller = rt.remote(TrainController)
            handle = Controller.options(max_concurrency=2, num_cpus=0).remote(
                self.train_fn, self.train_config, self.scaling, self.run_config,
                datasets=self.datasets, scaling_policy=self.scaling_policy,
            )
            return rt.get(handle.run.remote(), timeout=None)
        return TrainController(
            self.train_fn, self.train_config, self.scaling, self.run_config,
            datasets=self.datasets, scaling_policy=self.scaling_policy,
        ).run()


class TorchTrainer(DataParallelTrainer):
    """Data-parallel torch training over a gang of workers (the counterpart
    of ``ray_tpu``'s ``JaxTrainer``).

    The train fn runs on every worker after the worker group's
    ``setup_distributed``: with ``ScalingConfig(use_gpu=True)`` and more than
    one worker, ``torch.distributed`` is initialized in each rank (NCCL,
    rendezvous at rank 0's address, the communicator made lazily) and torn
    down when the fn ends. Gradients sync over the host ring
    (``train.grad_sync()``), not over NCCL."""
