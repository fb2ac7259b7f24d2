"""ray_tpu_torch.train: distributed training orchestration (TorchTrainer).

Public surface mirrors the reference's ray.train v2 API (SURVEY.md §2.4):
trainers, ScalingConfig/RunConfig/FailureConfig/CheckpointConfig, Checkpoint,
report()/get_context()/get_checkpoint() from inside the train fn.
"""
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager, load_pytree, save_pytree
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import Result, TrainController

# The grad_sync SUBMODULE import must precede the session import below:
# initializing a submodule sets the package attribute ``train.grad_sync`` to
# the module, and the session's ``grad_sync`` FUNCTION (the public
# ``train.grad_sync(...)`` API) must win that name. The submodule stays
# reachable via ``from ray_tpu_torch.train.grad_sync import ...`` (sys.modules).
from ray_tpu_torch.train.grad_sync import BucketedGradSync, ShardedOptimizerStep
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    grad_sync,
    keep_live,
    live_resume,
    report,
    save_pytree_async,
    sharded_optimizer,
)
from ray_tpu_torch.train.scaling_policy import (
    ElasticScalingPolicy,
    FixedScalingPolicy,
    NoopDecision,
    ResizeDecision,
    ScalingPolicy,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup

__all__ = [
    "BucketedGradSync",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "ElasticScalingPolicy",
    "FailureConfig",
    "FixedScalingPolicy",
    "NoopDecision",
    "ResizeDecision",
    "ScalingPolicy",
    "ShardedOptimizerStep",
    "TorchTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TrainContext",
    "TrainController",
    "TrainWorker",
    "WorkerGroup",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "grad_sync",
    "keep_live",
    "live_resume",
    "load_pytree",
    "report",
    "save_pytree",
    "save_pytree_async",
    "sharded_optimizer",
]
