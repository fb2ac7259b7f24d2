"""Train configs: ScalingConfig / RunConfig / FailureConfig / CheckpointConfig.

Role-equivalent to the reference's ray.train v2 configs
(python/ray/train/v2/api/config.py:60-112 ScalingConfig with
use_gpu; RunConfig; FailureConfig). ``use_gpu`` takes the place of
``ray_tpu``'s ``use_tpu``: each worker's bundle asks for one GPU unless
``resources_per_worker`` says otherwise (``{"GPU": 0.5}`` packs two ranks on
one card). ``ray_tpu``'s slice fields (``accelerator_type``, ``topology``,
``num_slices``) describe TPU slices and have no GPU counterpart.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict = dataclasses.field(default_factory=dict)
    placement_strategy: str = "PACK"

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        if not res:
            res = {"CPU": 1.0}
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # gang restarts permitted; -1 = unlimited


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # or "min"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    # Live N->M resharding (ray_tpu_torch/elastic/): on a resize decision or
    # a node's drain notice the gang's state moves host-to-host over the
    # raw RPC lane and training resumes at the new world size — no blob-store
    # round trip. Requires the train fn to register state via
    # train.keep_live(); falls back to the checkpoint-restore restart when
    # no live state is registered or the transfer cannot cover the targets.
    elastic_live: bool = False

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "raytpu_results"
        )
        return os.path.join(base, self.name or "train_run")
