"""Elastic training plane: live N->M resharding without a disk
round-trip.

On a node's preemption notice (drain -> grace -> drop) or an autoscaler
resize, the train gang's state — params, optimizer shard windows, step
meta — redistributes host-to-host over the raw-frame RPC lane using the
same shard-rectangle intersection math the checkpoint plane uses against
chunk stores (arxiv 2112.01075), and the session resumes at the new world size
with a re-keyed gang coordinator. The blob store is never touched; the
checkpoint-restore restart remains the fallback for every failure mode.

Layers:
* ``plan``     — rectangle/span geometry + exact-once multi-source planning
                 (shared with ckpt/restore.py);
* ``transfer`` — zero-pickle raw-lane byte-run shipping with per-source
                 failover (chaos site ``elastic.reshard.transfer``);
* ``resize``   — controller orchestration: export -> membership -> pull ->
                 resume, fenced by the cluster-wide resize epoch.
"""
from ray_tpu_torch.elastic.plan import (
    CoverageError,
    Run,
    norm_index,
    overlap_spans,
    plan_pull,
    rect_nbytes,
    rotated,
    window_rect,
)
from ray_tpu_torch.elastic.transfer import (
    ElasticTransferError,
    export_state,
    pull_state,
    release,
)

__all__ = [
    "CoverageError",
    "ElasticTransferError",
    "Run",
    "export_state",
    "norm_index",
    "overlap_spans",
    "plan_pull",
    "pull_state",
    "rect_nbytes",
    "release",
    "rotated",
    "window_rect",
]
