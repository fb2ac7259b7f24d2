"""Checkpoint & weight-publication plane.

The pipeline, end to end:

1. **Async sharded save** (saver.py): each worker snapshots its local
   array shards device→host into a double buffer off the step path, splits
   them into content-addressed chunks (chunks.py; blake2b-20 digest = chunk
   id) and writes only chunks that don't already exist — incremental saves
   ship deltas.
2. **Atomic manifest commit** (manifest.py): the coordinator merges every
   worker's acked part and renames ONE manifest file into place; any
   failure discards the attempt. A committed manifest is always fully
   restorable; an uncommitted one is never visible.
3. **Resharded restore** (restore.py): a target shard pulls only the byte
   ranges it needs from the source layout's chunks — N-host checkpoints
   restore onto M hosts with no host seeing the full state.
4. **Weight publication** (publish.py): committed manifests on a named
   channel fan out through the controller; serve/llm replicas fetch,
   digest-verify, and hot-swap in place under their admission gate.

Chaos sites ``ckpt.chunk.write`` / ``ckpt.worker.kill_mid_save`` /
``ckpt.publish.swap`` are woven through (scenario ``ckpt_kill_mid_save``);
metrics ride the standard reporter→controller→/metrics pipeline.
"""
from ray_tpu_torch.ckpt.chunks import ChunkCorruption, ChunkStore, chunk_digest
from ray_tpu_torch.ckpt.manifest import (
    CommitAborted,
    Manifest,
    ManifestStore,
    load_manifest,
    new_ckpt_id,
)
from ray_tpu_torch.ckpt.publish import (
    WeightSubscriber,
    latest_on_channel,
    publish_checkpoint,
    register_manifest,
)
from ray_tpu_torch.ckpt.restore import fetch_region, overlap_spans, restore, restore_tree
from ray_tpu_torch.ckpt.saver import (
    AsyncSaver,
    SaveFuture,
    WorkerKilledMidSave,
    commit_parts,
    snapshot_tree,
    write_part,
)

__all__ = [
    "AsyncSaver",
    "ChunkCorruption",
    "ChunkStore",
    "CommitAborted",
    "Manifest",
    "ManifestStore",
    "SaveFuture",
    "WeightSubscriber",
    "WorkerKilledMidSave",
    "chunk_digest",
    "commit_parts",
    "fetch_region",
    "latest_on_channel",
    "load_manifest",
    "new_ckpt_id",
    "overlap_spans",
    "publish_checkpoint",
    "register_manifest",
    "restore",
    "restore_tree",
    "snapshot_tree",
    "write_part",
]
