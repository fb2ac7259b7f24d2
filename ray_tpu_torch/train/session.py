"""Per-worker train session: rank info, report(), checkpoint access.

Role-equivalent to the reference's ray.train session/context
(train.report / train.get_context, python/ray/train/v2/_internal/execution/
context.py): the user train fn calls ``ray_tpu_torch.train.report(metrics,
checkpoint=...)``; the session persists the checkpoint synchronously (the
reference blocks on persistence too) and queues the report for the
controller's next poll.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import uuid
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: "TrainSession | None" = None
_session_lock = threading.Lock()


class TrainSession:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 experiment_name: str, storage_path: str,
                 resume_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[dict] = None,
                 resume_live: Optional[dict] = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: "queue.Queue[dict]" = queue.Queue()
        self.stop_event = threading.Event()
        self._report_seq = 0
        self._async_saver = None  # lazy ckpt-plane AsyncSaver (save_pytree_async)
        self._collective_group: Optional[str] = None  # lazy gang group
        # Elastic plane: the payload a live N->M reshard delivered for THIS
        # rank (train.live_resume()), and the state the train fn registers
        # each step for the next reshard to ship (train.keep_live()).
        self.resume_live = resume_live
        self._live_lock = threading.Lock()
        self._live: Optional[dict] = None

    # -- user API ----------------------------------------------------------
    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        if self.stop_event.is_set():
            raise RuntimeError("training was asked to stop")
        self._report_seq += 1
        entry: dict = {"metrics": dict(metrics), "seq": self._report_seq,
                       "world_rank": self.world_rank}
        if checkpoint is not None:
            # Rank-0 persists by convention (SPMD: identical state everywhere
            # unless the checkpoint itself is sharded per-rank). Persistence
            # happens HERE, worker-side, into storage_path — the controller
            # may live on another host and cannot see this worker's local
            # tempdir (reference: context.py:268 persists inside report()).
            entry["checkpoint_dir"] = self._persist(checkpoint)
        self.reports.put(entry)

    def save_pytree_async(self, tree, metrics: dict, *, mesh: Optional[dict] = None):
        """Checkpoint-plane save: snapshot this worker's shards off the step
        path (ray_tpu_torch/ckpt AsyncSaver double buffer), report() the metrics
        immediately, and hand the controller a manifest_ref dir once the
        background commit lands — the plane's manifests fold into the
        CheckpointManager's top-K retention through that ref. Returns the
        SaveFuture (result() = the committed Manifest).

        Rank-0-persists convention, like report(checkpoint=...): SPMD state
        is identical everywhere, so ONE rank saves and its manifest covers
        the full arrays (each commit here is a single-worker attempt). A
        gang whose ranks hold genuinely DISJOINT shards needs the
        coordinator protocol instead — every rank ckpt.write_part()s its
        local shards and one process ckpt.commit_parts()s the merged
        manifest after all ranks ack."""
        if self._async_saver is None:
            from ray_tpu_torch.ckpt import AsyncSaver

            self._async_saver = AsyncSaver(self.storage_path)
        self._report_seq += 1
        seq = self._report_seq
        fut = self._async_saver.save_async(seq, tree, mesh=mesh, meta=dict(metrics))
        # Metrics ship NOW; the checkpoint_dir rides a SECOND report with
        # the same seq once the commit lands (_absorb_reports merges by
        # seq), so the controller never sees — and never adopts — a staging
        # dir whose manifest_ref is still being written. An aborted save
        # ships no dir at all: restore falls back to the previous
        # checkpoint, the torn-report contract report() already has.
        self.reports.put({"metrics": dict(metrics), "seq": seq,
                          "world_rank": self.world_rank})
        fut.add_done_callback(self._ref_reporter(seq, dict(metrics)))
        return fut

    def _ref_reporter(self, seq: int, metrics: dict):
        """Done-callback for a plane save: materialize the manifest-ref
        staging dir and queue the checkpoint report. Runs on the saver's
        writer thread BEFORE fut.result() unblocks, so a train fn that
        waits on its last save is guaranteed the report is in the queue
        when it returns (the controller's final poll absorbs it)."""

        def _on_done(fut):
            import json

            if fut._error is not None:
                return  # aborted attempt: no dir, nothing to adopt
            manifest = fut._result
            dest = os.path.join(
                os.path.abspath(self.storage_path), ".staging",
                f"ckpt-r{self.world_rank}-s{seq}-{uuid.uuid4().hex[:8]}")
            os.makedirs(dest, exist_ok=True)
            tmp = os.path.join(dest, ".manifest_ref.tmp")
            with open(tmp, "w") as f:
                json.dump({"ckpt_id": manifest["ckpt_id"],
                           "step": manifest.get("step"),
                           "storage": manifest.get("storage")}, f)
            os.replace(tmp, os.path.join(dest, "manifest_ref.json"))
            self.reports.put({"metrics": metrics, "seq": seq,
                              "world_rank": self.world_rank,
                              "checkpoint_dir": dest})

        return _on_done

    def _persist(self, checkpoint: Checkpoint) -> str:
        """Copy a node-local checkpoint dir into shared storage; returns the
        persisted path (a staging dir the CheckpointManager later adopts)."""
        src = os.path.abspath(checkpoint.path)
        storage = os.path.abspath(self.storage_path)
        if src.startswith(storage + os.sep):
            return src  # already under managed storage
        dest = os.path.join(
            storage, ".staging",
            f"ckpt-r{self.world_rank}-s{self._report_seq}-{uuid.uuid4().hex[:8]}",
        )
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copytree(src, dest)
        return dest

    # -- elastic plane (live N->M reshard, ray_tpu_torch/elastic/) ---------------
    def keep_live(self, state: dict, *, sharded: Optional[dict] = None,
                  meta: Optional[dict] = None, copy: bool = True):
        """Register this step's state for live resharding. Call at the END
        of each step with post-step state: on a resize/preemption the
        elastic plane ships exactly this snapshot host-to-host and the
        resumed fn reads it back via train.live_resume().

        ``state``: {path: array} replicated leaves (every rank holds the
        full array). ``sharded``: {path: (flat_1d, lo, n_total)} window
        leaves — this rank's [lo, lo+len) slice of a logical length-n flat
        array (ShardedOptimizerStep.live_shards() emits this shape).
        ``meta``: small picklable dict returned verbatim on resume (step
        counter, optimizer t, rng state...). Leaves are numpy arrays or
        torch tensors (CPU or CUDA).

        Every leaf is copied, whatever ``copy`` says: torch steps update
        parameters and optimizer state IN PLACE (``optimizer.step()``,
        ``add_``), so a parked reference would be torn by the next step. A
        tensor is cloned where it lies (a CUDA clone is queued on the
        step's stream, no device-to-host transfer on the step path: the
        export side moves the bytes to the host when a reshard consumes the
        snapshot); a numpy leaf is copied with np.copy. ``copy=False`` keeps
        the reference's signature; in the reference it parks references to
        immutable jax arrays, which the port does not have."""
        from ray_tpu_torch.util.dtypes import copy_leaf

        if self.stop_event.is_set():
            raise RuntimeError("training was asked to stop")
        state = {k: copy_leaf(v) for k, v in state.items()}
        sharded = {k: (copy_leaf(a), lo, n)
                   for k, (a, lo, n) in (sharded or {}).items()}
        with self._live_lock:
            seq = (self._live["seq"] + 1) if self._live else 1
            self._live = {"state": state, "sharded": dict(sharded or {}),
                          "meta": dict(meta or {}), "seq": seq}

    def live_snapshot(self) -> Optional[dict]:
        """The last keep_live() registration (export path; None when the fn
        never registered — the controller falls back to checkpoints)."""
        with self._live_lock:
            return self._live

    def live_resume(self) -> Optional[dict]:
        """The payload a live reshard delivered for this rank: {"state",
        "sharded", "meta", "seq"} — or None (fresh start / checkpoint
        resume)."""
        return self.resume_live

    def collective_group(self) -> str:
        """Join (once, lazily) this run's host collective gang — group name
        ``train:<experiment>:w<world>``, ranks = the session's world ranks —
        and return the group name. The detached coordinator is reused by
        name across same-size gang restarts (fresh epoch per full re-join);
        the world size is part of the name because a coordinator's world
        size is immutable — an elastic resize rendezvouses on a fresh
        coordinator instead of failing the mismatch check forever. The
        TrainController destroys the run's coordinators best-effort when
        fit() returns; any stragglers are cluster-scoped detached actors,
        gone with the cluster."""
        if self._collective_group is None:
            from ray_tpu_torch import collective as col

            name = f"train:{self.experiment_name}:w{self.world_size}"
            col.init_collective_group(self.world_size, self.world_rank,
                                      group_name=name)
            self._collective_group = name
        return self._collective_group

    def grad_sync(self, **kwargs) -> "BucketedGradSync":
        """The tentpole wiring: a BucketedGradSync bound to this run's gang
        (compute/collective overlap — push() grads as backward produces
        them; see train/grad_sync.py)."""
        from ray_tpu_torch.train.grad_sync import BucketedGradSync

        return BucketedGradSync(self.collective_group(), **kwargs)

    def sharded_optimizer(self, optimizer: str = "adam",
                          **kwargs) -> "ShardedOptimizerStep":
        """A ShardedOptimizerStep bound to this run's gang (reduce-scatter
        grads, shard-sized optimizer state, allgather params)."""
        from ray_tpu_torch.train.grad_sync import ShardedOptimizerStep

        return ShardedOptimizerStep(optimizer,
                                    group_name=self.collective_group(),
                                    **kwargs)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.resume_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        """This worker's split of the named Dataset (a DataIterator)."""
        if name not in self.dataset_shards:
            raise KeyError(
                f"no dataset shard {name!r}; trainer datasets= keys: "
                f"{sorted(self.dataset_shards)}"
            )
        return self.dataset_shards[name]

    def drain_reports(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self.reports.get_nowait())
            except queue.Empty:
                return out


class TrainContext:
    """What get_context() returns inside a train fn."""

    def __init__(self, session: TrainSession):
        self._s = session

    def get_world_rank(self) -> int:
        return self._s.world_rank

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_experiment_name(self) -> str:
        return self._s.experiment_name

    def get_storage_path(self) -> str:
        return self._s.storage_path

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._s.get_checkpoint()

    def get_dataset_shard(self, name: str = "train"):
        return self._s.get_dataset_shard(name)

    def grad_sync(self, **kwargs):
        return self._s.grad_sync(**kwargs)

    def sharded_optimizer(self, optimizer: str = "adam", **kwargs):
        return self._s.sharded_optimizer(optimizer, **kwargs)

    def should_stop(self) -> bool:
        """True once the controller asked this gang to stop (graceful
        resize/reshard): the fn should reach its next step boundary and
        exit (keep_live/report will raise there)."""
        return self._s.stop_event.is_set()


def _set_session(s: "TrainSession | None"):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> Optional[TrainSession]:
    return _session


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None):
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a train worker")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        raise RuntimeError("no active train session in this process")
    return TrainContext(s)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return s.get_checkpoint() if s else None


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    if s is None:
        raise RuntimeError("get_dataset_shard() called outside a train worker")
    return s.get_dataset_shard(name)


def grad_sync(**kwargs):
    """Module-level convenience: the current train session's gang-bound
    BucketedGradSync (raises outside a train worker)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.grad_sync() called outside a train worker")
    return s.grad_sync(**kwargs)


def sharded_optimizer(optimizer: str = "adam", **kwargs):
    """Module-level convenience: a gang-bound ShardedOptimizerStep."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.sharded_optimizer() called outside a train worker")
    return s.sharded_optimizer(optimizer, **kwargs)


def keep_live(state: dict, *, sharded: Optional[dict] = None,
              meta: Optional[dict] = None, copy: bool = True):
    """Register this step's state for live resharding (see
    TrainSession.keep_live)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.keep_live() called outside a train worker")
    s.keep_live(state, sharded=sharded, meta=meta, copy=copy)


def live_resume() -> Optional[dict]:
    """The live-reshard payload for this rank ({"state", "sharded", "meta",
    "seq"}), or None when this incarnation starts fresh / from a
    checkpoint."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.live_resume() called outside a train worker")
    return s.live_resume()


def save_pytree_async(tree, metrics: dict, mesh: Optional[dict] = None):
    """Checkpoint-plane async save from inside a train fn (see
    TrainSession.save_pytree_async)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.save_pytree_async() called outside a train worker")
    return s.save_pytree_async(tree, metrics, mesh=mesh)
