"""Checkpoints: directory-based user API + controller-side top-K manager.

Role-equivalent to the reference's ray.train Checkpoint (train/_checkpoint.py:56
— "a directory + a pyarrow.fs URI") and CheckpointManager
(train/v2/_internal/execution/checkpoint/checkpoint_manager.py:72 — top-K
retention keyed on a score attribute). Array state goes through
save_pytree/load_pytree, the port's own one-file-per-leaf format.

save_pytree is the SYNCHRONOUS path (blocks the step until every leaf is
written). The checkpoint & weight-publication plane
(ray_tpu_torch/ckpt/) is the async alternative: double-buffered sharded saves,
content-addressed dedup, resharded restore, serve hot-swap — a plane-saved
checkpoint folds into this manager's retention via manifest_ref dirs
(see CheckpointManager._release_manifest).
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.util import metrics as _metrics

_evicted_total = _metrics.Counter(
    "train.checkpoint.evicted_total",
    "checkpoints deleted by top-K retention (manager-side eviction)")


class Checkpoint:
    """A checkpoint is a directory. Construct with from_directory()."""

    def __init__(self, path: str, metrics: Optional[dict] = None):
        self.path = path
        self.metrics = metrics or {}

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="raytpu_ckpt_")
        if os.path.abspath(dest) != os.path.abspath(self.path):
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


_PYTREE_INDEX = "pytree.json"


def save_pytree(tree: Any, path: str):
    """Persist a tree of arrays under directory ``path``, synchronously.

    The port's own format, with no dependency: one raw file per leaf (its
    C-order bytes; bfloat16 as its bytes, a uint8 view) and a JSON index of
    each leaf's path, shape and dtype, written last. Leaves are torch
    tensors (CPU or CUDA), numpy arrays or scalars; nested dicts, lists and
    tuples give the paths (ckpt/saver.py's ``_flatten``). The format is not
    ``ray_tpu``'s (orbax there); reading one with the other is not a goal."""
    from ray_tpu_torch.ckpt.saver import _flatten
    from ray_tpu_torch.util import dtypes as _dt

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = []
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr = _dt.host_array(leaf)
        name = f"leaf_{i:05d}.bin"
        with open(os.path.join(path, name), "wb") as f:
            f.write(_dt.byte_view(arr))
        leaves.append({"path": key, "file": name, "dtype": _dt.dtype_name(arr.dtype),
                       "shape": [int(d) for d in arr.shape]})
    tmp = os.path.join(path, _PYTREE_INDEX + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": 1, "leaves": leaves}, f)
    os.replace(tmp, os.path.join(path, _PYTREE_INDEX))


def load_pytree(path: str, like: Any = None) -> Any:
    """Restore a tree that ``save_pytree`` wrote: CPU torch tensors at the
    saved paths. With ``like`` (a tree of the same paths), each leaf goes
    to the device and dtype of ``like``'s tensor at its path (a numpy leaf
    of ``like`` gives a numpy array of its dtype)."""
    import numpy as np
    import torch

    from ray_tpu_torch.ckpt.saver import _flatten, _unflatten

    path = os.path.abspath(path)
    with open(os.path.join(path, _PYTREE_INDEX)) as f:
        index = json.load(f)
    targets = _flatten(like) if like is not None else {}
    out = {}
    for ent in index["leaves"]:
        with open(os.path.join(path, ent["file"]), "rb") as f:
            buf = bytearray(f.read())
        dtype = getattr(torch, ent["dtype"])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype)).reshape(ent["shape"])
        ref = targets.get(ent["path"])
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        elif isinstance(ref, np.ndarray):
            t = t.numpy().astype(ref.dtype)
        out[ent["path"]] = t
    return _unflatten(out)


class CheckpointManager:
    """Tracks reported checkpoints under storage_path, keeps top-K."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max",
                 manifest_store=None):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        # ckpt-plane fold: a registered dir saved through the checkpoint
        # plane carries a manifest_ref.json naming its manifest; evicting
        # it releases the manifest's chunk refcounts so only chunks no
        # surviving checkpoint references are deleted (ckpt/manifest.py).
        self.manifest_store = manifest_store
        self.evicted_total = 0
        self._index = 0
        # list of (score, index, Checkpoint); score None -> recency ordering
        self._checkpoints: list[tuple[Any, int, Checkpoint]] = []
        os.makedirs(storage_path, exist_ok=True)
        # Orphaned worker-side staging dirs (reports whose worker died before
        # the controller absorbed them) are garbage from a previous run.
        shutil.rmtree(os.path.join(storage_path, ".staging"), ignore_errors=True)
        self._load_state()

    # -- persistence of the manager's own state (controller restart) -------
    def _state_file(self) -> str:
        return os.path.join(self.storage_path, "checkpoint_manager.json")

    def _load_state(self):
        try:
            with open(self._state_file()) as f:
                st = json.load(f)
            self._index = st["index"]
            self._checkpoints = [
                (c["score"], c["index"], Checkpoint(c["path"], c.get("metrics")))
                for c in st["checkpoints"]
                if os.path.isdir(c["path"])
            ]
            if len(self._checkpoints) != len(st["checkpoints"]):
                # Dangling entries: an eviction that crashed after rmtree
                # but before the index repersisted. Filter-and-repersist so
                # a later crash/restart can't resurrect them a second time.
                self._save_state()
        except (OSError, ValueError, KeyError):
            pass

    def _save_state(self):
        st = {
            "index": self._index,
            "checkpoints": [
                {"score": s, "index": i, "path": c.path, "metrics": c.metrics}
                for s, i, c in self._checkpoints
            ],
        }
        tmp = self._state_file() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, self._state_file())

    # -- registration ------------------------------------------------------
    def register(self, src_dir: str, metrics: dict) -> Checkpoint:
        """Adopt a worker-persisted checkpoint dir into managed storage.

        Workers persist into ``storage_path/.staging/`` (session._persist);
        those are renamed into place. Paths outside storage are copied.
        """
        self._index += 1
        dest = os.path.join(self.storage_path, f"checkpoint_{self._index:06d}")
        # A pre-existing dest means the index counter reset (e.g. lost
        # manager state after a crash) — never clobber, skip past it.
        while os.path.exists(dest):
            self._index += 1
            dest = os.path.join(self.storage_path, f"checkpoint_{self._index:06d}")
        src = os.path.abspath(src_dir)
        if src != dest:
            staging_root = os.path.join(os.path.abspath(self.storage_path), ".staging")
            if src.startswith(staging_root + os.sep) and os.path.isdir(src):
                os.replace(src, dest)
            else:
                # Out-of-storage adoption: copy into staging first, then one
                # atomic rename — a crash mid-copy leaves only .staging
                # garbage (swept at startup), never a half-written
                # checkpoint_NNNNNN dir a reload would adopt as valid.
                tmp = os.path.join(staging_root, f"reg-{os.getpid()}-{uuid.uuid4().hex[:8]}")
                os.makedirs(staging_root, exist_ok=True)
                shutil.copytree(src, tmp)
                os.replace(tmp, dest)
                with contextlib.suppress(OSError):
                    os.rmdir(staging_root)  # only when no other stage is live
        ckpt = Checkpoint(dest, dict(metrics))
        score = metrics.get(self.score_attribute) if self.score_attribute else None
        self._checkpoints.append((score, self._index, ckpt))
        self._evict()
        self._save_state()
        return ckpt

    def _evict(self):
        if self.num_to_keep is None or len(self._checkpoints) <= self.num_to_keep:
            return

        def quality(t):
            score, index, _ = t
            if self.score_attribute:
                if score is None:
                    return (0, index)  # unscored: worst tier, recency tiebreak
                return (1, score if self.score_order == "max" else -score)
            return (1, index)  # no score attribute: keep most recent

        ranked = sorted(self._checkpoints, key=quality, reverse=True)
        keep = ranked[: self.num_to_keep]
        for s, i, c in self._checkpoints:
            if (s, i, c) not in keep:
                self._release_manifest(c.path)
                shutil.rmtree(c.path, ignore_errors=True)
                self.evicted_total += 1
                _evicted_total.inc()
        self._checkpoints = [t for t in self._checkpoints if t in keep]

    def _release_manifest(self, path: str) -> None:
        """Chunk-refcount fold for plane-saved checkpoints: the evicted dir
        may be a thin pointer at a manifest — release it so unreferenced
        chunks are reclaimed (shared chunks survive). Without an attached
        manifest_store, one is opened from the ref's storage root: the
        TrainController evicts in a different process than the worker
        savers that commit, so the fold cannot assume a shared instance."""
        try:
            with open(os.path.join(path, "manifest_ref.json")) as f:
                ref = json.load(f)
            ckpt_id = ref["ckpt_id"]
        except (OSError, ValueError, KeyError):
            return
        store = self.manifest_store
        if store is None:
            root = ref.get("storage")
            if not root:
                return
            try:
                from ray_tpu_torch.ckpt import ManifestStore

                # Fresh store per release, never cached: refcounts are
                # derived from the committed manifests on disk, and savers
                # in other processes commit between evictions — a cached
                # scan would under-count and delete chunks a newer
                # manifest references.
                store = ManifestStore(root)
            except Exception:
                return
        try:
            store.release(ckpt_id)
        except Exception:
            pass  # chunk GC is best-effort; verify() surfaces leaks

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=lambda t: t[1])[2]

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        if not self.score_attribute:
            return self.latest
        scored = [t for t in self._checkpoints if t[0] is not None]
        if not scored:
            return self.latest
        pick = max if self.score_order == "max" else min
        return pick(scored, key=lambda t: t[0])[2]
