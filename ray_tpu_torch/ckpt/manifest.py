"""Checkpoint manifests: the atomic-commit and retention layer.

A manifest is the checkpoint — a JSON document naming every array, every
shard's index rectangle in the global array, and the content-addressed
chunk list that holds its bytes. Chunks are shared across manifests; the
manifest is the unit of visibility:

* **two-phase commit**: an attempt writes chunks first (idempotent,
  content-addressed), then its manifest lands in ``manifests/.staging/``
  and is ``os.replace``d into ``manifests/`` only after every
  participating worker's chunk set verified present. A crash anywhere
  before that rename leaves nothing visible — ``list()`` scans committed
  files only, so *an uncommitted manifest is never visible* by
  construction.
* **refcounted retention**: refcounts are derived state — rebuilt on load
  by scanning committed manifests — so they cannot desync from the truth
  on disk the way a persisted side-index can. Releasing a manifest
  decrements its chunks and deletes only those that hit zero; chunks a
  newer checkpoint still references survive top-K eviction.

Reference analogues: the commit protocol is orbax's atomicity contract
(write to a temp dir, rename on finalize) lifted to a content-addressed
store; retention mirrors the train CheckpointManager's top-K semantics.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.ckpt.chunks import ChunkStore
from ray_tpu_torch.util import metrics as _metrics

_chunks_evicted = _metrics.Counter(
    "ckpt.chunk.evicted_total",
    "chunks deleted because their last referencing manifest was released")
_manifests_aborted = _metrics.Counter(
    "ckpt.manifest.aborted_total",
    "checkpoint attempts discarded before commit (worker death, chunk-write failure)")


class CommitAborted(RuntimeError):
    """A manifest failed its pre-commit verification (missing/short chunk,
    missing worker ack): the attempt is discarded, never half-committed."""


class Manifest(dict):
    """The manifest document. Plain dict (JSON round-trips untouched) with
    the derived views the listing/metrics surface needs."""

    @property
    def ckpt_id(self) -> str:
        return self["ckpt_id"]

    @property
    def dedup_ratio(self) -> float:
        """Fraction of the checkpoint's bytes served by chunks that already
        existed (0.0 = full save, →1.0 = nearly-free incremental save)."""
        total = self.get("bytes_total", 0)
        if not total:
            return 0.0
        return 1.0 - self.get("bytes_new", 0) / total

    def chunk_digests(self) -> list[str]:
        out = []
        for entry in self["arrays"].values():
            for shard in entry["shards"]:
                out.extend(d for d, _size in shard["chunks"])
        return out

    def summary(self) -> dict:
        """The controller-registry / listing row."""
        return {
            "ckpt_id": self["ckpt_id"],
            "step": self.get("step"),
            "channel": self.get("channel", ""),
            "status": self.get("status", "committed"),
            "bytes_total": self.get("bytes_total", 0),
            "bytes_new": self.get("bytes_new", 0),
            "dedup_ratio": round(self.dedup_ratio, 4),
            "arrays": len(self.get("arrays", {})),
            "workers": self.get("workers", 1),
            "storage": self.get("storage", ""),
            "committed_ts": self.get("committed_ts"),
        }


def new_ckpt_id(step: int) -> str:
    return f"ck-{int(step):08d}-{uuid.uuid4().hex[:8]}"


def load_manifest(storage_root: str, ckpt_id: str) -> Manifest:
    """Read one COMMITTED manifest straight off shared storage (the
    subscriber-side path: no ManifestStore instance, no refcount scan)."""
    path = os.path.join(os.path.abspath(storage_root), "manifests", ckpt_id + ".json")
    with open(path) as f:
        return Manifest(json.load(f))


class ManifestStore:
    """Single-committer manifest index over shared storage.

    One process (the train controller / save coordinator) owns commits and
    retention for a storage root, exactly like CheckpointManager owns its
    directory; any number of readers may ``load``/``list`` concurrently."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max",
                 chunk_store: Optional[ChunkStore] = None):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "manifests")
        self.staging = os.path.join(self.dir, ".staging")
        os.makedirs(self.staging, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.chunks = chunk_store or ChunkStore(root)
        self._lock = threading.Lock()
        self.evicted_manifests = 0
        self.evicted_chunks = 0
        # Startup repair: staged attempts and chunk tmp files belong to
        # writers that died mid-save — garbage by definition (commit is the
        # rename out of staging). Age-gated: a STALE staged file is dead; a
        # fresh one may be a concurrent committer's write-then-rename in
        # flight on this shared root (several stores may open one root —
        # e.g. the train controller's retention fold beside worker savers).
        now = time.time()
        for name in os.listdir(self.staging):
            path = os.path.join(self.staging, name)
            try:
                if now - os.path.getmtime(path) > 3600:
                    os.unlink(path)
            except OSError:
                pass
        self.chunks.sweep_tmp()
        # refcounts: derived from committed manifests, never persisted.
        self._refs: dict[str, int] = {}
        for ckpt_id in self.list_ids():
            self._bump(load_manifest(self.root, ckpt_id), +1)

    # -- refcounts ------------------------------------------------------
    def _bump(self, manifest: Manifest, delta: int) -> list[str]:
        """Apply ``delta`` to every chunk the manifest references; returns
        the digests that dropped to zero."""
        zeroed = []
        for digest in manifest.chunk_digests():
            n = self._refs.get(digest, 0) + delta
            if n <= 0:
                self._refs.pop(digest, None)
                if delta < 0:
                    zeroed.append(digest)
            else:
                self._refs[digest] = n
        return zeroed

    def refcounts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._refs)

    # -- commit / abort -------------------------------------------------
    def commit(self, manifest: Manifest, new_digests: Optional[set] = None) -> Manifest:
        """Verify then atomically publish one attempt. Raises CommitAborted
        (after discarding the attempt) when any referenced chunk is missing
        or sized wrong — a worker that died mid-save can never produce a
        committed-but-unrestorable manifest."""
        ckpt_id = manifest["ckpt_id"]
        for entry in manifest["arrays"].values():
            for shard in entry["shards"]:
                for digest, size in shard["chunks"]:
                    got = self.chunks.size(digest)
                    if got != size:
                        self.abort(ckpt_id, new_digests)
                        raise CommitAborted(
                            f"{ckpt_id}: chunk {digest[:10]} "
                            f"{'missing' if got is None else f'sized {got}, wanted {size}'}"
                        )
        manifest["status"] = "committed"
        manifest["committed_ts"] = time.time()
        manifest.setdefault("storage", self.root)
        staged = os.path.join(self.staging, ckpt_id + ".json")
        with open(staged, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            self._bump(manifest, +1)
            # THE commit point: one rename flips the attempt visible.
            os.replace(staged, os.path.join(self.dir, ckpt_id + ".json"))
        self._retain()
        return manifest

    def abort(self, ckpt_id: str, new_digests: Optional[set] = None) -> int:
        """Discard an attempt: drop its staged manifest and delete chunks
        this attempt introduced that no committed manifest references.
        Returns the number of chunks deleted."""
        try:
            os.unlink(os.path.join(self.staging, ckpt_id + ".json"))
        except OSError:
            pass
        deleted = 0
        with self._lock:
            for digest in sorted(new_digests or ()):
                if digest not in self._refs and self.chunks.delete(digest):
                    deleted += 1
        _manifests_aborted.inc()
        return deleted

    # -- retention ------------------------------------------------------
    def release(self, ckpt_id: str) -> int:
        """Drop one committed manifest; delete chunks that hit zero refs.
        Returns the number of chunks deleted (idempotent: 0 for unknown)."""
        path = os.path.join(self.dir, ckpt_id + ".json")
        try:
            manifest = load_manifest(self.root, ckpt_id)
        except OSError:
            return 0
        with self._lock:
            try:
                os.unlink(path)
            except OSError:
                return 0
            zeroed = self._bump(manifest, -1)
            deleted = sum(1 for d in zeroed if self.chunks.delete(d))
            self.evicted_manifests += 1
            self.evicted_chunks += deleted
        _chunks_evicted.inc(deleted)
        return deleted

    def _retain(self):
        """Top-K retention, CheckpointManager semantics: keep the K best by
        score (falling back to recency for unscored), newest always safe."""
        if self.num_to_keep is None:
            return
        rows = self.list()
        if len(rows) <= self.num_to_keep:
            return

        def quality(row):
            if self.score_attribute:
                score = (row.get("meta") or {}).get(self.score_attribute)
                if score is None:
                    return (0, row.get("step") or 0)
                return (1, score if self.score_order == "max" else -score)
            return (1, row.get("step") or 0)

        ranked = sorted(rows, key=quality, reverse=True)
        for row in ranked[self.num_to_keep:]:
            self.release(row["ckpt_id"])

    # -- read side ------------------------------------------------------
    def list_ids(self) -> list[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n[:-5] for n in names if n.endswith(".json"))

    def list(self) -> list[dict]:
        """Committed manifests only, oldest first: summary rows plus the
        user meta (the retention scorer reads it)."""
        out = []
        for ckpt_id in self.list_ids():
            try:
                m = load_manifest(self.root, ckpt_id)
            except (OSError, ValueError):
                continue
            row = m.summary()
            row["meta"] = m.get("meta") or {}
            out.append(row)
        out.sort(key=lambda r: (r.get("step") or 0, r["ckpt_id"]))
        return out

    def load(self, ckpt_id: str) -> Manifest:
        return load_manifest(self.root, ckpt_id)

    @property
    def latest(self) -> Optional[Manifest]:
        ids = self.list_ids()
        if not ids:
            return None
        rows = self.list()
        return self.load(rows[-1]["ckpt_id"]) if rows else None

    # -- verification (chaos battery / tests) ---------------------------
    def verify(self) -> dict:
        """Refcount bookkeeping vs the bytes on disk: every referenced
        chunk must exist with zero missing, and every chunk file must be
        referenced (orphans mean eviction leaked storage)."""
        with self._lock:
            refs = dict(self._refs)
        on_disk = set(self.chunks.list_digests())
        referenced = set(refs)
        missing = sorted(referenced - on_disk)
        orphans = sorted(on_disk - referenced)
        return {
            "ok": not missing and not orphans,
            "missing_chunks": missing,
            "orphan_chunks": orphans,
            "chunks": len(on_disk),
            "manifests": len(self.list_ids()),
        }


def registry_summary(manifest: Manifest, status: str = "committed") -> dict:
    """The controller-registry row for one attempt (aborted attempts report
    too — an invisible failure is the observability bug this plane hunts)."""
    row = Manifest(manifest).summary()
    row["status"] = status
    row["ts"] = time.time()
    return row
