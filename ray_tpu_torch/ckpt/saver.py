"""Async sharded save: the step path pays a snapshot copy, nothing more.

``snapshot_tree`` copies the train state's leaves on the step path — a
CUDA tensor as a device clone, so the step never waits on a device→host
transfer (torch updates state in place, so a reference would not be a
snapshot; the reference's jax leaves are immutable and park uncopied).
The device→host transfer, chunking, hashing, dedup and the manifest
commit all run on a background writer thread behind a one-deep queue: the
classic double buffer — one snapshot being written, one waiting, so at
most two generations of state are ever pinned and the train loop never
blocks unless it laps the writer twice.

Reference analogues: orbax's async checkpointing (the save returns a
future; finalize commits atomically) and the cross-replica sharded weight
update of arxiv 2004.13336 — no host ever materializes the whole state;
each worker writes only its local shards and the coordinator commits the
merged manifest once every worker acked (``write_part``/``commit_parts``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.ckpt.chunks import ChunkStore, split_ranges
from ray_tpu_torch.ckpt.manifest import CommitAborted, Manifest, ManifestStore, new_ckpt_id, registry_summary
from ray_tpu_torch.util import dtypes as _dt
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

_stall_hist = _metrics.Histogram(
    "ckpt.save.stall_s",
    "train-step stall per checkpoint save (snapshot + handoff; the async path's whole step-path cost)",
    boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
)
_save_hist = _metrics.Histogram(
    "ckpt.save.duration_s",
    "background chunk+commit time per checkpoint save",
    boundaries=[0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120],
)
_save_mbs = _metrics.Gauge("ckpt.save.mb_s", "last checkpoint save throughput (MB/s)")


class WorkerKilledMidSave(RuntimeError):
    """Injected (or real) worker death partway through a shard save: the
    attempt's chunks may be partially written; the commit must never land."""


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten nested dict/list/tuple of arrays to {"a/b/0": leaf} paths
    (no jax dependency; round-trips through _unflatten)."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        out[prefix.rstrip("/") or "value"] = tree
        return out
    for key, val in items:
        if "/" in key:
            raise ValueError(f"tree key {key!r} contains '/' (the path separator)")
        out.update(_flatten(val, f"{prefix}{key}/"))
    return out


def _unflatten(flat: dict) -> Any:
    """Inverse of _flatten: "/"-paths back to nested dicts (list levels come
    back as dicts keyed "0","1",... converted to lists when dense)."""
    if set(flat) == {"value"}:
        return flat["value"]
    root: dict = {}
    for path, val in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        fixed = {k: fix(v) for k, v in node.items()}
        if fixed and all(k.isdigit() for k in fixed):
            idxs = sorted(int(k) for k in fixed)
            if idxs == list(range(len(idxs))):
                return [fixed[str(i)] for i in idxs]
        return fixed

    return fix(root)


def _full_index(shape: tuple) -> list[list[int]]:
    return [[0, int(d)] for d in shape]


def snapshot_tree(tree: Any) -> dict[str, dict]:
    """Snapshot THIS process's leaves for a save attempt.

    Returns {path: {"dtype", "shape" (global), "shards": [(index, array)]}}
    where index is the shard's [start, stop) rectangle per dim; a leaf of
    this process is one whole-array shard. Leaves are numpy arrays or torch
    tensors (CPU or CUDA), and every one is COPIED here: torch steps update
    parameters and optimizer state in place, so a parked reference would
    be torn by the next step (the reference parks references because jax
    arrays are immutable). A tensor is cloned where it lies — a CUDA clone
    is queued on the step's stream and costs device bandwidth, not a
    device→host transfer — and the device→host transfer happens on the
    writer thread, off the step path; the double buffer's queue bound caps
    live snapshots at two generations."""
    out: dict[str, dict] = {}
    for path, leaf in _flatten(tree).items():
        if _dt.is_tensor(leaf):
            arr = _dt.copy_leaf(leaf)
        else:
            arr = _dt.host_array(leaf)
            if isinstance(leaf, np.ndarray) and (arr is leaf or arr.base is leaf):
                arr = arr.copy()  # numpy is mutable: snapshot must not alias
        shape = [int(d) for d in arr.shape]
        out[path] = {"dtype": _dt.dtype_name(arr.dtype), "shape": shape,
                     "shards": [(_full_index(shape), arr)]}
    return out


# ---------------------------------------------------------------------------
# The gang protocol: per-worker part write + coordinator-side merge/commit.
# ---------------------------------------------------------------------------


def write_part(chunk_store: ChunkStore, snapshot: dict, *, rank: int = 0,
               step: int = 0, new_out: Optional[set] = None) -> dict:
    """Write one worker's shard snapshot into the chunk tier; returns its
    ack — the part record the coordinator merges. Raising (injected worker
    death, chunk-write failure) leaves idempotent chunks behind but no ack,
    so the attempt can never commit. ``new_out`` (a shared set) accumulates
    newly-written digests AS THEY LAND, so the coordinator can reclaim a
    dead worker's partial writes in its abort — the return value alone is
    lost with the raise."""
    arrays: dict[str, dict] = {}
    new_digests: set = new_out if new_out is not None else set()
    bytes_total = bytes_new = 0
    for path in sorted(snapshot):
        fault = _chaos.maybe_inject("ckpt.worker.kill_mid_save",
                                    step=step, rank=rank, path=path)
        if fault is not None:
            raise WorkerKilledMidSave(
                f"chaos[ckpt.worker.kill_mid_save#{fault.hit}] rank {rank} died "
                f"mid-save at step {step} ({path})")
        entry = snapshot[path]
        shards_out = []
        for index, arr in entry["shards"]:
            # The deferred device→host transfer lands HERE, on the writer
            # thread (CUDA leaves ride the snapshot as device clones).
            buf = _dt.byte_view(_dt.host_array(arr))
            chunks = []
            for off, ln in split_ranges(len(buf), chunk_store.chunk_size):
                digest, new = chunk_store.put(buf[off:off + ln])
                chunks.append([digest, ln])
                bytes_total += ln
                if new and digest not in new_digests:
                    new_digests.add(digest)
                    bytes_new += ln
            shards_out.append({"index": index, "nbytes": len(buf), "chunks": chunks})
        arrays[path] = {"dtype": entry["dtype"], "shape": entry["shape"],
                        "shards": shards_out}
    return {"rank": rank, "arrays": arrays, "bytes_total": bytes_total,
            "bytes_new": bytes_new, "new_chunks": sorted(new_digests)}


def commit_parts(manifest_store: ManifestStore, ckpt_id: str, step: int,
                 parts: list, expected_workers: int, *, mesh: Optional[dict] = None,
                 meta: Optional[dict] = None, channel: str = "") -> Manifest:
    """Coordinator-side commit: merge every worker's part and publish ONE
    manifest — but only when every participating worker acked. A short or
    failed part (worker death mid-save) aborts the whole attempt: its
    already-written new chunks are reclaimed (unless an older committed
    manifest shares them) and nothing becomes visible."""
    acked = [p for p in parts if isinstance(p, dict) and "arrays" in p]
    union_new = set()
    for p in acked:
        union_new.update(p.get("new_chunks", ()))
    if len(acked) != expected_workers:
        deleted = manifest_store.abort(ckpt_id, union_new)
        raise CommitAborted(
            f"{ckpt_id}: {len(acked)}/{expected_workers} workers acked; "
            f"attempt discarded ({deleted} orphaned chunks reclaimed)")
    arrays: dict[str, dict] = {}
    seen_rects: dict[str, set] = {}  # path -> index rectangles already merged
    for p in sorted(acked, key=lambda p: p.get("rank", 0)):
        for path, entry in p["arrays"].items():
            cur = arrays.get(path)
            if cur is None:
                cur = arrays[path] = {"dtype": entry["dtype"], "shape": entry["shape"],
                                      "shards": []}
            elif cur["dtype"] != entry["dtype"] or cur["shape"] != entry["shape"]:
                manifest_store.abort(ckpt_id, union_new)
                raise CommitAborted(
                    f"{ckpt_id}: workers disagree on {path} "
                    f"({cur['dtype']}{cur['shape']} vs {entry['dtype']}{entry['shape']})")
            rects = seen_rects.setdefault(path, set())
            for shard in entry["shards"]:
                # Replicated leaves: several ranks snapshot the SAME
                # rectangle (snapshot_tree dedups only within one process).
                # One copy per rectangle keeps restore I/O single-pass and
                # keeps fetch_region's coverage accounting exact.
                key = tuple(tuple(ix) for ix in shard["index"])
                if key in rects:
                    continue
                rects.add(key)
                cur["shards"].append(shard)
    manifest = Manifest({
        "ckpt_id": ckpt_id, "step": int(step), "channel": channel,
        "mesh": mesh or {}, "meta": meta or {},
        "arrays": arrays,
        "bytes_total": sum(p["bytes_total"] for p in acked),
        "bytes_new": sum(p["bytes_new"] for p in acked),
        "workers": expected_workers,
        "created_ts": time.time(),
    })
    return manifest_store.commit(manifest, union_new)


# ---------------------------------------------------------------------------
# Single-process async saver (the train-session wiring).
# ---------------------------------------------------------------------------


class SaveFuture:
    """Handle for one in-flight save: result() blocks for the committed
    Manifest or re-raises the attempt's failure.

    Done-callbacks run on the writer thread BEFORE result() unblocks: a
    caller that waited on result() observes every callback's side effect
    (the train session leans on this — its checkpoint report is queued
    before the train fn can return)."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[Manifest] = None
        self._error: Optional[BaseException] = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()
        self._finishing = False  # outcome assigned; late registrants run inline

    def add_done_callback(self, cb) -> None:
        """cb(future) — on the writer thread at completion, or inline right
        here when the save already finished. The lock closes the register/
        finish race: a callback is either in the list _finish drains or
        runs inline, never dropped."""
        with self._cb_lock:
            if not self._finishing:
                self._callbacks.append(cb)
                return
        cb(self)

    def _finish(self, result=None, error=None):
        with self._cb_lock:
            self._result, self._error = result, error
            self._finishing = True
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:
                pass  # a callback must not poison the save's outcome
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Manifest:
        if not self._done.wait(timeout):
            raise TimeoutError("checkpoint save still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class AsyncSaver:
    """Double-buffered saver over one storage root.

    ``save_async`` returns after the device→host snapshot (the only
    step-path stall, recorded in ``ckpt.save.stall_s``); a writer thread
    chunks, dedups, commits, folds retention, and registers the outcome —
    committed or aborted — with the controller when a session is live."""

    def __init__(self, storage_path: str, *, chunk_size: Optional[int] = None,
                 num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max",
                 channel: str = ""):
        self.chunks = ChunkStore(storage_path, chunk_size=chunk_size)
        self.manifests = ManifestStore(
            storage_path, num_to_keep=num_to_keep,
            score_attribute=score_attribute, score_order=score_order,
            chunk_store=self.chunks)
        self.channel = channel
        self._q: "queue.Queue" = queue.Queue(maxsize=1)  # the second buffer
        self._thread: Optional[threading.Thread] = None
        # Saves handed off but not yet committed/aborted: the truth
        # wait_idle keys on — queue emptiness alone has a window between
        # the writer's get() and the write starting. Lock-guarded: += from
        # the train thread races -= from the writer otherwise.
        self._pending = 0
        self._pending_lock = threading.Lock()
        self.last_stall_s = 0.0

    # -- user surface ---------------------------------------------------
    def save_async(self, step: int, tree: Any, *, mesh: Optional[dict] = None,
                   meta: Optional[dict] = None) -> SaveFuture:
        t0 = time.perf_counter()
        snapshot = snapshot_tree(tree)
        fut = SaveFuture()
        self._ensure_thread()
        with self._pending_lock:
            self._pending += 1
        # Blocks only when TWO saves are already outstanding (one writing,
        # one queued): the train loop lapped the writer — backpressure is
        # the correct behavior, not unbounded snapshot memory.
        self._q.put((int(step), snapshot, mesh, meta, fut))
        self.last_stall_s = time.perf_counter() - t0
        _stall_hist.observe(self.last_stall_s)
        return fut

    def save(self, step: int, tree: Any, *, mesh: Optional[dict] = None,
             meta: Optional[dict] = None) -> Manifest:
        """Synchronous save (the bench baseline arm): same pipeline, the
        caller just waits for the commit."""
        return self.save_async(step, tree, mesh=mesh, meta=meta).result()

    def wait_idle(self, timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        while self._pending > 0:
            if time.monotonic() > deadline:
                raise TimeoutError("checkpoint writer still busy")
            time.sleep(0.005)

    def close(self):
        """Drain, then stop: queued saves are written (their futures must
        resolve — a dropped save would hang any result() waiter forever),
        the sentinel lands behind them, the thread exits."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=120)
            self._thread = None

    # -- writer thread --------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, name="raytpu-ckpt-writer", daemon=True)
            self._thread.start()

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write_one(*item)
            finally:
                with self._pending_lock:
                    self._pending -= 1

    def _write_one(self, step: int, snapshot: dict, mesh, meta, fut: SaveFuture):
        ckpt_id = new_ckpt_id(step)
        t0 = time.perf_counter()
        new_digests: set = set()
        with _tracing.span("ckpt.save", ckpt_id=ckpt_id, step=step):
            try:
                part = write_part(self.chunks, snapshot, rank=0, step=step,
                                  new_out=new_digests)
                manifest = commit_parts(
                    self.manifests, ckpt_id, step, [part], 1,
                    mesh=mesh, meta=meta, channel=self.channel)
            except BaseException as e:
                self.manifests.abort(ckpt_id, new_digests)
                _register_best_effort(registry_summary(
                    Manifest({"ckpt_id": ckpt_id, "step": step, "channel": self.channel,
                              "arrays": {}, "bytes_total": 0, "bytes_new": 0}),
                    status="aborted"))
                fut._finish(error=e)
                return
        elapsed = time.perf_counter() - t0
        _save_hist.observe(elapsed)
        if elapsed > 0:
            _save_mbs.set(manifest["bytes_total"] / 1e6 / elapsed)
        _register_best_effort(manifest.summary())
        fut._finish(result=manifest)


def _register_best_effort(summary: dict):
    """Ship an attempt's outcome to the controller registry (and, for
    committed manifests on a channel, the publication fan-out). No session
    or no cluster is fine — the manifest store on shared storage stays the
    source of truth."""
    try:
        from ray_tpu_torch.ckpt.publish import register_manifest

        register_manifest(summary)
    except Exception:
        pass
