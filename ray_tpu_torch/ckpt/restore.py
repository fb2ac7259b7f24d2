"""Resharded restore: array redistribution as ranged chunk reads.

An N-host checkpoint restores onto M hosts without any host seeing
the full state (arxiv 2112.01075's framing): each target shard intersects
its index rectangle with every source shard's rectangle, decomposes the
overlap into maximal row-major-contiguous byte runs, maps those runs
through the source shard's chunk list (prefix sums), and ``pread``s only
those byte ranges. Same-layout restore is the degenerate case — one
full-cover overlap per shard, whole-chunk reads.

The rectangle/span geometry lives in ``ray_tpu_torch/elastic/plan.py`` — the
SAME math redistributes live arrays host-to-host in the elastic train
plane; this module is the disk-facing consumer (runs mapped through chunk
lists instead of peer connections).
"""
from __future__ import annotations

import bisect
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.ckpt.chunks import ChunkCorruption, ChunkStore
from ray_tpu_torch.ckpt.manifest import Manifest
# Shared geometry (both planes import the one implementation; the names are
# re-exported here because overlap_spans predates the elastic plane and
# existing callers/tests reach it via ckpt.restore).
from ray_tpu_torch.elastic.plan import norm_index as _norm_index
from ray_tpu_torch.elastic.plan import overlap_spans
from ray_tpu_torch.util import dtypes as _dt
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

_restore_mbs = _metrics.Gauge("ckpt.restore.mb_s", "last checkpoint restore throughput (MB/s)")
_restore_bytes = _metrics.Counter(
    "ckpt.restore.bytes_total", "bytes assembled into restored arrays")


def _chunk_offsets(shard: dict) -> list[int]:
    """Prefix sums of the shard's chunk sizes (compute once per shard,
    bisect per span)."""
    offs = [0]
    for _digest, size in shard["chunks"]:
        offs.append(offs[-1] + size)
    return offs


def read_shard_range(store: ChunkStore, shard: dict, offset: int, length: int,
                     verify: bool = False, offsets: Optional[list] = None) -> bytes:
    """Read [offset, offset+length) of one source shard's buffer: bisect
    the chunk prefix sums to the first touched chunk, then read only the
    needed byte range of each (``verify`` upgrades touched chunks to
    whole-chunk verified reads — the hot-swap path's integrity gate).
    Raises ChunkCorruption if the chunk list cannot cover the range — a
    silent zero-fill would hand back fabricated weights."""
    offs = offsets if offsets is not None else _chunk_offsets(shard)
    want_lo, want_hi = offset, offset + length
    if length and (not shard["chunks"] or want_hi > offs[-1]):
        raise ChunkCorruption(
            f"shard range {offset}+{length} exceeds its chunk list ({offs[-1]} bytes)")
    out = bytearray(length)
    i = max(0, bisect.bisect_right(offs, want_lo) - 1)
    while i < len(shard["chunks"]) and offs[i] < want_hi:
        digest, _size = shard["chunks"][i]
        lo, hi = offs[i], offs[i + 1]
        a = max(want_lo, lo) - lo
        b = min(want_hi, hi) - lo
        if verify:
            data = store.read(digest, verify=True)[a:b]
        else:
            data = store.pread(digest, a, b - a)
        dst = max(want_lo, lo) - want_lo
        out[dst:dst + len(data)] = data
        i += 1
    return bytes(out)


def fetch_region(store: ChunkStore, entry: dict, target_index,
                 verify: bool = False) -> np.ndarray:
    """Assemble one target shard (an index rectangle of one array) from
    whatever source shards overlap it, fetching only the needed ranges."""
    itemsize = _dt.itemsize(entry["dtype"])
    shape = entry["shape"]
    tgt = _norm_index(target_index, shape)
    tgt_shape = tuple(b - a for a, b in tgt)
    buf = bytearray(int(np.prod(tgt_shape)) * itemsize if tgt_shape else itemsize)
    covered = 0
    for shard in entry["shards"]:
        offsets = None
        for src_off, dst_off, nbytes in overlap_spans(
                shard["index"], target_index, itemsize, shape):
            if offsets is None:
                offsets = _chunk_offsets(shard)
            data = read_shard_range(store, shard, src_off, nbytes,
                                    verify=verify, offsets=offsets)
            buf[dst_off:dst_off + nbytes] = data
            covered += nbytes
    if covered < len(buf):
        # Overlaps from replicated source shards can legally re-cover bytes
        # (covered > len is fine); UNDER-covering means the manifest's
        # shards don't tile the target — fail loud, not zeros-as-weights.
        raise ValueError(
            f"target region {target_index} only {covered}/{len(buf)} bytes "
            "covered by the manifest's shards")
    _restore_bytes.inc(len(buf))
    if entry["dtype"] == "bfloat16":
        # numpy has no bfloat16 of its own: a CPU torch tensor owning buf.
        return _dt.from_bytes(buf, "bfloat16", () if not shape else tgt_shape)
    # Over buf itself (writable, no second copy): torch.from_numpy takes it
    # as is on the way to the device.
    arr = np.frombuffer(buf, dtype=np.dtype(entry["dtype"]))
    return arr.reshape(() if not shape else tgt_shape)


def restore(manifest: Manifest, store: Optional[ChunkStore] = None, *,
            target_indices: Optional[dict] = None, verify: bool = False) -> dict:
    """Restore arrays from a committed manifest.

    ``target_indices``: {path: index rectangle} — THIS host's slice of each
    array under the target sharding; paths omitted restore whole. None
    restores every array whole (single-host / driver-side restore).
    Returns {path: ndarray} (flat paths; see ``restore_tree``); a
    bfloat16 array comes back as a CPU torch tensor."""
    store = store or ChunkStore(manifest.get("storage", "."))
    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    nbytes = 0
    with _tracing.span("ckpt.restore", ckpt_id=manifest.get("ckpt_id", "?")):
        for path, entry in manifest["arrays"].items():
            index = (target_indices or {}).get(path)
            if index is None:
                index = [[0, int(d)] for d in entry["shape"]]
            arr = fetch_region(store, entry, index, verify=verify)
            nbytes += int(arr.nbytes)
            out[path] = arr
    elapsed = time.perf_counter() - t0
    if elapsed > 0:
        _restore_mbs.set(nbytes / 1e6 / elapsed)
    return out


def restore_tree(manifest: Manifest, store: Optional[ChunkStore] = None, *,
                 verify: bool = False) -> Any:
    """Whole-tree restore back to the nested structure snapshot_tree saw
    (the weight-publication fetch path)."""
    from ray_tpu_torch.ckpt.saver import _unflatten

    return _unflatten(restore(manifest, store, verify=verify))
