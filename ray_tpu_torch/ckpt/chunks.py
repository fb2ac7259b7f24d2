"""Content-addressed chunk tier: the checkpoint plane's byte store.

Every saved array shard is split into fixed-size chunks and addressed by
its blake2b-20 digest (the same 20-byte width as an ObjectID, so a chunk
can be named on the object plane verbatim). Identity IS the address:

* an unchanged chunk across steps (frozen params, stale optimizer slots)
  hashes to the same digest and is never written twice — incremental saves
  ship only deltas, and the dedup ratio falls out of the write counters;
* a restore can verify integrity for free — re-hash what was read, compare
  to the name (the publication path does exactly this before a hot-swap);
* chunk writes are idempotent, so concurrent savers on shared storage
  cannot conflict: whoever loses the ``os.replace`` race wrote identical
  bytes.

Durability layering: chunk files live on the run's shared storage next to
the node spill tier and are served to restoring hosts with ranged
``pread``s — the same fail-loud discipline as the raw lane's spilled-chunk
serving (node.py ``_spilled_pread``). Restores never materialize a chunk
they only need a slice of.
"""
from __future__ import annotations

import hashlib
import os
import threading

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.util import metrics as _metrics

DIGEST_SIZE = 20  # == core.ids ObjectID width: a chunk digest is a valid oid
_PERSON = b"raytpu-ckpt"

_bytes_written = _metrics.Counter(
    "ckpt.chunk.bytes_written_total",
    "new chunk bytes written by checkpoint saves")
_bytes_deduped = _metrics.Counter(
    "ckpt.chunk.bytes_deduped_total",
    "chunk bytes skipped because an identical chunk already existed")
_bytes_read = _metrics.Counter(
    "ckpt.chunk.bytes_read_total",
    "chunk bytes read by checkpoint restores")


class ChunkCorruption(RuntimeError):
    """A chunk's bytes no longer hash to its name (torn write survived a
    crash, or storage bit rot): fail loud, never hand back wrong weights."""


def chunk_digest(data) -> str:
    """Hex digest that names ``data`` in the chunk tier."""
    return hashlib.blake2b(data, digest_size=DIGEST_SIZE, person=_PERSON).hexdigest()


def split_ranges(nbytes: int, chunk_size: int) -> list[tuple[int, int]]:
    """(offset, length) cover of a shard buffer in chunk_size pieces."""
    if nbytes == 0:
        return [(0, 0)]
    return [(off, min(chunk_size, nbytes - off)) for off in range(0, nbytes, chunk_size)]


class ChunkStore:
    """Content-addressed files under ``<root>/chunks/``.

    Writes are atomic (tmp + ``os.replace``) so a crash mid-write can never
    leave a torn chunk under a valid name — the manifest-commit invariant
    ("a committed manifest is always fully restorable") leans on this.
    Deletion policy lives in the ManifestStore's refcounts; this class only
    moves bytes."""

    def __init__(self, root: str, chunk_size: int | None = None):
        if chunk_size is None:
            from ray_tpu_torch.core import api as _api
            from ray_tpu_torch.core.config import get_config

            # Chunk writers run inside spawned workers: the ADOPTED cluster
            # config, not get_config(), or a head-pushed ckpt_chunk_size
            # would be invisible here (the PR-8 lesson).
            core = getattr(_api, "_global_worker", None)
            cfg = getattr(core, "config", None) or get_config()
            chunk_size = cfg.ckpt_chunk_size
        self.chunk_size = int(chunk_size)
        self.dir = os.path.join(os.path.abspath(root), "chunks")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # Write-side tallies (per-store; the cluster view is the counters).
        self.puts = 0
        self.dedup_hits = 0
        self.bytes_written = 0
        self.bytes_deduped = 0

    def path(self, digest: str) -> str:
        return os.path.join(self.dir, digest)

    def contains(self, digest: str) -> bool:
        return os.path.exists(self.path(digest))

    def size(self, digest: str) -> int | None:
        try:
            return os.path.getsize(self.path(digest))
        except OSError:
            return None

    # -- write path -----------------------------------------------------
    def put(self, data) -> tuple[str, bool]:
        """Store one chunk; returns (digest, newly_written). Dedup by
        existence check — same bytes, same name, one file."""
        digest = chunk_digest(data)
        with self._lock:
            self.puts += 1
            if self.contains(digest):
                self.dedup_hits += 1
                self.bytes_deduped += len(data)
                _bytes_deduped.inc(len(data))
                return digest, False
        fault = _chaos.maybe_inject("ckpt.chunk.write", digest=digest[:16])
        if fault is not None:
            raise fault.error(f"chunk {digest[:10]} ({len(data)} bytes)")
        dest = self.path(digest)
        # pid+tid: two threads racing the same new digest must not share a
        # tmp file (truncate-then-rename would publish a torn chunk).
        tmp = f"{dest}.tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        with self._lock:
            self.bytes_written += len(data)
        _bytes_written.inc(len(data))
        return digest, True

    def put_buffer(self, buf) -> list[tuple[str, int]]:
        """Split one shard buffer into chunks and store each; returns the
        manifest-shaped chunk list ``[(digest, size), ...]``."""
        view = memoryview(buf)
        out = []
        for off, ln in split_ranges(len(view), self.chunk_size):
            digest, _new = self.put(view[off:off + ln])
            out.append((digest, ln))
        return out

    # -- read path ------------------------------------------------------
    def pread(self, digest: str, offset: int, length: int) -> bytes:
        """Ranged read of one chunk (restoring hosts fetch only the byte
        ranges their target shards need). Fail-loud on short reads — a
        silent short chunk would corrupt a weight tensor undetectably."""
        with open(self.path(digest), "rb") as f:
            data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise ChunkCorruption(
                f"chunk {digest[:10]} short read: wanted {length}@{offset}, got {len(data)}"
            )
        _bytes_read.inc(length)
        return data

    def read(self, digest: str, verify: bool = False) -> bytes:
        """Whole-chunk read; ``verify=True`` re-hashes and compares to the
        name (the hot-swap path verifies every chunk before weights go
        live)."""
        with open(self.path(digest), "rb") as f:
            data = f.read()
        if verify and chunk_digest(data) != digest:
            raise ChunkCorruption(f"chunk {digest[:10]} content does not match its digest")
        _bytes_read.inc(len(data))
        return data

    # -- management -----------------------------------------------------
    def delete(self, digest: str) -> bool:
        try:
            os.unlink(self.path(digest))
            return True
        except OSError:
            return False

    def list_digests(self) -> list[str]:
        return sorted(
            name for name in os.listdir(self.dir)
            if len(name) == DIGEST_SIZE * 2 and ".tmp" not in name
        )

    def sweep_tmp(self) -> int:
        """Drop ``.tmp<pid>-<tid>`` files left by writers that DIED mid-put
        (called by the ManifestStore on load). A tmp file whose pid is
        still alive belongs to a concurrent saver on this shared root —
        deleting it would yank a live write out from under its
        ``os.replace``."""
        n = 0
        for name in os.listdir(self.dir):
            if ".tmp" not in name:
                continue
            owner = name.split(".tmp", 1)[1].split("-", 1)[0]
            try:
                if owner.isdigit():
                    os.kill(int(owner), 0)  # raises if the pid is gone
                    continue  # live writer (this or another process): keep
            except OSError:
                pass  # dead pid: sweep it
            try:
                os.unlink(os.path.join(self.dir, name))
                n += 1
            except OSError:
                pass
        return n
