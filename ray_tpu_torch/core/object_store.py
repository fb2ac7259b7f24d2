"""Python client for the node-local shared-memory object store.

Equivalent to the reference's plasma client + CoreWorkerMemoryStore pairing
(src/ray/core_worker/store_provider/): small objects live in an
in-process dict (``MemoryStore``); large objects live in the node's mmap'd C++
arena (``SharedMemoryClient`` over native/shm_store.cpp) and are read
zero-copy as memoryviews.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Optional

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.native.build import build_lib

_ID_SIZE = 20


class _Pep688Probe:
    def __buffer__(self, flags):
        return memoryview(b"")


try:  # PEP 688 (Python 3.12+): Python classes can export the buffer protocol
    memoryview(_Pep688Probe()).release()
    SUPPORTS_PEP688 = True
except TypeError:
    # Pre-3.12: memoryview() cannot see PinnedBuffer.__buffer__, so zero-copy
    # pinned reads are impossible to do SAFELY (derived views would not hold
    # the eviction pin). Readers degrade to a copy via PinnedBuffer.tobytes().
    SUPPORTS_PEP688 = False


class _Lib:
    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._instance is None:
                lib = ctypes.CDLL(build_lib("shm_store"))
                lib.store_create.restype = ctypes.c_void_p
                lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
                lib.store_attach.restype = ctypes.c_void_p
                lib.store_attach.argtypes = [ctypes.c_char_p]
                lib.store_detach.argtypes = [ctypes.c_void_p]
                lib.store_create_obj.restype = ctypes.c_int64
                lib.store_create_obj.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
                lib.store_seal.restype = ctypes.c_int
                lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.store_seal_pinned.restype = ctypes.c_int64
                lib.store_seal_pinned.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
                ]
                lib.store_get.restype = ctypes.c_int64
                lib.store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
                lib.store_release.restype = ctypes.c_int
                lib.store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.store_contains.restype = ctypes.c_int
                lib.store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.store_delete.restype = ctypes.c_int
                lib.store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.store_evict.restype = ctypes.c_int
                lib.store_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32]
                lib.store_evict_candidates.restype = ctypes.c_int
                lib.store_evict_candidates.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32]
                lib.store_list.restype = ctypes.c_int
                lib.store_list.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
                ]
                for fn in ("store_capacity", "store_used", "store_num_objects"):
                    getattr(lib, fn).restype = ctypes.c_uint64
                    getattr(lib, fn).argtypes = [ctypes.c_void_p]
                cls._instance = lib
            return cls._instance


class ObjectStoreFullError(Exception):
    pass


class ObjectExistsError(Exception):
    pass


class PinnedBuffer:
    """A zero-copy view of a sealed arena object that holds its eviction pin.

    Exports the buffer protocol (PEP 688): ``memoryview(pb)`` — and every
    slice of it, and every ndarray pickle-5 reconstructs over those slices —
    keeps this object alive through the exporter chain, so the pin drops
    exactly when the last derived view is garbage-collected. Without this,
    zero-copy reads would race LRU eviction overwriting live user data
    (which is why _read_shm historically copied)."""

    __slots__ = ("_view", "_store", "_oid")

    def __init__(self, view: memoryview, store: "SharedMemoryClient", oid):
        self._view = view
        self._store = store
        self._oid = oid

    def __buffer__(self, flags):
        # Read-only export: ndarrays reconstructed over these pages must not
        # be able to mutate the sealed object other readers share (plasma
        # maps client reads read-only for the same reason).
        return memoryview(self._view).toreadonly()

    def __len__(self):
        return len(self._view)

    def tobytes(self) -> bytes:
        """Copy-out escape hatch for pre-PEP-688 interpreters (see
        SUPPORTS_PEP688): the copy is safe without pin tracking because it
        shares no pages with the arena."""
        return bytes(self._view)

    def __del__(self):
        try:
            self._view.release()
            self._store.release(self._oid)
        except Exception:
            pass


class SharedMemoryClient:
    """Attach to (or create) a node's shm arena and do zero-copy object IO.

    When ``spill_dir`` is set, allocation pressure spills LRU victims to disk
    instead of dropping them (reference: raylet LocalObjectManager
    src/ray/raylet/local_object_manager.h:109 spill /
    AsyncRestoreSpilledObject:130). The spill directory is shared by every
    process attached to the same arena (daemon + workers), so any of them can
    restore; a spilled object's file name is its hex id, which makes the
    directory self-describing with no extra index.
    """

    def __init__(self, path: str, capacity: int | None = None, create: bool = False, spill_dir: str | None = None):
        self.path = path
        self.spill_dir = spill_dir if spill_dir is not None else path + "_spill"
        self._lib = _Lib.get()
        if create:
            if capacity is None:
                raise ValueError("capacity required to create a store")
            self._h = self._lib.store_create(path.encode(), capacity)
        else:
            self._h = self._lib.store_attach(path.encode())
        if not self._h:
            raise OSError(f"cannot {'create' if create else 'attach'} shm store at {path}")
        fd = os.open(path, os.O_RDWR)
        try:
            self._mmap = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        self._view = memoryview(self._mmap)
        self._lock = threading.Lock()

    # -- write path -----------------------------------------------------
    def create(self, oid: ObjectID, size: int) -> memoryview:
        """Allocate and return a writable view; call seal() when done."""
        with self._lock:
            if self._h is None:
                raise ObjectStoreFullError("store closed")
            off = self._lib.store_create_obj(self._h, oid.binary(), size)
        if off == -1:
            raise ObjectExistsError(oid.hex())
        if off in (-2, -3):
            raise ObjectStoreFullError(f"{size} bytes (used={self.used}/{self.capacity})")
        return self._view[off : off + size]

    def seal(self, oid: ObjectID):
        with self._lock:
            if self._h is None:
                raise KeyError(f"seal: store closed ({oid.hex()})")
            rc = self._lib.store_seal(self._h, oid.binary())
        if rc != 0:
            raise KeyError(f"seal: {oid.hex()} not in created state")

    def abort(self, oid: ObjectID) -> bool:
        """Discard a created-but-unsealed entry. A plain delete() refuses it
        (the writer pin from create() keeps refcount > 0), so a failed writer
        would otherwise leak the allocation AND poison the oid on this node
        forever — every later create raises ObjectExistsError. Seal first
        (drops the writer pin), then delete. Only the writer may call this,
        and only before the object's location is reported, so the transient
        sealed state is unobservable."""
        try:
            self.seal(oid)
        except KeyError:
            pass  # already sealed (failure raced the seal) or never created
        return self.delete(oid)

    def create_autoevict(self, oid: ObjectID, size: int) -> tuple[memoryview, list[ObjectID]]:
        """create(), spilling (if a spill dir exists) or evicting LRU objects
        as needed. Returns (buffer, evicted ids) — truly-evicted objects must
        be reported to the object directory; spilled ones stay available on
        this node and are NOT reported.

        Frees PROGRESSIVELY: a first-fit arena fragments, so "total free >=
        size" does not imply a fitting hole (the create can fail with space
        nominally available). Each round asks for `extra` bytes BEYOND what
        is currently free (spill preferred, then eviction) and doubles
        `extra` until the create lands or nothing freeable remains —
        the reference's plasma create-request queue retries after eviction
        the same way (CreateRequestQueue + fallback allocation)."""
        try:
            return self.create(oid, size), []
        except ObjectStoreFullError:
            pass
        evicted: list[ObjectID] = []
        extra = size + (size >> 3)
        while True:
            # Target = current-available + extra: forces the victim scan past
            # its "already enough available" early-out (fragmented free space
            # is counted available but may fit nothing).
            target = (self.capacity - self.used) + extra
            spilled = self.spill(target)
            freed_any = bool(spilled)
            if not spilled:
                ev = self.evict(target)
                evicted.extend(ev)
                freed_any = bool(ev)
            try:
                return self.create(oid, size), evicted
            except ObjectStoreFullError:
                if not freed_any:
                    raise  # nothing left to free (all pinned): genuine OOM
                extra *= 2

    # -- spilling -------------------------------------------------------
    def spill(self, nbytes: int, max_ids: int = 4096) -> list[ObjectID]:
        """Spill LRU victims to disk until ``nbytes`` would be free; victims
        are deleted from the arena after their payload is durably on disk.
        Returns the spilled ids. No-op (returns []) without a spill dir."""
        if not self.spill_dir:
            return []
        buf = ctypes.create_string_buffer(_ID_SIZE * max_ids)
        with self._lock:
            if self._h is None:
                return []
            n = self._lib.store_evict_candidates(self._h, nbytes, buf, max_ids)
        if n <= 0:
            return []
        os.makedirs(self.spill_dir, exist_ok=True)
        spilled = []
        for i in range(n):
            oid = ObjectID(buf.raw[i * _ID_SIZE : (i + 1) * _ID_SIZE])
            view = self.get(oid)  # pins; skips objects deleted meanwhile
            if view is None:
                continue
            path = os.path.join(self.spill_dir, oid.hex())
            try:
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(view)
                os.replace(tmp, path)
            finally:
                view.release()
                self.release(oid)
            self.delete(oid)
            spilled.append(oid)
        return spilled

    def restore(self, oid: ObjectID, evicted_out: list | None = None) -> bool:
        """Copy a spilled object back into the arena (idempotent; safe under
        concurrent restores from several processes). The spill file is kept
        until the object is deleted, so repeated pressure re-spills cheaply.

        Any ids truly evicted to make room are appended to ``evicted_out`` —
        the caller must report them to the object directory like every other
        create_autoevict caller. Returns False (without raising) when the
        arena cannot fit the object right now; use read_spilled() then."""
        data = self.read_spilled(oid)
        if data is None:
            return False
        try:
            evicted = self.put(oid, data)
            if evicted_out is not None:
                evicted_out.extend(evicted)
        except ObjectExistsError:
            pass  # another process restored it first
        except ObjectStoreFullError:
            return False  # remaining residents pinned; payload stays on disk
        return True

    def read_spilled(self, oid: ObjectID) -> Optional[bytes]:
        """Read a spilled payload straight off disk (no arena allocation)."""
        if not self.spill_dir:
            return None
        try:
            with open(os.path.join(self.spill_dir, oid.hex()), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def spilled_size(self, oid: ObjectID) -> Optional[int]:
        if not self.spill_dir:
            return None
        try:
            return os.path.getsize(os.path.join(self.spill_dir, oid.hex()))
        except OSError:
            return None

    def is_spilled(self, oid: ObjectID) -> bool:
        return bool(self.spill_dir) and os.path.exists(os.path.join(self.spill_dir, oid.hex()))

    def put(self, oid: ObjectID, data: bytes | memoryview) -> list[ObjectID]:
        buf, evicted = self.create_autoevict(oid, len(data))
        buf[:] = data
        self.seal(oid)
        return evicted

    # -- read path ------------------------------------------------------
    def get(self, oid: ObjectID) -> Optional[memoryview]:
        """Pinned zero-copy view, or None. Pair with release()."""
        size = ctypes.c_uint64()
        with self._lock:
            if self._h is None:
                return None
            off = self._lib.store_get(self._h, oid.binary(), ctypes.byref(size))
        if off < 0:
            return None
        return self._view[off : off + size.value]

    def seal_pinned(self, oid: ObjectID) -> "Optional[PinnedBuffer]":
        """Seal a just-written object and atomically keep it pinned (the
        writer pin becomes the returned buffer's read pin) — no window in
        which another arena client's eviction could reap it."""
        size = ctypes.c_uint64()
        with self._lock:
            if self._h is None:
                return None
            off = self._lib.store_seal_pinned(self._h, oid.binary(), ctypes.byref(size))
        if off < 0:
            return None
        return PinnedBuffer(self._view[off : off + size.value], self, oid)

    def get_pinned(self, oid: ObjectID) -> "Optional[PinnedBuffer]":
        """Zero-copy read whose pin lives as long as the buffer (and any
        memoryview/ndarray derived from it): deserialization can wrap arena
        pages directly — eviction/delete refuse pinned entries, so the pages
        cannot be reused under a live view. The plasma-Buffer equivalent
        (reference: plasma client Buffer holds the object reference until
        destruction), done with PEP-688 __buffer__ instead of a C extension."""
        view = self.get(oid)
        if view is None:
            return None
        return PinnedBuffer(view, self, oid)

    def release(self, oid: ObjectID):
        # Locked like get(): close() nulls the handle under this lock, so a
        # release racing shutdown no-ops instead of entering native code on
        # a detached handle (callers run on arbitrary threads).
        with self._lock:
            if self._h is None:
                return
            self._lib.store_release(self._h, oid.binary())

    def get_copy(self, oid: ObjectID) -> Optional[bytes]:
        view = self.get(oid)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            self.release(oid)

    # -- management -----------------------------------------------------
    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            if self._h is None:
                return False
            return bool(self._lib.store_contains(self._h, oid.binary()))

    def contains_or_spilled(self, oid: ObjectID) -> bool:
        return self.contains(oid) or self.is_spilled(oid)

    def reap(self, oid: ObjectID) -> bool:
        """Delete if present; True when the object no longer exists (deleted
        now or already gone), False ONLY while a pin defers the delete —
        the retry-loop contract (plain delete() conflates missing with
        pinned, which would retry tombstones forever)."""
        with self._lock:
            if self._h is None:
                return True  # store closed: nothing exists anymore
            return self._lib.store_delete(self._h, oid.binary()) != -2

    def delete(self, oid: ObjectID, drop_spilled: bool = False) -> bool:
        # A delete_objects notify can still be dispatched on the daemon loop
        # after stop() closed the store (the dispatch task was already
        # queued): a native call on the detached handle is a segfault, not
        # an error (observed as a ~1/3-flaky SIGSEGV in bench teardown).
        with self._lock:
            if self._h is None:
                return False
            ok = self._lib.store_delete(self._h, oid.binary()) == 0
        if drop_spilled and self.spill_dir:
            try:
                os.unlink(os.path.join(self.spill_dir, oid.hex()))
                ok = True
            except OSError:
                pass
        return ok

    def evict(self, nbytes: int, max_ids: int = 4096) -> list[ObjectID]:
        buf = ctypes.create_string_buffer(_ID_SIZE * max_ids)
        with self._lock:
            if self._h is None:
                return []
            n = self._lib.store_evict(self._h, nbytes, buf, max_ids)
        return [ObjectID(buf.raw[i * _ID_SIZE : (i + 1) * _ID_SIZE]) for i in range(n)]

    def list_objects(self, max_ids: int = 65536) -> list[tuple[ObjectID, int]]:
        """(id, size) of every sealed resident object; add is_spilled files
        separately if needed."""
        ids = ctypes.create_string_buffer(_ID_SIZE * max_ids)
        sizes = (ctypes.c_uint64 * max_ids)()
        with self._lock:
            if self._h is None:
                return []
            n = self._lib.store_list(self._h, ids, sizes, max_ids)
        return [
            (ObjectID(ids.raw[i * _ID_SIZE : (i + 1) * _ID_SIZE]), int(sizes[i]))
            for i in range(n)
        ]

    @property
    def capacity(self) -> int:
        return 0 if self._h is None else self._lib.store_capacity(self._h)

    @property
    def used(self) -> int:
        return 0 if self._h is None else self._lib.store_used(self._h)

    @property
    def num_objects(self) -> int:
        return 0 if self._h is None else self._lib.store_num_objects(self._h)

    def close(self):
        # Null the handle BEFORE detaching (under the read lock): any later
        # call sees None and no-ops instead of entering native code on a
        # dead handle/unmapped arena. The loser of two concurrent closes
        # sees None after the locked swap and returns.
        with self._lock:
            h, self._h = self._h, None
        if h:
            self._lib.store_detach(h)
            try:
                self._view.release()
                self._mmap.close()
            except BufferError:
                # Zero-copy views handed to callers are still alive; the
                # mapping stays until they are dropped (process exit cleans up).
                pass


class MemoryStore:
    """In-process store for small / inlined objects (reference:
    CoreWorkerMemoryStore, store_provider/memory_store)."""

    def __init__(self):
        self._data: dict[ObjectID, bytes] = {}
        self._lock = threading.Lock()

    def put(self, oid: ObjectID, data: bytes):
        with self._lock:
            self._data[oid] = data

    def get(self, oid: ObjectID) -> Optional[bytes]:
        with self._lock:
            return self._data.get(oid)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._data

    def delete(self, oid: ObjectID):
        with self._lock:
            self._data.pop(oid, None)

    def __len__(self):
        return len(self._data)
