"""The port's native shared-memory store (``ray_tpu_torch/core/native``,
its own copy of ``shm_store.cpp`` built by its own ``build.py``): the cases
of ``tests/test_object_store.py`` on that build. The two cases that need a
session share one module-scoped port cluster."""
import os

import pytest

# Triage-friendly collection: a host without a working g++ (or with a broken
# native toolchain) must SKIP these tests with the compiler error as the
# reason, not explode at collection/fixture time.
try:
    from ray_tpu_torch.core.native.build import build_lib

    build_lib("shm_store")
    _NATIVE_ERR = None
except Exception as e:  # pragma: no cover - toolchain-dependent
    _NATIVE_ERR = f"{type(e).__name__}: {e}"

# Per-test, not module-wide: test_memory_store is pure Python and must keep
# running on toolchain-less hosts.
needs_native = pytest.mark.skipif(
    _NATIVE_ERR is not None, reason=f"native shm store unavailable: {_NATIVE_ERR}"
)

# The module import itself is pure Python (the C library compiles lazily on
# first store construction), so these names are importable either way.
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import (
    SUPPORTS_PEP688,
    MemoryStore,
    ObjectExistsError,
    ObjectStoreFullError,
    SharedMemoryClient,
)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as port_api

    rt.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    yield rt
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def test_native_build_is_the_ports_own():
    """The port compiles its own copy of the store, beside its own source."""
    import ray_tpu_torch.core.native.build as port_build
    from ray_tpu_torch.core import object_store

    path = port_build.build_lib("shm_store")
    native = os.path.join("ray_tpu_torch", "core", "native")
    assert os.path.dirname(path).endswith(native)
    assert os.path.exists(os.path.join(os.path.dirname(path), "shm_store.cpp"))
    assert object_store.__name__.startswith("ray_tpu_torch.")


@pytest.fixture
def store(tmp_path):
    path = str(tmp_path / "store")
    s = SharedMemoryClient(path, capacity=4 * 1024 * 1024, create=True)
    yield s
    s.close()


@needs_native
def test_put_get_roundtrip(store):
    oid = ObjectID.from_put()
    data = os.urandom(1000)
    store.put(oid, data)
    assert store.contains(oid)
    assert store.get_copy(oid) == data


@needs_native
def test_create_seal_zero_copy(store):
    oid = ObjectID.from_put()
    buf = store.create(oid, 8)
    buf[:] = b"abcdefgh"
    del buf
    assert not store.contains(oid)  # not sealed yet
    store.seal(oid)
    view = store.get(oid)
    assert bytes(view) == b"abcdefgh"
    view.release()
    store.release(oid)


@needs_native
def test_duplicate_create_raises(store):
    oid = ObjectID.from_put()
    store.put(oid, b"x")
    with pytest.raises(ObjectExistsError):
        store.create(oid, 1)


@needs_native
def test_delete(store):
    oid = ObjectID.from_put()
    store.put(oid, b"x")
    assert store.delete(oid)
    assert not store.contains(oid)
    assert store.get(oid) is None


@needs_native
def test_pinned_object_not_deleted(store):
    oid = ObjectID.from_put()
    store.put(oid, b"hello")
    view = store.get(oid)  # pins
    assert not store.delete(oid)
    view.release()
    store.release(oid)
    assert store.delete(oid)


@needs_native
def test_lru_eviction_under_pressure(store):
    oids = []
    for _ in range(8):
        oid = ObjectID.from_put()
        store.put(oid, os.urandom(700 * 1024))
        oids.append(oid)
    # 8 * 700KB > 4MB: the oldest objects must have been evicted.
    assert store.num_objects < 8
    assert store.contains(oids[-1])
    assert not store.contains(oids[0])


@needs_native
def test_pinned_objects_survive_eviction(store):
    first = ObjectID.from_put()
    store.put(first, os.urandom(700 * 1024))
    view = store.get(first)  # pin
    for _ in range(8):
        store.put(ObjectID.from_put(), os.urandom(400 * 1024))
    assert store.contains(first)
    view.release()
    store.release(first)


@needs_native
def test_oversize_object_rejected(store):
    with pytest.raises(ObjectStoreFullError):
        store.put(ObjectID.from_put(), b"x" * (8 * 1024 * 1024))


@needs_native
def test_cross_client_visibility(store, tmp_path):
    other = SharedMemoryClient(str(tmp_path / "store"))
    oid = ObjectID.from_put()
    store.put(oid, b"shared")
    assert other.get_copy(oid) == b"shared"
    other.close()


@needs_native
def test_free_list_reuse(store):
    # Fill, delete, refill — allocator must reuse space (coalescing).
    for _ in range(3):
        oids = []
        for _ in range(4):
            oid = ObjectID.from_put()
            store.put(oid, os.urandom(900 * 1024))
            oids.append(oid)
        for oid in oids:
            store.delete(oid)
    assert store.used < 100 * 1024


def test_memory_store():
    ms = MemoryStore()
    oid = ObjectID.from_put()
    ms.put(oid, b"v")
    assert ms.contains(oid)
    assert ms.get(oid) == b"v"
    ms.delete(oid)
    assert not ms.contains(oid)


@pytest.mark.skipif(
    not SUPPORTS_PEP688,
    reason="zero-copy pinned reads need PEP 688 (__buffer__), Python 3.12+; "
    "pre-3.12 interpreters read shm objects through a safe copy instead",
)
@needs_native
def test_pinned_buffer_zero_copy_get(port_rt):
    """get() of a big ndarray views the arena zero-copy: the array is
    read-only, the object stays pinned (undeletable) while the array lives,
    and the pin drops when the array is collected."""
    import gc

    import numpy as np

    from ray_tpu_torch.core import api as _api

    rt = port_rt
    src = np.arange(1 << 20, dtype=np.int64)  # 8MB, well over inline cap
    ref = rt.put(src)
    arr = rt.get(ref, timeout=60)
    np.testing.assert_array_equal(arr, src)
    assert not arr.flags.writeable  # shared pages must be read-only
    store = _api._require_worker().store
    assert store is not None
    # Pinned by the live view: delete must refuse.
    assert not store.delete(ref.id)
    del arr
    gc.collect()
    assert store.delete(ref.id)  # pin dropped with the last view


@needs_native
def test_big_object_get_any_interpreter(port_rt):
    """Value correctness of a big shm-object get on EVERY interpreter: on
    3.12+ the read is a zero-copy pinned view; pre-3.12 it degrades to a
    safe copy (deserialize's PinnedBuffer fallback) — either way the bytes
    must round-trip."""
    import numpy as np

    rt = port_rt
    src = np.arange(1 << 20, dtype=np.int64)  # 8MB, well over inline cap
    ref = rt.put(src)
    np.testing.assert_array_equal(rt.get(ref, timeout=60), src)
