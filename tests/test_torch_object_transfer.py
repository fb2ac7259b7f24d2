"""The port's object transfer plane (``ray_tpu_torch.core.rpc`` raw lane, the
node PullManager): the cases of ``tests/test_object_transfer.py`` on port
clusters, plus a torch tensor pulled across nodes on the raw lane.

Streaming object transfer plane: rpc raw-frame lane + node PullManager.

Raw lane (WIRE_VERSION 3): a frame carrying a small pickled header plus an
out-of-band binary payload that is NEVER pickled — the sender writes arena
memoryview slices straight to the transport and the receiver recv's into a
pre-registered destination buffer; keyed-BLAKE2b is verified on the header
before it reaches pickle and streamed over header+payload for the chunk.
PullManager: a window of K chunks in flight per object, chunk ranges striped
across replicas, per-chunk failover to alternate sources, global admission
(max concurrent pulls / max inflight bytes), and same-oid coalescing.
"""
import asyncio
import hashlib
import hmac
import os
import pickle

import pytest

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.ids import ObjectID
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(autouse=True)
def _no_token_leak():
    yield
    rpc.set_auth_token(None)


class _ChunkServer:
    """Minimal raw-lane source: serves slices of one payload."""

    def __init__(self, payload: bytes):
        self.payload = payload
        self.requests = 0

    async def handle_fetch(self, conn, p):
        self.requests += 1
        await conn.send_raw(p["key"], memoryview(self.payload)[p["off"] : p["off"] + p["ln"]])
        return True


# ---------------------------------------------------------------------------
# raw lane wire-level tests
# ---------------------------------------------------------------------------


def test_raw_frame_roundtrip_interleaved_with_envelopes():
    """Chunks ride the raw lane while normal calls keep flowing on the same
    connection; the reassembled payload is byte-identical and was never
    pickled by the sender."""

    async def go():
        payload = os.urandom(3 * 1024 * 1024 + 17)
        srv = _ChunkServer(payload)
        server = rpc.RpcServer(srv)
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            dest = bytearray(len(payload))
            view = memoryview(dest)
            chunk = 512 * 1024
            for off in range(0, len(payload), chunk):
                ln = min(chunk, len(payload) - off)
                key = os.urandom(12)
                fut = conn.expect_raw(key, view[off : off + ln])
                assert await conn.call("fetch", {"key": key, "off": off, "ln": ln}, timeout=30)
                assert await asyncio.wait_for(fut, 30) is True
                # control plane stays live mid-transfer
                assert await conn.call("fetch", {"key": os.urandom(12), "off": 0, "ln": 1}, timeout=30)
            assert bytes(dest) == payload
        finally:
            await conn.close()
            await server.close()

    asyncio.run(go())


def _build_raw_frame(key: bytes, payload: bytes, token_key: bytes,
                     tamper_payload: bool = False, tamper_header: bool = False) -> bytes:
    """Hand-build a raw-lane frame byte-for-byte (the test's independent
    encoder: must match rpc.send_raw's layout)."""
    hdr = pickle.dumps((key, len(payload)), protocol=5)
    body = bytearray()
    body += bytes([rpc._RAW_MARKER])
    htag = hashlib.blake2b(rpc._RAW_HDR_DOMAIN + hdr, key=token_key, digest_size=rpc.FRAME_TAG_LEN).digest()
    h = hmac.new(token_key, None, hashlib.sha256)  # bulk-lane payload MAC
    h.update(hdr)
    h.update(payload)
    ptag = h.digest()[: rpc.FRAME_TAG_LEN]
    if tamper_header:
        hdr = bytearray(hdr)
        hdr[-1] ^= 0xFF
        hdr = bytes(hdr)
    if tamper_payload:
        payload = bytearray(payload)
        payload[len(payload) // 2] ^= 0x01
        payload = bytes(payload)
    body += htag
    body += len(hdr).to_bytes(4, "little")
    body += hdr
    body += payload
    body += ptag
    return len(body).to_bytes(8, "little") + bytes(body)


def test_raw_frame_mac_tamper_and_truncation():
    """A flipped payload bit fails the streamed MAC: the chunk is never
    acked and the peer is dropped. A tampered header is rejected BEFORE the
    header reaches pickle. A mid-payload disconnect (truncation) resolves
    the chunk future False instead of hanging."""

    async def go():
        rpc.set_auth_token("transfer-tamper-test")
        token_key = rpc.get_auth_token()
        payload = os.urandom(256 * 1024)

        async def run_case(tamper_payload=False, tamper_header=False, truncate=False):
            client_conn = {}
            accepted = asyncio.Event()

            async def on_sock(reader, writer):
                client_conn["rw"] = (reader, writer)
                accepted.set()

            fake_src = await asyncio.start_server(on_sock, "127.0.0.1", 0)
            addr = "127.0.0.1:%d" % fake_src.sockets[0].getsockname()[1]
            conn = await rpc.connect(addr)
            await accepted.wait()
            _, w = client_conn["rw"]
            key = os.urandom(12)
            dest = bytearray(len(payload))
            fut = conn.expect_raw(key, memoryview(dest))
            loads_before = _LOADS[0]
            frame = _build_raw_frame(key, payload, token_key,
                                     tamper_payload=tamper_payload, tamper_header=tamper_header)
            if truncate:
                frame = frame[: len(frame) // 2]
            w.write(frame)
            await w.drain()
            if truncate:
                w.close()
            landed = await asyncio.wait_for(fut, 30)
            assert landed is False
            # tampered/truncated source is dropped
            for _ in range(100):
                if conn.closed:
                    break
                await asyncio.sleep(0.02)
            assert conn.closed
            if tamper_header:
                # the garbled header never reached pickle.loads
                assert _LOADS[0] == loads_before
            fake_src.close()

        # Count pickle.loads calls inside rpc to prove pre-pickle rejection.
        _LOADS = [0]
        real_loads = rpc.pickle.loads

        class _CountingPickle:
            def __getattr__(self, name):
                return getattr(pickle, name)

            @staticmethod
            def loads(*a, **kw):
                _LOADS[0] += 1
                return real_loads(*a, **kw)

        rpc.pickle, saved = _CountingPickle(), rpc.pickle
        try:
            await run_case(tamper_payload=True)
            await run_case(tamper_header=True)
            await run_case(truncate=True)
        finally:
            rpc.pickle = saved

    asyncio.run(go())


def test_wire_version_mismatch_rejected():
    """WIRE_VERSION is 3 (raw lane generation): a v2 frame — what an older
    build would send — is refused before any byte reaches pickle, and the
    peer is dropped."""
    assert rpc.WIRE_VERSION == 3

    class Echo:
        def handle_echo(self, conn, p):
            return p

    async def go():
        server = rpc.RpcServer(Echo())
        await server.start()
        reader, writer = await asyncio.open_connection(server.host, server.port)
        body = pickle.dumps((0, 1, "echo", "old-build"), protocol=5)
        frame = bytes([2]) + body  # v2 layout: version byte + pickle
        writer.write(len(frame).to_bytes(8, "little") + frame)
        await writer.drain()
        assert await reader.read(100) == b""  # server hung up on us
        writer.close()
        await server.close()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# PullManager tests (daemon-level, in-process cluster)
# ---------------------------------------------------------------------------


def _seed_object(daemon, payload: bytes) -> ObjectID:
    oid = ObjectID.from_put()
    daemon.store.put(oid, payload)
    return oid


def _locs(*daemons):
    return [{"node_id": d.node_id, "address": d.address} for d in daemons]


def test_windowed_pull_with_eviction_pressure(fresh_cluster):
    """Pull an object larger than the destination arena's free space: the
    windowed transfer lands, auto-evicting residents, and the payload is
    byte-identical."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    b = cluster.add_node(num_cpus=1, object_store_memory=24 * 1024 * 1024)
    payload = os.urandom(16 * 1024 * 1024 + 321)
    oid = _seed_object(a, payload)
    # Fill most of B's arena so the pull must evict.
    for _ in range(2):
        b.store.put(ObjectID.from_put(), os.urandom(8 * 1024 * 1024))
    assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)))
    assert b.store.get_copy(oid) == payload
    cs = b.config.pull_chunk_size
    assert b.pull_manager.last_pull["chunks"] == (len(payload) + cs - 1) // cs
    assert b.pull_manager.bytes_in == len(payload)
    assert a.pull_manager.bytes_out == len(payload)


def test_multi_source_failover_mid_object(fresh_cluster):
    """Stripe across two replicas; one replica dies after serving k chunks —
    its remaining chunks fail over to the surviving replica and the object
    still verifies byte-identical."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    c = cluster.add_node(num_cpus=1)
    c.config.pull_chunk_size = 1024 * 1024  # 13 chunks: failure lands mid-object
    c.config.raw_mac_granularity = "chunk"  # per-chunk striping/failover is what's under test
    payload = os.urandom(12 * 1024 * 1024 + 7)
    oid = _seed_object(a, payload)
    # replicate A -> B so C has two sources
    assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)))

    served = [0]
    orig = a.handle_read_object_chunk_raw

    async def dies_after_two(conn, p):
        served[0] += 1
        if served[0] > 2:
            raise RuntimeError("replica A died mid-object")
        return await orig(conn, p)

    a.handle_read_object_chunk_raw = dies_after_two
    assert cluster.host.call(c.pull_manager.pull(oid, _locs(a, b)), timeout=120)
    assert c.store.get_copy(oid) == payload
    assert c.pull_manager.chunks_retried > 0
    assert c.pull_manager.last_pull["sources"] == 2


def test_concurrent_pulls_coalesce(fresh_cluster):
    """Two concurrent pulls of one oid ride ONE transfer: the source serves
    each chunk exactly once."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    b.config.pull_chunk_size = 1024 * 1024
    b.config.raw_mac_granularity = "chunk"  # count per-chunk serves
    payload = os.urandom(6 * 1024 * 1024)
    oid = _seed_object(a, payload)

    served = [0]
    orig = a.handle_read_object_chunk_raw

    async def counting(conn, p):
        served[0] += 1
        return await orig(conn, p)

    a.handle_read_object_chunk_raw = counting

    async def both():
        return await asyncio.gather(
            b.pull_manager.pull(oid, _locs(a)),
            b.pull_manager.pull(oid, _locs(a)),
        )

    assert cluster.host.call(both()) == [True, True]
    assert served[0] == 6  # 6 x 1MiB chunks, no duplicate chunk requests
    assert b.store.get_copy(oid) == payload


def test_admission_inflight_byte_cap(fresh_cluster):
    """Pulls admit chunks against the global inflight-bytes budget: with a
    2-chunk budget and an 8-chunk window, inflight bytes never exceed the
    cap and the pull still completes."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    payload = os.urandom(8 * 1024 * 1024)
    oid = _seed_object(a, payload)
    b.config.pull_chunk_size = 1024 * 1024
    budget = 2 * b.config.pull_chunk_size
    b.config.max_inflight_pull_bytes = budget
    pm = b.pull_manager
    peak = [0]
    orig_acquire = pm._acquire_bytes

    async def tracking(n):
        await orig_acquire(n)
        peak[0] = max(peak[0], pm._inflight_bytes)

    pm._acquire_bytes = tracking
    assert cluster.host.call(pm.pull(oid, _locs(a)), timeout=120)
    assert 0 < peak[0] <= budget
    assert b.store.get_copy(oid) == payload


def test_peer_connection_reuse(fresh_cluster):
    """Back-to-back pulls from one source reuse a single cached peer
    connection instead of dialing per object."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    for _ in range(3):
        oid = _seed_object(a, os.urandom(2 * 1024 * 1024))
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)))
    assert len(b._peer_conns) == 1
    assert b.pull_manager.pulls_ok == 3


def test_spilled_source_streams_with_single_open(fresh_cluster):
    """A spilled source object streams through the same raw lane; the spill
    file is opened once per transfer session (pread per chunk), not once per
    chunk."""
    cluster = fresh_cluster
    spill = "/tmp/raytpu_test_spill_%d" % os.getpid()
    a = cluster.add_node(num_cpus=1, object_store_memory=24 * 1024 * 1024)
    b = cluster.add_node(num_cpus=1)
    a.store.spill_dir = spill
    payload = os.urandom(6 * 1024 * 1024)
    oid = _seed_object(a, payload)
    assert a.store.spill(a.store.capacity)  # push everything unpinned to disk
    assert not a.store.contains(oid) and a.store.is_spilled(oid)
    # Arena is big enough: the source restores once and streams from the
    # arena. Shrink the restore path away by filling the arena with pinned
    # objects? Simpler: verify the pull works and, when the restore path was
    # taken, the object is resident again.
    opens = [0]
    real_open = os.open

    def counting_open(path, *a_, **kw):
        if isinstance(path, str) and path.startswith(spill):
            opens[0] += 1
        return real_open(path, *a_, **kw)

    os.open, saved = counting_open, os.open
    try:
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)))
    finally:
        os.open = saved
    assert b.store.get_copy(oid) == payload
    # restore-once (arena had room) or fd-cache (arena full): either way the
    # spill file was opened at most once by the transfer.
    assert opens[0] <= 1


def test_pull_failure_when_no_source(fresh_cluster):
    cluster = fresh_cluster
    cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    oid = ObjectID.from_put()
    assert cluster.host.call(b.pull_manager.pull(oid, [])) is False
    assert b.pull_manager.pulls_failed >= 0  # no crash; nothing partial left
    assert not b.store.contains(oid)


def test_failed_pull_aborts_cleanly_and_oid_stays_pullable(fresh_cluster):
    """A pull that dies mid-transfer (every source lost) must abort its
    created-but-unsealed arena entry: a plain delete refuses the writer pin,
    which would leak the allocation AND poison the oid — every later pull
    of the same object on this node would raise ObjectExistsError forever."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    payload = os.urandom(9 * 1024 * 1024 + 7)
    oid = _seed_object(a, payload)
    b.config.raw_mac_granularity = "chunk"  # the sabotaged handler is the per-chunk one

    async def fail_then_recover():
        # Sabotage: every chunk read on A explodes after the probe, so the
        # transfer starts (arena entry created on B) and then loses all
        # sources mid-object.
        orig = type(a).handle_read_object_chunk_raw

        async def boom(self, conn, p):
            raise RuntimeError("source lost mid-transfer")

        type(a).handle_read_object_chunk_raw = boom
        try:
            assert not await b.pull_manager.pull(oid, _locs(a))
        finally:
            type(a).handle_read_object_chunk_raw = orig
        assert not b.store.contains(oid), "failed pull left a partial object"
        used_after_fail = b.store.used
        # The source comes back healthy: the SAME oid must pull cleanly
        # (no ObjectExistsError poison, no leaked allocation).
        assert await b.pull_manager.pull(oid, _locs(a))
        assert b.store.get_copy(oid) == payload
        assert b.store.used >= used_after_fail  # sanity: the object landed

    cluster.host.call(fail_then_recover())


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_get_owned_promotes_oversized_inline(fresh_cluster, payload):
    """A memory-store object above object_chunk_size is promoted to the shm
    arena when a borrower asks for it, so the borrower takes the streaming
    pull path instead of receiving megabytes pickled inside one RPC reply.
    The torch case returns a CPU tensor (its bytes out of band)."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as _api

    cluster = fresh_cluster
    # Inline cap above chunk size: task returns up to 4 MiB stay in the
    # owner's memory store — the configuration the promotion path exists for.
    cluster.config.max_inline_object_size = 4 * 1024 * 1024
    cluster.add_node(num_cpus=2)
    b = cluster.add_node(num_cpus=2, resources={"borrower": 2.0})
    rt.init(address=cluster.address)
    try:
        src = np.arange((2 * 1024 * 1024) // 8, dtype=np.int64)  # 2 MiB
        # rt.put of a big value goes straight to shm; the memory-store case
        # is a task RETURN under the raised inline cap:
        @rt.remote
        def make():
            if payload == "torch":
                import torch

                return torch.arange((2 * 1024 * 1024) // 8, dtype=torch.int64)
            return np.arange((2 * 1024 * 1024) // 8, dtype=np.int64)

        ref = make.remote()
        rt.wait([ref], num_returns=1, timeout=60)
        core = _api._require_worker()
        assert core.memory_store.get(ref.id) is not None, "test premise: object lives in memory store"

        @rt.remote(resources={"borrower": 1.0})
        def consume(arr):
            return int(arr.sum())

        assert rt.get(consume.remote(ref), timeout=60) == int(src.sum())
        # the owner promoted it into the head node's arena
        assert any(d.store.contains(ref.id) for d in cluster.daemons)
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# pickle-bypass proof at the cluster level
# ---------------------------------------------------------------------------


def test_chunk_payloads_bypass_pickle(fresh_cluster):
    """During a cross-node pull of an 8 MiB object, no pickle.dumps result in
    this process (driver + both daemons) approaches chunk size, and no
    payload-sized bytes object materializes through StreamReader.readexactly
    — the chunks move as raw frames straight into the arena."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    payload = os.urandom(8 * 1024 * 1024)
    oid = _seed_object(a, payload)

    max_dump = [0]
    real_dumps = pickle.dumps

    class _ShimPickle:
        def __getattr__(self, name):
            return getattr(pickle, name)

        @staticmethod
        def dumps(obj, *a_, **kw):
            data = real_dumps(obj, *a_, **kw)
            max_dump[0] = max(max_dump[0], len(data))
            return data

    big_reads = [0]
    real_readexactly = asyncio.StreamReader.readexactly

    async def counting_readexactly(self, n):
        if n >= 256 * 1024:
            big_reads[0] += 1
        return await real_readexactly(self, n)

    rpc.pickle, saved = _ShimPickle(), rpc.pickle
    asyncio.StreamReader.readexactly = counting_readexactly
    try:
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
    finally:
        rpc.pickle = saved
        asyncio.StreamReader.readexactly = real_readexactly
    assert b.store.get_copy(oid) == payload
    chunk = b.config.object_chunk_size
    assert max_dump[0] < chunk // 2, f"a chunk-sized pickle happened ({max_dump[0]} bytes)"
    assert big_reads[0] == 0, "payload bytes materialized through readexactly"
