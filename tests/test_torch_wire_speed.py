"""The port's wire-speed contracts (raw object lane): the cases of
``tests/test_wire_speed.py`` on port clusters. Its two copy-elision cases,
``test_keep_live_copy_false_jax_snapshot_survives_next_step`` and
``test_export_state_copy_false_parks_numpy_reference``, keep their names
and pin the port's opposite contract: torch leaves are updated in place, so
keep_live and export_state copy even with ``copy=False``.

Wire-speed campaign regressions (raw object lane).

The contracts this battery pins:

- send_raw never materializes its payload — no bytes()/tobytes() on any
  part, single- or multi-part, vectored or legacy sequential path.
- The window MAC (one HMAC tag per pull window instead of one per chunk)
  still covers every payload byte: divergence between shipped and hashed
  bytes is detected, a tampered window fails TYPED (RawWindowTamperError),
  the source is dropped, and the run refetches per-chunk byte-identical.
- A pre-window (v3 per-chunk) peer interops via capability negotiation:
  the "no handler" refusal is remembered on the connection and the pull
  silently runs per-chunk — no retries burned, no error surfaced.
- bytes_out/bytes_in accounting covers the vectored-window serve AND the
  sendfile (spilled, auth-off) serve.
- keep_live(copy=False)/export_state(copy=False) take COPIES in the port:
  a torch snapshot survives the next (in-place) step untouched, and a
  parked leaf shares no memory with the caller's.
- Degraded-network tooling: the in-process token-bucket pacer actually
  throttles the raw lane; the netem-marked test auto-skips with a reason
  where tc/CAP_NET_ADMIN/sch_netem is unavailable.
"""
import asyncio
import logging
import os
import subprocess
import time

import numpy as np
import pytest

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.ids import ObjectID
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(autouse=True)
def _restore_raw_lane_state():
    yield
    rpc.set_auth_token(None)
    rpc.configure_raw_lane(vectored=True, mac_granularity="window")
    rpc.set_net_shape("")


def _seed_object(daemon, payload: bytes) -> ObjectID:
    oid = ObjectID.from_put()
    daemon.store.put(oid, payload)
    return oid


def _locs(*daemons):
    return [{"node_id": d.node_id, "address": d.address} for d in daemons]


# ---------------------------------------------------------------------------
# zero-copy send path
# ---------------------------------------------------------------------------


class _CountingArray(np.ndarray):
    """ndarray whose bytes()/tobytes() calls are counted: the raw lane must
    ship payloads through the buffer protocol (memoryview slices straight to
    the socket), so ANY materialization on the send path is a regression."""

    copies = 0

    def tobytes(self, *a, **kw):  # noqa: D102
        type(self).copies += 1
        return super().tobytes(*a, **kw)

    def __bytes__(self):
        type(self).copies += 1
        return super().tobytes()


class _RawSource:
    def __init__(self, parts):
        self.parts = parts

    async def handle_fetch(self, conn, p):
        payload = self.parts if len(self.parts) > 1 else self.parts[0]
        await conn.send_raw(p["key"], payload)
        return True


@pytest.mark.parametrize("vectored", [True, False], ids=["vectored", "legacy"])
@pytest.mark.parametrize("nparts", [1, 3])
def test_send_raw_never_copies_payload(vectored, nparts):
    """A raw frame's payload crosses as buffer-protocol views on both the
    single-sendmsg vectored path and the legacy sequential path — zero
    bytes()/tobytes() materializations, single- and multi-part."""

    async def go():
        rpc.set_auth_token("wire-speed-nocopy")
        rpc.configure_raw_lane(vectored=vectored)
        raw = [os.urandom(512 * 1024 + 7 * i) for i in range(nparts)]
        parts = [np.frombuffer(r, dtype=np.uint8).view(_CountingArray) for r in raw]
        expected = b"".join(raw)
        _CountingArray.copies = 0

        server = rpc.RpcServer(_RawSource(parts))
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            key = os.urandom(12)
            dest = bytearray(len(expected))
            fut = conn.expect_raw(key, memoryview(dest))
            assert await conn.call("fetch", {"key": key}, timeout=30)
            assert await asyncio.wait_for(fut, 30) is True
            assert bytes(dest) == expected
        finally:
            await conn.close()
            await server.close()
        assert _CountingArray.copies == 0, (
            f"send path materialized the payload {_CountingArray.copies}x")

    asyncio.run(go())


# ---------------------------------------------------------------------------
# window MAC: wire-level
# ---------------------------------------------------------------------------


class _WindowSource:
    def __init__(self, chunks):
        self.chunks = chunks

    async def handle_win(self, conn, p):
        hasher = rpc.raw_window_hasher()
        if p.get("diverge"):
            # Model on-the-wire tamper: the MAC stream sees bytes the
            # receiver never gets. The reply tag must then mismatch the
            # receiver's hash of what actually landed.
            hasher.update(b"\x01")
        base = p["key"]
        for i, c in enumerate(self.chunks):
            await conn.send_raw(base + i.to_bytes(4, "little"), c, hasher=hasher)
        return {"ok": True, "tag": hasher.digest()[: rpc.FRAME_TAG_LEN]}


@pytest.mark.parametrize("diverge", [False, True], ids=["clean", "tampered"])
def test_window_hasher_covers_exactly_the_landed_bytes(diverge):
    """One HMAC per window, no per-chunk trailer: the receiver hashes the
    bytes that LAND, the sender the bytes it SHIPS, and the tags agree iff
    those streams are identical — any divergence anywhere in the run is
    caught by the single compare."""
    import hmac as _hmac

    async def go():
        rpc.set_auth_token("wire-speed-window")
        chunks = [os.urandom(256 * 1024 + i) for i in range(4)]
        server = rpc.RpcServer(_WindowSource(chunks))
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            base = os.urandom(12)
            hasher = rpc.raw_window_hasher()
            dests = [bytearray(len(c)) for c in chunks]
            futs = [conn.expect_raw(base + i.to_bytes(4, "little"),
                                    memoryview(d), hasher)
                    for i, d in enumerate(dests)]
            ack = await conn.call("win", {"key": base, "diverge": diverge},
                                  timeout=30)
            assert all(await asyncio.wait_for(asyncio.gather(*futs), 30))
            for d, c in zip(dests, chunks):
                assert bytes(d) == c  # payloads landed byte-identical
            match = _hmac.compare_digest(
                ack["tag"], hasher.digest()[: rpc.FRAME_TAG_LEN])
            assert match is (not diverge)
        finally:
            await conn.close()
            await server.close()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# window MAC: pull-path tamper + capability negotiation (cluster level)
# ---------------------------------------------------------------------------


def test_window_tamper_fails_whole_window_typed_then_refetches(fresh_cluster, caplog):
    """A tampered window fails TYPED (RawWindowTamperError, an RpcError),
    the source connection is hard-dropped, and the run refetches per-chunk —
    the object still lands byte-identical."""
    assert issubclass(rpc.RawWindowTamperError, rpc.RpcError)
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    b.config.pull_chunk_size = 1024 * 1024
    assert rpc.get_auth_token(), "window MAC rides the authed wire (auto-mint)"
    payload = os.urandom(6 * 1024 * 1024 + 13)
    oid = _seed_object(a, payload)

    orig = a.handle_read_object_window_raw
    tampered = [0]

    async def tamper_first(conn, p):
        res = await orig(conn, p)
        if not tampered[0] and res.get("tag"):
            tampered[0] += 1
            tag = res["tag"]
            res = dict(res, tag=bytes([tag[0] ^ 0xFF]) + tag[1:])
        return res

    a.handle_read_object_window_raw = tamper_first
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.core.node"):
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
    assert tampered[0] == 1
    assert b.store.get_copy(oid) == payload
    assert b.pull_manager.chunks_retried >= 1  # the whole window was retried
    assert "RawWindowTamperError" in caplog.text


def test_pre_window_peer_negotiates_per_chunk(fresh_cluster):
    """A v3 per-chunk-only peer (no read_object_window_raw handler) is
    detected on first use ("no handler" RpcError), remembered on the
    connection, and served per-chunk from then on — silently: no retry
    counters burn, and later pulls skip the window RPC outright."""
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    b.config.pull_chunk_size = 1024 * 1024
    a.handle_read_object_window_raw = None  # simulate the older build

    for rep in range(2):
        payload = os.urandom(4 * 1024 * 1024 + rep)
        oid = _seed_object(a, payload)
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
        assert b.store.get_copy(oid) == payload
    assert b.pull_manager.chunks_retried == 0  # negotiation, not failure
    assert any(c.meta.get("no_window_raw") for c in b._peer_conns.values())


# ---------------------------------------------------------------------------
# bytes accounting: vectored window serve + sendfile serve
# ---------------------------------------------------------------------------


def test_window_serve_accounts_bytes_both_sides(fresh_cluster):
    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    b.config.pull_chunk_size = 1024 * 1024
    payload = os.urandom(4 * 1024 * 1024 + 21)
    oid = _seed_object(a, payload)
    out0, in0 = a.pull_manager.bytes_out, b.pull_manager.bytes_in
    assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
    assert b.pull_manager.last_pull["mode"] == "window"
    assert a.pull_manager.bytes_out - out0 == len(payload)
    assert b.pull_manager.bytes_in - in0 == len(payload)


def test_sendfile_serve_accounts_bytes_and_lands_identical(monkeypatch):
    """A spilled source on an auth-off link serves fd->socket via
    os.sendfile; the kernel-assisted path still lands byte-identical and is
    fully covered by bytes_out/bytes_in accounting."""
    from ray_tpu_torch.core.api import Cluster
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    snap = cfg.to_dict()
    monkeypatch.setenv("RAYTPU_AUTO_TOKEN", "0")
    cfg.auth_token = ""
    rpc.set_auth_token(None)
    cluster = Cluster(initialize_head=False)
    try:
        spill = "/tmp/raytpu_wire_spill_%d" % os.getpid()
        a = cluster.add_node(num_cpus=1, object_store_memory=24 * 1024 * 1024)
        b = cluster.add_node(num_cpus=1)
        b.config.pull_chunk_size = 1024 * 1024
        a.store.spill_dir = spill
        payload = os.urandom(5 * 1024 * 1024 + 3)
        oid = _seed_object(a, payload)
        assert a.store.spill(a.store.capacity)
        assert a.store.is_spilled(oid)
        # Pin the serve to the disk path: an arena restore would hand the
        # transfer a memoryview and bypass sendfile.
        monkeypatch.setattr(a, "_restore_local", lambda _oid: False)
        sendfile_calls = [0]
        real_sendfile = os.sendfile

        def counting_sendfile(out_fd, in_fd, offset, count):
            sendfile_calls[0] += 1
            return real_sendfile(out_fd, in_fd, offset, count)

        monkeypatch.setattr(os, "sendfile", counting_sendfile)
        out0, in0 = a.pull_manager.bytes_out, b.pull_manager.bytes_in
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
        assert b.store.get_copy(oid) == payload
        assert sendfile_calls[0] >= 1, "disk serve did not take the sendfile path"
        assert a.pull_manager.bytes_out - out0 == len(payload)
        assert b.pull_manager.bytes_in - in0 == len(payload)
    finally:
        cluster.shutdown()
        for k, v in snap.items():
            setattr(cfg, k, v)
        rpc.set_auth_token(None)


# ---------------------------------------------------------------------------
# chaos replay determinism across MAC granularities
# ---------------------------------------------------------------------------


def test_corrupt_mac_chaos_replays_identically_under_both_granularities(fresh_cluster):
    """The rpc.frame.send corrupt_mac fault injects exactly as scheduled
    under BOTH MAC granularities and the pull survives it identically in
    each: envelope-MAC rejection drops the poisoned link, the transfer
    fails over to the surviving replica, the object lands byte-identical.
    Two sources because the fault may land on the very first envelope to a
    peer (the size probe) — single-source pulls legitimately fail there."""
    from ray_tpu_torch.chaos import plan as _plan

    cluster = fresh_cluster
    a = cluster.add_node(num_cpus=1)
    b = cluster.add_node(num_cpus=1)
    c = cluster.add_node(num_cpus=1)
    c.config.pull_chunk_size = 1024 * 1024
    injected = {}
    for gran in ("window", "chunk"):
        c.config.raw_mac_granularity = gran
        payload = os.urandom(4 * 1024 * 1024 + 5)
        oid = _seed_object(a, payload)
        # Replicate a -> b on a clean wire so c has two sources under fire.
        assert cluster.host.call(b.pull_manager.pull(oid, _locs(a)), timeout=120)
        _plan.install(_plan.FaultSchedule.from_spec({
            "seed": 16,
            "rules": [{"site": "rpc.frame.send", "kind": "corrupt_mac",
                       "every": 1, "max_faults": 1}],
        }))
        try:
            ok = cluster.host.call(c.pull_manager.pull(oid, _locs(a, b)), timeout=120)
            injected[gran] = len(_plan.injection_log())
        finally:
            _plan.uninstall()
        assert ok, f"pull under corrupt_mac failed (granularity={gran})"
        assert c.store.get_copy(oid) == payload
        c.store.delete(oid)
    assert injected["window"] == injected["chunk"] == 1


# ---------------------------------------------------------------------------
# copy elision: keep_live(copy=False) / export_state(copy=False)
# ---------------------------------------------------------------------------


def test_keep_live_copy_false_jax_snapshot_survives_next_step(tmp_path):
    """The port's counterpart: torch steps update leaves IN PLACE, so
    keep_live(copy=False) must take a copy (the reference parks references
    to immutable jax leaves). The snapshot survives the next step's
    in-place updates, and export_state(copy=False) ships exactly the parked
    values."""
    import torch

    from ray_tpu_torch.elastic import transfer
    from ray_tpu_torch.train.session import TrainSession

    sess = TrainSession(0, 1, 0, "wire-speed", str(tmp_path))
    params = torch.arange(1024, dtype=torch.float32)
    opt_m = torch.zeros(2048, dtype=torch.float32)
    sess.keep_live({"params": params}, sharded={"opt.m": (opt_m, 0, 4096)},
                   meta={"step": 1}, copy=False)
    snap = sess.live_snapshot()
    assert snap["state"]["params"] is not params  # a copy, not a reference

    # The "next step": torch updates the same tensors in place.
    params.add_(1.0)
    opt_m.add_(0.5)

    np.testing.assert_array_equal(
        snap["state"]["params"].numpy(), np.arange(1024, dtype=np.float32))
    arr, lo, n = snap["sharded"]["opt.m"]
    assert (lo, n) == (0, 4096) and float(arr.sum()) == 0.0

    tid = "wire-speed-export"
    transfer.export_state(tid, 0, snap["state"], snap["sharded"],
                          seq=snap["seq"], meta=snap["meta"], copy=False)
    try:
        exp = transfer._EXPORTS[tid]
        np.testing.assert_array_equal(
            exp.arrays["params"], np.arange(1024, dtype=np.float32))
    finally:
        transfer.release(tid)


def test_export_state_copy_false_parks_numpy_reference():
    """The port's counterpart: export_state parks a private host copy with
    copy=False too (a torch leaf is updated in place after the snapshot
    point), so the parked bytes share no memory with the caller's leaf and
    survive its next in-place update; the default copies as well."""
    import torch

    from ray_tpu_torch.elastic import transfer

    w = torch.arange(4096, dtype=torch.float32)
    arr = np.arange(4096, dtype=np.float32)
    transfer.export_state("wire-ref", 0, {"w": w, "a": arr}, copy=False)
    try:
        exp = transfer._EXPORTS["wire-ref"]
        assert not np.shares_memory(exp.arrays["w"], w.numpy())
        assert not np.shares_memory(exp.arrays["a"], arr)
        w.add_(1.0)
        arr += 1.0
        np.testing.assert_array_equal(exp.arrays["w"], np.arange(4096, dtype=np.float32))
        np.testing.assert_array_equal(exp.arrays["a"], np.arange(4096, dtype=np.float32))
    finally:
        transfer.release("wire-ref")
    transfer.export_state("wire-copy", 0, {"w": arr})  # default copies
    try:
        assert not np.shares_memory(transfer._EXPORTS["wire-copy"].arrays["w"], arr)
    finally:
        transfer.release("wire-copy")


# ---------------------------------------------------------------------------
# degraded-network profile tooling
# ---------------------------------------------------------------------------


def _netem_probe(rate_mbit=800, delay_ms=1) -> tuple:
    """Try to install netem on loopback; (ok, skip_reason). On ok=True the
    qdisc is LIVE — the caller must tear it down."""
    cmd = ["tc", "qdisc", "add", "dev", "lo", "root", "netem",
           "delay", f"{delay_ms}ms", "rate", f"{rate_mbit}mbit"]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=10)
    except FileNotFoundError:
        return False, "tc not installed"
    except Exception as e:  # noqa: BLE001 - probe must never error the suite
        return False, f"tc probe failed: {e}"
    if p.returncode == 0:
        return True, ""
    return False, (p.stderr or p.stdout).strip() or f"tc exited {p.returncode}"


def _netem_teardown():
    subprocess.run(["tc", "qdisc", "del", "dev", "lo", "root"],
                   capture_output=True, timeout=10)


def test_netem_probe_always_yields_a_skip_reason():
    """The auto-skip contract: wherever netem cannot be installed the probe
    says WHY (missing tc, missing CAP_NET_ADMIN, missing sch_netem), so the
    skipped test and the bench row both carry the reason."""
    ok, reason = _netem_probe()
    if ok:
        _netem_teardown()
        assert reason == ""
    else:
        assert reason, "probe failed without a reason"


@pytest.mark.netem
def test_netem_shaped_loopback_bounds_throughput():
    import socket
    import threading

    ok, reason = _netem_probe(rate_mbit=400, delay_ms=1)
    if not ok:
        pytest.skip(f"netem unavailable on this host: {reason}")
    try:
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        total = 16 * 1024 * 1024
        got = [0]

        def drain():
            c, _ = srv.accept()
            buf = bytearray(1 << 20)
            while got[0] < total:
                n = c.recv_into(buf)
                if not n:
                    break
                got[0] += n
            c.close()

        t = threading.Thread(target=drain)
        t.start()
        s = socket.create_connection(("127.0.0.1", port))
        data = b"\x00" * (1 << 20)
        t0 = time.perf_counter()
        for _ in range(total // len(data)):
            s.sendall(data)
        t.join(timeout=120)
        elapsed = time.perf_counter() - t0
        s.close()
        srv.close()
        mb_s = total / 1e6 / elapsed
        assert got[0] == total
        # 400 mbit = 50 MB/s; allow 2x slack for token-bucket burst.
        assert mb_s <= 100, f"netem did not shape loopback: {mb_s:.0f} MB/s"
    finally:
        _netem_teardown()


def test_net_shape_pacing_throttles_raw_lane():
    """The in-process fallback profile (Config.net_shape_spec): the token
    bucket paces raw-frame sends to the configured rate, so a degraded_sim
    bench row measures a genuinely thinner pipe."""

    async def go():
        payload = np.ones(1 << 20, dtype=np.uint8)
        server = rpc.RpcServer(_RawSource([payload]))
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            async def pump(n):
                t0 = time.perf_counter()
                for _ in range(n):
                    key = os.urandom(12)
                    dest = bytearray(len(payload))
                    fut = conn.expect_raw(key, memoryview(dest))
                    assert await conn.call("fetch", {"key": key}, timeout=30)
                    assert await asyncio.wait_for(fut, 30) is True
                return time.perf_counter() - t0

            quiet = await pump(6)
            rpc.set_net_shape('{"rate_mb_s": 40.0, "delay_ms": 0.0}')
            shaped = await pump(6)
            rpc.set_net_shape("")
            # 6 MiB at 40 MB/s minus the 1 MiB burst allowance: >= ~0.13 s
            # of pacing the quiet run never pays.
            assert shaped >= quiet + 0.09, (quiet, shaped)
        finally:
            await conn.close()
            await server.close()

    asyncio.run(go())
