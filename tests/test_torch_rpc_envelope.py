"""The port's coalesced RPC envelopes: the cases of
``tests/test_rpc_envelope.py``.

Coalesced-envelope wire protocol (rpc.py envelope lane; WIRE_VERSION 3
since the raw chunk lane landed): a frame's payload pickles to either ONE
(kind, msg_id, method, payload) tuple or a LIST of them. N messages enqueued
in one loop tick ship as one envelope — one length header, one version byte,
one keyed-BLAKE2b tag, one pickle — and a lone frame is flushed the same
tick (call_soon, never a timer)."""
import asyncio
import pickle
import time

import pytest

from ray_tpu_torch.core import rpc
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401

TRIPPED = []


class Echo:
    def handle_echo(self, conn, p):
        return p

    def handle_trip(self, conn, p):
        TRIPPED.append(p)
        return p


@pytest.fixture(autouse=True)
def _no_token_leak():
    yield
    rpc.set_auth_token(None)


def test_mixed_single_and_batched_frames_one_connection():
    """Lone calls ride single-message envelopes; a synchronous burst of
    call_starts coalesces into ONE envelope; both interleave freely on one
    connection and every call gets its own reply."""

    async def go():
        server = rpc.RpcServer(Echo())
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            # Lone call round trip (single-message envelope).
            assert await conn.call("echo", "solo-1", timeout=30) == "solo-1"

            rpc.batch_stats(reset=True)
            futs = [conn.call_start("echo", i) for i in range(32)]
            await conn.flush()
            assert await asyncio.gather(*futs) == list(range(32))
            st = rpc.batch_stats()
            # The whole burst left this process as one 32-message envelope.
            assert st["send"].get(32, 0) >= 1, st
            # The server (same process) received it as one envelope too.
            assert st["recv"].get(32, 0) >= 1, st

            # Back to lone frames on the same connection.
            assert await conn.call("echo", "solo-2", timeout=30) == "solo-2"

            # And a concurrent gather of plain calls still works (replies
            # may arrive batched or single — decode handles both).
            vals = await asyncio.gather(*(conn.call("echo", i, timeout=30) for i in range(10)))
            assert vals == list(range(10))
        finally:
            await conn.close()
            await server.close()

    asyncio.run(go())


def test_mac_tamper_rejects_whole_batch():
    """One tag covers the whole envelope: a single flipped byte anywhere in
    a batched frame drops the peer before ANY message reaches pickle/dispatch."""

    async def go():
        rpc.set_auth_token("envelope-tamper-test")
        server = rpc.RpcServer(Echo())
        await server.start()
        try:
            TRIPPED.clear()
            # Positive control: a correctly-tagged hand-built batch executes.
            reader, writer = await asyncio.open_connection(server.host, server.port)
            msgs = [(0, 1, "trip", "a"), (0, 2, "trip", "b")]
            body = pickle.dumps(msgs, protocol=5)
            frame = bytes([rpc.WIRE_VERSION]) + rpc.frame_tag(body) + body
            writer.write(len(frame).to_bytes(8, "little") + frame)
            await writer.drain()
            deadline = time.monotonic() + 30
            while len(TRIPPED) < 2 and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            assert TRIPPED == ["a", "b"]
            writer.close()

            # Tampered batch: flip one payload byte, keep the stale tag.
            TRIPPED.clear()
            reader, writer = await asyncio.open_connection(server.host, server.port)
            bad = bytearray(body)
            bad[-1] ^= 0x01
            frame = bytes([rpc.WIRE_VERSION]) + rpc.frame_tag(body) + bytes(bad)
            writer.write(len(frame).to_bytes(8, "little") + frame)
            await writer.drain()
            data = await reader.read(1024)
            assert data == b"", f"tampered batch got a reply: {data!r}"
            assert TRIPPED == [], "a message from a tampered batch was dispatched"
            writer.close()
        finally:
            await server.close()
            rpc.set_auth_token(None)

    asyncio.run(go())


def test_version_byte_mismatch_refuses_batched_frame():
    """A batched envelope stamped with a foreign wire generation is refused
    before unpickling, exactly like a single frame."""

    async def go():
        server = rpc.RpcServer(Echo())
        await server.start()
        try:
            TRIPPED.clear()
            reader, writer = await asyncio.open_connection(server.host, server.port)
            body = pickle.dumps([(0, 1, "trip", "x"), (0, 2, "trip", "y")], protocol=5)
            frame = bytes([rpc.WIRE_VERSION + 1]) + body
            writer.write(len(frame).to_bytes(8, "little") + frame)
            await writer.drain()
            data = await reader.read(1024)
            assert data == b"", f"mismatched-version batch got a reply: {data!r}"
            assert TRIPPED == []
            writer.close()
        finally:
            await server.close()

    asyncio.run(go())


def test_unpicklable_payload_does_not_sink_batchmates():
    """One unpicklable message must not drop the envelope it coalesced
    into: batchmates still deliver, the offender gets a clean RpcError
    (reply side: an 'err' reply, mirroring pre-batching _dispatch; request
    side: the local reply future fails instead of hanging)."""
    import threading

    class H:
        def handle_echo(self, conn, p):
            return p

        def handle_bad(self, conn, p):
            return threading.Lock()  # unpicklable reply payload

    async def go():
        server = rpc.RpcServer(H())
        await server.start()
        conn = await rpc.connect(server.address)
        try:
            futs = [
                conn.call_start("echo", 1),
                conn.call_start("bad", None),
                conn.call_start("echo", 2),
            ]
            await conn.flush()
            results = await asyncio.gather(*futs, return_exceptions=True)
            assert results[0] == 1 and results[2] == 2, results
            assert isinstance(results[1], rpc.RpcError), results[1]

            # Unpicklable REQUEST payload: the caller gets an error, not a
            # hang, and the connection survives for the next call.
            with pytest.raises(rpc.RpcError):
                await conn.call("echo", threading.Lock(), timeout=30)
            assert await conn.call("echo", "still-alive", timeout=30) == "still-alive"
        finally:
            await conn.close()
            await server.close()

    asyncio.run(go())


def test_lone_call_never_waits_on_flush_timer():
    """Regression guard for the flush policy: coalescing must be
    queue-depth-driven (call_soon at tick end), NEVER a timer — a lone sync
    call must not sit in the buffer waiting for a batching window."""

    async def go():
        server = rpc.RpcServer(Echo())
        await server.start()
        conn = await rpc.connect(server.address)
        loop = asyncio.get_running_loop()
        short_timers: list = []
        orig_call_later = loop.call_later

        def spy(delay, cb, *args, **kw):
            # Any sub-5s timer during lone calls would be a batching window
            # (the only legit timers here are this test's own long call
            # timeouts, if any).
            if delay < 5.0:
                short_timers.append(delay)
            return orig_call_later(delay, cb, *args, **kw)

        loop.call_later = spy
        try:
            rpc.batch_stats(reset=True)
            t0 = time.perf_counter()
            for i in range(50):
                assert await conn.call("echo", i, timeout=None) == i
            elapsed = time.perf_counter() - t0
        finally:
            loop.call_later = orig_call_later
            await conn.close()
            await server.close()
        assert short_timers == [], f"flush used timers: {short_timers[:5]}"
        st = rpc.batch_stats()
        # Sequential lone calls never coalesce: every envelope carries 1.
        assert set(st["send"]) == {1}, st
        # 50 local round trips in well under any plausible batching-timer
        # regime (50 x even a 10ms window would be >= 0.5s).
        assert elapsed < 30, f"50 lone calls took {elapsed:.1f}s"

    asyncio.run(go())
