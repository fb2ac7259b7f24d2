"""The port's RPC auth: the cases of ``tests/test_rpc_auth.py`` on port
clusters.

RPC auth: with a session token configured, unauthenticated peers are
rejected before any unpickling (reference analogue: src/ray/rpc/
authentication token auth). Own isolated cluster: auth is opt-in per session."""
import pickle
import socket

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


TRIPPED = []


def _trip():
    """Sentinel reconstructor: executes iff a frame reaches pickle.loads."""
    TRIPPED.append(1)


class _Boom:
    def __reduce__(self):
        return (_trip, ())


def test_wire_version_mismatch_refused():
    """A frame stamped with a different wire-format generation is refused —
    connection dropped with no reply — and its bytes NEVER reach pickle
    (reference analogue: protobuf schema versioning; here a version byte
    guards the pickle frames against mixed-build clusters)."""
    import asyncio

    from ray_tpu_torch.core import rpc

    async def go():
        class H:
            def handle_ping(self, conn, p):
                return "pong"

        server = rpc.RpcServer(H())
        await server.start()
        try:
            # Same-build peer round-trips fine.
            conn = await rpc.connect(server.address)
            assert await conn.call("ping", timeout=10) == "pong"
            await conn.close()

            # Mismatched version byte: refused before unpickling.
            reader, writer = await asyncio.open_connection(server.host, server.port)
            body = pickle.dumps((0, 1, "ping", _Boom()), protocol=5)
            frame = bytes([rpc.WIRE_VERSION + 1]) + body
            writer.write(len(frame).to_bytes(8, "little") + frame)
            await writer.drain()
            data = await reader.read(1024)
            assert data == b"", f"mismatched-version peer got a reply: {data!r}"
            writer.close()
            # A legacy pre-version frame (starts with the pickle PROTO opcode
            # 0x80, not a version byte) is refused the same way.
            reader, writer = await asyncio.open_connection(server.host, server.port)
            writer.write(len(body).to_bytes(8, "little") + body)
            await writer.drain()
            assert await reader.read(1024) == b""
            writer.close()
        finally:
            await server.close()

    asyncio.run(go())
    assert not TRIPPED, "booby-trapped frame was unpickled despite version mismatch"


def test_token_cluster_end_to_end_and_rejects_raw_peers():
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.auth_token = "s3cret-session-token"
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=4)
    init(address=cluster.address, config=cfg)
    try:
        assert rpc.get_auth_token(), "token should be installed"

        # Full stack (driver -> controller -> daemon -> spawned worker) works
        # with every frame tagged.
        @rt.remote
        def f(x):
            return x + 1

        assert rt.get(f.remote(41), timeout=60) == 42

        # A raw TCP client without the token is dropped — its frames never
        # reach pickle.loads.
        host, port = cluster.address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=10)
        frame = pickle.dumps((0, 1, "get_cluster_state", {}), protocol=5)
        s.sendall(len(frame).to_bytes(8, "little") + frame)
        s.settimeout(5)
        data = s.recv(1024)
        assert data == b"", f"unauthenticated peer got a reply: {data!r}"
        s.close()

        # Cluster still healthy after the rejected peer.
        assert rt.get(f.remote(1), timeout=60) == 2
    finally:
        shutdown()
        cluster.shutdown()
        rpc.set_auth_token(None)  # don't leak the token into later sessions


def test_auto_session_token(tmp_path):
    """Clusters mint a session RPC token by default; same-host drivers pick
    it up from the session token file; raw unauthenticated peers are dropped
    (reference: rpc/authentication — auth required by default)."""
    import pickle
    import socket

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)  # no explicit token
    cluster.add_node(num_cpus=2)
    assert cluster.config.auth_token, "auto token not minted"
    init(address=cluster.address)
    try:
        assert rpc.get_auth_token(), "driver did not adopt the session token"

        @rt.remote
        def f(x):
            return x * 2

        assert rt.get(f.remote(21), timeout=60) == 42
        # Raw peer without the token: dropped before unpickling.
        host, port = cluster.address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=10)
        frame = pickle.dumps((0, 1, "get_cluster_state", {}), protocol=5)
        s.sendall(len(frame).to_bytes(8, "little") + frame)
        s.settimeout(5)
        assert s.recv(1024) == b""
        s.close()
    finally:
        shutdown()
        cluster.shutdown()
        rpc.set_auth_token(None)
