"""The port's polyglot protobuf serve ingress: the cases of
``tests/test_serve_proto.py`` on a port cluster (reference: gRPCProxy,
serve/_private/proxy.py:534 — a schema'd RPC surface non-Python clients can
codegen against; here: serve/protocol/serve_rpc.proto over the proxy's
length-prefixed binary port, JSON-in-protobuf, session-HMAC framed)."""
import json
import socket

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api


@pytest.fixture(scope="module")
def proto_app():
    rt.init(num_cpus=8)
    serve.start()

    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class Calc:
        def __call__(self, payload):
            return {"echo": payload}

        def add(self, a, b, scale=1):
            return (a + b) * scale

        def whoami(self):
            import os

            return os.getpid()

        def boom(self):
            raise ValueError("kaboom")

    serve.run(Calc.bind(), name="calc", route_prefix="/calc")
    yield
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def test_proto_client_calls_and_errors(proto_app):
    from ray_tpu_torch.serve import ProtoServeClient, ProtoServeError

    with ProtoServeClient(port=serve.rpc_port()) as c:
        assert c.call("calc", "Calc", {"x": 1}) == {"echo": {"x": 1}}
        assert c.call("calc", "Calc", 2, 3, method="add", kwargs={"scale": 10}) == 50
        with pytest.raises(ProtoServeError, match="ValueError: kaboom"):
            c.call("calc", "Calc", method="boom")
        # Affinity: same key -> same replica across calls.
        pids = {c.call("calc", "Calc", method="whoami", affinity_key="k1")
                for _ in range(5)}
        assert len(pids) == 1, pids


def test_raw_socket_speaks_only_the_proto_schema(proto_app):
    """A 'foreign' client built from NOTHING but the generated schema + the
    framing documented in serve_rpc.proto — no ray_tpu_torch client code — proves
    the surface is codegen-sufficient for polyglot callers."""
    import hashlib

    from ray_tpu_torch.core import rpc as _rpc
    from ray_tpu_torch.serve.protocol import serve_rpc_pb2 as pb

    req = pb.ServeRequest(
        app="calc", deployment="Calc", method="add",
        json_payload=json.dumps({"args": [20, 22], "kwargs": {}}).encode(),
    )
    payload = b"PB1\x00" + req.SerializeToString()
    # Framing per the .proto comment: optional session tag + magic + message.
    tag = b""
    if _rpc.get_auth_token():
        tag = hashlib.blake2b(payload, key=_rpc.get_auth_token(),
                              digest_size=_rpc.FRAME_TAG_LEN).digest()
    frame = tag + payload
    s = socket.create_connection(("127.0.0.1", serve.rpc_port()), timeout=60)
    s.sendall(len(frame).to_bytes(4, "little") + frame)
    raw = b""
    n = None
    while n is None or len(raw) < 4 + n:
        chunk = s.recv(65536)
        assert chunk, "proxy closed the connection (bad frame?)"
        raw += chunk
        if n is None and len(raw) >= 4:
            n = int.from_bytes(raw[:4], "little")
    s.close()
    body = raw[4:4 + n]
    if _rpc.get_auth_token():
        body = body[_rpc.FRAME_TAG_LEN:]
    assert body.startswith(b"PB1\x00")
    reply = pb.ServeReply()
    reply.ParseFromString(body[4:])
    assert reply.status == pb.ServeReply.OK
    assert json.loads(reply.json_result) == 42


def test_pickle_path_still_works_alongside(proto_app):
    """The trusted in-datacenter pickle format coexists on the same port
    (frames without the PB1 magic)."""
    import pickle

    from ray_tpu_torch.core import rpc as _rpc

    payload = pickle.dumps(("calc", "Calc", "add", (1, 2), {}), protocol=5)
    frame = _rpc.frame_tag(payload) + payload
    s = socket.create_connection(("127.0.0.1", serve.rpc_port()), timeout=60)
    s.sendall(len(frame).to_bytes(4, "little") + frame)
    raw = b""
    n = None
    while n is None or len(raw) < 4 + n:
        chunk = s.recv(65536)
        assert chunk
        raw += chunk
        if n is None and len(raw) >= 4:
            n = int.from_bytes(raw[:4], "little")
    s.close()
    body = raw[4:4 + n]
    if _rpc.get_auth_token():
        tag, body = body[:_rpc.FRAME_TAG_LEN], body[_rpc.FRAME_TAG_LEN:]
        # Verify the reply MAC, not just strip it — the client-side half of
        # the contract the proxy enforces on ingress.
        assert _rpc.frame_verify(tag, body)
    status, result = pickle.loads(body)
    assert (status, result) == ("ok", 3)
