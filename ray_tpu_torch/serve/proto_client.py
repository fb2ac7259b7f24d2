"""Protobuf serve client: the Python reference implementation of the
polyglot ingress (serve/protocol/serve_rpc.proto).

Role-equivalent to a generated gRPC client against the reference's
gRPCProxy (serve/_private/proxy.py:534): a non-Python caller codegens the
.proto and speaks the same frames — 4-byte LE length, optional 16-byte
keyed-BLAKE2b session tag (derivation documented in the .proto), "PB1\\0"
magic, ServeRequest; arguments and results are JSON (never pickle), so the
surface is language-neutral end to end.
"""
from __future__ import annotations

import json
import socket
from typing import Any, Optional


class ProtoServeError(RuntimeError):
    """Server-side failure relayed through ServeReply.error."""


class ProtoServeClient:
    """Blocking client for the proxy's protobuf ingress.

    In-cluster: `ProtoServeClient(port=serve.rpc_port())` after rt.init —
    the session auth token is picked up from the process. Off-cluster
    callers pass `auth_token` (the cluster session token) explicitly; the
    key derivation is rpc.derive_frame_key, the same single home the
    cluster itself uses.

    Delivery semantics: a request is sent at most once. A stale pooled
    connection is re-dialed before sending, but once bytes are on the wire
    the call NEVER auto-retries — a timeout raises to the caller, who
    decides whether the method is safe to re-invoke.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth_token: Optional[str | bytes] = None, timeout_s: float = 60.0):
        from ray_tpu_torch.core import rpc as _rpc

        self._host = host
        self._port = port
        self._timeout = timeout_s
        if auth_token is not None:
            key = _rpc.derive_frame_key(auth_token)
            self._tag = lambda p: _rpc.tag_with_key(key, p)
            self._authed = True
        else:
            self._tag = _rpc.frame_tag  # session-ambient (b"" when auth off)
            self._authed = bool(_rpc.get_auth_token())
        self._sock: Optional[socket.socket] = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self._host, self._port), timeout=self._timeout
            )
        return self._sock

    def call(self, app: str, deployment: str, *args,
             method: str = "", kwargs: Optional[dict] = None,
             affinity_key: str = "", timeout_s: float = 0.0) -> Any:
        """Invoke `method` (default __call__) on a deployment.

        Positional args ride *args; KEYWORD args for the remote method go
        in the `kwargs` dict (a plain **kwargs here would shadow remote
        parameters named method/affinity_key/timeout_s). Everything must be
        JSON-serializable; returns the JSON-decoded result. `timeout_s` is
        the server-side execution budget (capped server-side at 600s); the
        socket waits slightly longer so the server's reply, not a client
        disconnect, decides the outcome."""
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.serve.protocol import PROTO_MAGIC, pb2

        pb = pb2()
        req = pb.ServeRequest(
            app=app, deployment=deployment, method=method,
            json_payload=json.dumps(
                {"args": list(args), "kwargs": dict(kwargs or {})}
            ).encode(),
            affinity_key=affinity_key, timeout_s=timeout_s,
        )
        payload = PROTO_MAGIC + req.SerializeToString()
        frame = self._tag(payload) + payload
        wire = len(frame).to_bytes(4, "little") + frame
        s = self._conn()
        try:
            s.sendall(wire)
        except (ConnectionError, BrokenPipeError, OSError):
            # Stale pooled connection: nothing reached the server from this
            # call — re-dialing and re-sending is the only safe retry.
            self.close()
            s = self._conn()
            s.sendall(wire)
        # Once sent: wait for the reply, never re-send (at-most-once).
        s.settimeout(max(self._timeout, (timeout_s or 0.0) + 10.0))
        try:
            raw = self._read_frame(s)
        except Exception:
            self.close()  # half-read connection is unusable
            raise
        if self._authed:
            raw = raw[_rpc.FRAME_TAG_LEN:]  # reply tag (trusted channel)
        if not raw.startswith(PROTO_MAGIC):
            raise ProtoServeError("non-protobuf reply (is this the rpc_port?)")
        reply = pb.ServeReply()
        reply.ParseFromString(raw[len(PROTO_MAGIC):])
        if reply.status == pb.ServeReply.ERROR:
            raise ProtoServeError(reply.error)
        return json.loads(reply.json_result or b"null")

    def _read_frame(self, s: socket.socket) -> bytes:
        hdr = self._recv_exact(s, 4)
        return self._recv_exact(s, int.from_bytes(hdr, "little"))

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("proxy closed the connection")
            buf += chunk
        return buf

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
