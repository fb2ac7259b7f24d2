"""Polyglot serve-ingress protocol: serve_rpc.proto + generated bindings.

Any language with protobuf codegen + a TCP socket can call serve
deployments through the proxy's binary port — see serve_rpc.proto for the
schema, framing, and auth-tag derivation; ray_tpu_torch/serve/proto_client.py is
the Python reference client.

The generated module is imported LAZILY (pb2()): the proxy's legacy pickle
path shares the port and must keep working on hosts without
google.protobuf.
"""
PROTO_MAGIC = b"PB1\x00"


def pb2():
    """The generated serve_rpc_pb2 module (requires google.protobuf)."""
    from ray_tpu_torch.serve.protocol import serve_rpc_pb2

    return serve_rpc_pb2


__all__ = ["PROTO_MAGIC", "pb2"]
