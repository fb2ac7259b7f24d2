"""The port's serve layer (``ray_tpu_torch.serve``): deployments, handles,
router, proxy, batching, autoscaling, controller recovery. The cases of
``tests/test_serve.py`` on a port cluster. The repo's leak sentinel watches
only ``ray_tpu``, so the fixture also checks that the port's ``api`` holds
no worker or cluster once the module is done."""
import json
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api


@pytest.fixture(scope="module")
def serve_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def _http(method, port, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def test_function_deployment_handle(serve_cluster):
    @serve.deployment
    def echo(x):
        return {"got": x}

    handle = serve.run(echo.bind(), name="fn_app", http=False)
    assert handle.remote(41).result() == {"got": 41}
    serve.delete("fn_app")


def test_class_deployment_methods_and_user_config(serve_cluster):
    @serve.deployment(user_config={"scale": 10})
    class Scaler:
        def __init__(self, base):
            self.base = base
            self.scale = 1

        def reconfigure(self, cfg):
            self.scale = cfg["scale"]

        def __call__(self, x):
            return (x + self.base) * self.scale

        def describe(self):
            return {"base": self.base, "scale": self.scale}

    handle = serve.run(Scaler.bind(5), name="cls_app", http=False)
    assert handle.remote(1).result() == 60
    assert handle.describe.remote().result() == {"base": 5, "scale": 10}
    serve.delete("cls_app")


def test_composition_child_handle(serve_cluster):
    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment
    class Pipeline:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, text):
            words = self.tok.remote(text).result()
            return {"n_words": len(words)}

    app = Pipeline.bind(Tokenizer.bind())
    handle = serve.run(app, name="compose", http=False)
    assert handle.remote("a b c d").result() == {"n_words": 4}
    st = serve.status()["apps"]["compose"]
    assert set(st) == {"Tokenizer", "Pipeline"}
    assert all(d["status"] == "HEALTHY" for d in st.values())
    serve.delete("compose")


def test_replicas_load_balanced(serve_cluster):
    @serve.deployment(num_replicas=3, max_ongoing_requests=2)
    class WhoAmI:
        def __init__(self):
            import os

            self.pid_tag = f"{os.getpid()}-{id(self)}"

        def __call__(self):
            time.sleep(0.05)
            return self.pid_tag

    handle = serve.run(WhoAmI.bind(), name="lb", http=False)
    responses = []
    lock = threading.Lock()

    def call():
        r = handle.remote().result()
        with lock:
            responses.append(r)

    threads = [threading.Thread(target=call) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(responses) == 12
    # With 12 concurrent requests and cap 2/replica, >1 replica must serve.
    assert len(set(responses)) >= 2
    serve.delete("lb")


# ---------------------------------------------------------------------------
# HTTP proxy
# ---------------------------------------------------------------------------

def test_http_proxy_routes_and_json(serve_cluster):
    @serve.deployment
    class Api:
        def __call__(self, request):
            body = request.json()
            return {"path": request.path, "sum": sum(body["xs"])}

    serve.run(Api.bind(), name="http_app", route_prefix="/api")
    port = serve.http_port()
    status, raw = _http("POST", port, "/api/add", {"xs": [1, 2, 3]})
    assert status == 200
    assert json.loads(raw) == {"path": "/add", "sum": 6}
    status, raw = _http("GET", port, "/-/routes")
    assert status == 200
    assert json.loads(raw)["/api"] == "http_app/Api"
    with pytest.raises(urllib.error.HTTPError) as err:
        _http("GET", port, "/nope")
    assert err.value.code == 404
    serve.delete("http_app")


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def test_serve_batch_groups_requests(serve_cluster):
    @serve.deployment(max_ongoing_requests=16)
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def _infer(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def __call__(self, x):
            return self._infer(x)

        def get_batch_sizes(self):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), name="batch_app", http=False)
    results = {}
    lock = threading.Lock()

    def call(i):
        r = handle.remote(i).result()
        with lock:
            results[i] = r

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {i: i * 2 for i in range(8)}
    sizes = handle.get_batch_sizes.remote().result()
    assert sum(sizes) == 8
    assert max(sizes) > 1  # at least one real batch formed
    serve.delete("batch_app")


# ---------------------------------------------------------------------------
# autoscaling
# ---------------------------------------------------------------------------

@pytest.mark.slow  # heavy battery; tier-1 budget
def test_autoscaling_up_and_down(serve_cluster):
    @serve.deployment(
        max_ongoing_requests=4,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1,
            max_replicas=3,
            target_ongoing_requests=1.0,
            upscale_delay_s=0.2,
            downscale_delay_s=0.5,
        ),
    )
    class Slow:
        def __call__(self):
            time.sleep(0.3)
            return "ok"

    handle = serve.run(Slow.bind(), name="auto", http=False)
    assert serve.status()["apps"]["auto"]["Slow"]["replicas"] == 1

    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                handle.remote().result(timeout=30)
            except Exception:
                return

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 20
        scaled_up = False
        while time.time() < deadline:
            if serve.status()["apps"]["auto"]["Slow"]["replicas"] >= 2:
                scaled_up = True
                break
            time.sleep(0.2)
        assert scaled_up, "autoscaler never scaled up under load"
    finally:
        stop.set()
        for t in threads:
            t.join()
    deadline = time.time() + 20
    scaled_down = False
    while time.time() < deadline:
        if serve.status()["apps"]["auto"]["Slow"]["target"] == 1:
            scaled_down = True
            break
        time.sleep(0.2)
    assert scaled_down, "autoscaler never scaled back down after load stopped"
    serve.delete("auto")


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_replica_death_recovers(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Sturdy:
        def __call__(self):
            return "alive"

    handle = serve.run(Sturdy.bind(), name="ft", http=False)
    info = rt.get(
        serve.api._get_controller().get_routing_info.remote("ft", "Sturdy"), timeout=10
    )
    victim = rt.get_actor(info["replica_names"][0], namespace="serve")
    rt.kill(victim)
    # Requests keep succeeding (retry/fail-over) while the controller heals.
    for _ in range(10):
        assert handle.remote().result(timeout=30) == "alive"
        time.sleep(0.05)
    deadline = time.time() + 20
    while time.time() < deadline:
        st = serve.status()["apps"]["ft"]["Sturdy"]
        if st["replicas"] == 2 and st["status"] == "HEALTHY":
            break
        time.sleep(0.2)
    st = serve.status()["apps"]["ft"]["Sturdy"]
    assert st["replicas"] == 2
    serve.delete("ft")


def test_controller_crash_recovery(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Persist:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Persist.bind(), name="ctl_ft", http=False)
    assert handle.remote(1).result() == 2

    ctl = serve.api._get_controller(create=False)
    rt.kill(ctl, no_restart=False)  # restartable: comes back and restores
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        try:
            st = serve.status()
            if st["apps"]["ctl_ft"]["Persist"]["replicas"] == 2:
                ok = True
                break
        except Exception:
            pass
        time.sleep(0.2)
    assert ok, "controller did not recover state from checkpoint"
    # Data path still works on the recovered control plane.
    assert handle.remote(5).result(timeout=30) == 6
    serve.delete("ctl_ft")


def test_redeploy_rolls_replicas_to_new_code(serve_cluster):
    """Redeploying changed code must retire old-code replicas (rolling update;
    reference: deployment_state.py)."""
    @serve.deployment
    def versioned(x):
        return {"version": 1, "x": x}

    h = serve.run(versioned.bind(), name="roll_app", http=False)
    assert h.remote(0).result()["version"] == 1

    @serve.deployment(name="versioned")
    def versioned2(x):
        return {"version": 2, "x": x}

    h2 = serve.run(versioned2.bind(), name="roll_app", http=False)
    deadline = time.time() + 30
    seen = None
    while time.time() < deadline:
        seen = h2.remote(0).result()["version"]
        if seen == 2:
            break
        time.sleep(0.25)
    assert seen == 2, f"still serving old code: {seen}"
    serve.delete("roll_app")
