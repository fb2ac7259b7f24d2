"""The port's sidecar services: ``tests/test_sidecars.py``'s 7 cases (metrics
pipeline, job submission, dashboard JSON/Prometheus endpoints, the CLI's
state verbs, timeline export, profile and drain) on a port cluster, and the
port's own job case: a job whose entrypoint asks for the GPU and finds none
ends FAILED with the typed error in its log; it never carries on on the CPU.

Sidecar services: metrics pipeline, job submission, dashboard JSON/Prom
endpoints, autoscaler. Reference analogues: python/ray/tests/test_metrics*,
dashboard/modules/job/tests, autoscaler/v2/tests."""
import json
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_metrics_counter_gauge_histogram(shared_ray):
    from ray_tpu_torch.core import api
    from ray_tpu_torch.util import metrics

    c = metrics.Counter("test_requests", description="reqs")
    c.inc(2.0, tags={"route": "/a"})
    c.inc(3.0, tags={"route": "/a"})
    g = metrics.Gauge("test_depth")
    g.set(7.0)
    h = metrics.Histogram("test_latency", boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)

    # Metrics emitted inside a task (another process) aggregate too.
    @rt.remote
    def emit():
        from ray_tpu_torch.util import metrics as m

        m.Counter("test_requests").inc(5.0, tags={"route": "/a"})
        # Force an immediate report instead of waiting for the 5s timer.
        from ray_tpu_torch.core import api as wapi

        core = wapi._require_worker()
        import asyncio

        asyncio.run_coroutine_threadsafe(core._report_metrics(), core.loop).result(10)
        return True

    assert rt.get(emit.remote(), timeout=60)
    core = api._require_worker()
    core._run(core._report_metrics())
    series = core._run(core.controller.call("get_metrics", {}))
    byname = {(s["name"], tuple(sorted(s["tags"].items()))): s for s in series}
    assert byname[("test_requests", (("route", "/a"),))]["value"] == 10.0
    # Gauges merge as per-reporter series (a `reporter` tag is added —
    # summing point-in-time values across processes is nonsense; see
    # handle_get_metrics), so the lookup matches by name, not exact tags.
    depth = [s for s in series if s["name"] == "test_depth"]
    assert depth, "driver gauge never reached the merged view"
    assert all(s["tags"].get("reporter") for s in depth), depth
    assert any(s["value"] == 7.0 for s in depth), depth
    hist = byname[("test_latency", ())]
    assert hist["counts"] == [1, 1, 1] and hist["n"] == 3

    from ray_tpu_torch.util.metrics import prometheus_text

    text = prometheus_text(series)
    assert "raytpu_test_requests" in text and 'le="+Inf"' in text


def test_job_submission_lifecycle(shared_ray, tmp_path):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    client = JobSubmissionClient(log_dir=str(tmp_path))
    job_id = client.submit_job(f"{sys.executable} -c \"print('hello from job')\"")
    assert client.wait_until_finished(job_id, timeout_s=120) == JobStatus.SUCCEEDED
    assert "hello from job" in client.get_job_logs(job_id)
    assert any(j["job_id"] == job_id for j in client.list_jobs())

    bad = client.submit_job(f"{sys.executable} -c \"import sys; sys.exit(3)\"")
    assert client.wait_until_finished(bad, timeout_s=120) == JobStatus.FAILED

    slow = client.submit_job(f"{sys.executable} -c \"import time; time.sleep(60)\"")
    time.sleep(0.5)
    assert client.stop_job(slow)
    assert client.wait_until_finished(slow, timeout_s=30) == JobStatus.STOPPED


def test_dashboard_endpoints(shared_ray):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    port = start_dashboard(0)
    try:
        status, body = _get(f"http://127.0.0.1:{port}/api/cluster")
        assert status == 200
        state = json.loads(body)
        assert "nodes" in state and "actors" in state
        status, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200
        status, body = _get(f"http://127.0.0.1:{port}/")
        assert status == 200 and b"ray_tpu_torch" in body
    finally:
        stop_dashboard()


def test_cli_status_and_list(shared_ray, capsys):
    from ray_tpu_torch.core import api

    from ray_tpu_torch import __main__ as cli

    addr = api._require_worker().controller_addr

    # Reuse the existing session: _connect's rt.init is a no-op when already
    # initialized in-process.
    cli.main(["--address", addr, "status"])
    cli.main(["--address", addr, "list", "nodes"])
    out = capsys.readouterr().out
    assert "nodes:" in out and "== nodes ==" in out


def test_timeline_export(shared_ray, tmp_path):
    from ray_tpu_torch.util.tracing import export_timeline, get_task_events

    @rt.remote
    def traced_task(x):
        time.sleep(0.02)
        return x

    rt.get([traced_task.remote(i) for i in range(4)], timeout=120)
    time.sleep(0.1)
    # Worker-side exec events reach the controller via the reporter; force
    # one reporter tick worker-side by running another task round.
    rt.get([traced_task.remote(i) for i in range(2)], timeout=120)

    out = str(tmp_path / "trace.json")
    deadline = time.time() + 30
    spans = 0
    while time.time() < deadline and spans == 0:
        n = export_timeline(out)
        data = json.load(open(out))
        spans = sum(1 for e in data["traceEvents"] if e["ph"] == "X")
        if spans == 0:
            time.sleep(1.0)
    assert spans >= 1, "no execution spans in exported timeline"
    assert any(e["ph"] == "i" for e in data["traceEvents"])  # control instants


def test_dashboard_profile_and_ui(shared_ray):
    """On-demand worker CPU profile through the dashboard (py-spy-equiv,
    reference: reporter/profile_manager.py) + the HTML UI renders."""
    import json as _json
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @rt.remote
    class Spinner:
        def __init__(self):
            self.spinning = False

        def busy(self, n):
            import time as _t

            self.spinning = True
            t0 = _t.time()
            while _t.time() - t0 < n:
                sum(range(2000))
            self.spinning = False
            return True

        def is_busy(self):
            return self.spinning

    # max_concurrency 2: is_busy must answer WHILE busy holds the default
    # lane (the deterministic started-signal the profile gates on).
    a = Spinner.options(max_concurrency=2).remote()
    rt.get(a.busy.remote(0.01), timeout=60)  # barrier: actor ALIVE + registered
    ref = a.busy.remote(6.0)  # keep a thread hot while we sample
    # Deterministic gate: sample only once the busy body is actually on its
    # executor thread — profiling the dispatch window instead was the old
    # flake (stacks full of idle pool threads, "busy" absent).
    deadline = time.time() + 30
    while not rt.get(a.is_busy.remote(), timeout=30):
        assert time.time() < deadline, "busy call never started"
        time.sleep(0.05)
    # Find the actor's worker address from cluster state.
    from ray_tpu_torch.core import api as _api

    core = _api._require_worker()
    state = core._run(core.controller.call("get_cluster_state", {}))
    addr = state["actors"][a._actor_id.hex()]["worker_addr"]
    assert addr, "spinner actor has no worker address"
    port = start_dashboard(0)
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/profile?addr={addr}&duration=2.0", timeout=60
        ) as resp:
            prof = _json.loads(resp.read())
        # The busy loop starves the sampler of the GIL on a loaded 1-core
        # host (~5-10 samples/s observed); the floor asserts liveness, not
        # cadence.
        assert prof["samples"] >= 5, prof
        assert any("busy" in stack for stack in prof["stacks"]), (
            f"hot method not in sampled stacks: {list(prof['stacks'])[:3]}"
        )
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as resp:
            html = resp.read().decode()
        assert "Nodes" in html and "/api/cluster" in html
    finally:
        stop_dashboard()
        rt.get(ref, timeout=60)
        rt.kill(a)


def test_cli_drain_and_profile(shared_ray, capsys):
    """`python -m ray_tpu_torch drain/profile` operator commands."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.__main__ import main as cli
    from ray_tpu_torch.core import api as _api

    @rt.remote
    class Idler:
        def __init__(self):
            self.spinning = False

        def spin(self, n):
            import time as _t

            self.spinning = True
            t0 = _t.time()
            while _t.time() - t0 < n:
                sum(range(1000))
            self.spinning = False
            return True

        def is_busy(self):
            return self.spinning

    a = Idler.options(max_concurrency=2).remote()
    rt.get(a.spin.remote(0.01), timeout=60)
    core = _api._require_worker()
    state = core._run(core.controller.call("get_cluster_state", {}))
    node_id = next(iter(state["nodes"]))
    addr = state["actors"][a._actor_id.hex()]["worker_addr"]

    caddr = core.controller_addr
    try:
        cli(["--address", caddr, "drain", node_id])
        assert "draining" in capsys.readouterr().out
        assert core._run(core.controller.call("get_cluster_state", {}))["nodes"][node_id]["draining"]
    finally:
        # The shared cluster's only node must never stay drained (every later
        # test in this module would pend forever).
        cli(["--address", caddr, "drain", node_id, "--undo"])
    assert "reopened" in capsys.readouterr().out

    ref = a.spin.remote(5.0)
    deadline = time.time() + 30
    while not rt.get(a.is_busy.remote(), timeout=30):
        assert time.time() < deadline, "spin call never started"
        time.sleep(0.05)
    cli(["--address", caddr, "profile", addr, "--duration", "1.5"])
    out = capsys.readouterr().out
    assert "samples over" in out and "spin" in out
    rt.get(ref, timeout=60)
    rt.kill(a)


def test_gpu_job_without_a_card_fails(shared_ray, tmp_path):
    import torch

    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    assert not torch.cuda.is_available()
    client = JobSubmissionClient(log_dir=str(tmp_path))
    job_id = client.submit_job(
        f"{sys.executable} -c \"import torch; "
        "from ray_tpu_torch.models.transformer import TransformerConfig, init_params; "
        "init_params(TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, "
        "n_kv_heads=1, d_ff=64), torch.Generator()); print('ran on the cpu')\"")
    assert client.wait_until_finished(job_id, timeout_s=120) == JobStatus.FAILED
    logs = client.get_job_logs(job_id)
    assert "no CUDA device is visible" in logs and "ran on the cpu" not in logs
    assert client.get_job_info(job_id)["message"] == "entrypoint exited with code 1"
