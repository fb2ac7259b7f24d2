"""The port's profiling plane (``ray_tpu_torch.obs.profiler``): the cases of
``tests/test_profiler.py``, the two ``/api/profile`` cases on the port's
dashboard included. The device plane is
``torch.profiler`` here: on this CPU host it raises the typed error, its
trace summary is checked on a written trace and its listener's protocol
without a device, and one ``cuda`` case captures a K1 launch on the card.

Continuous profiling & cost-attribution plane: always-on
wall-clock sampler, merged cluster flamegraphs, alert-triggered capture.

Layers, cheapest first:
  * pure units (no cluster): plane-attribution rule on fabricated frame
    records, shared stack renderer (health thread_dump rides it), fold
    accumulator bounds + counted evictions + the truthful-totals
    invariant, N-fake-worker merge into one tree with proc dedup,
    renderers (collapsed text / d3 tree / leaf self-time), the capture
    rate limiter (one capture per burn alert), local_fold dispatch;
  * live sampler in this process: hot-frame detection of a synthetic spin
    thread, epoch-ring bounds, per-trace scoping through the tracing
    hook, capture sessions (armed and disarmed, session bound typed),
    interleaved armed-vs-disabled overhead pairs, device profiling
    degrading typed-and-loud on this CPU-only host, flight dumps carrying
    their own flamegraph;
  * one live cluster: a traced serve request whose per-trace profile is
    retrievable from /api/profile and attributes its exec hop to the
    right plane buckets, plus the merged cluster flamegraph and the
    ?summary=1 rollup `raytpu status` reads.
"""
from __future__ import annotations

import json
import re
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

from ray_tpu_torch.obs import profiler
from ray_tpu_torch.obs import stacks
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


def _rec(*shorts):
    """Fabricated frame records (root first): one frame per short path."""
    return [(f"f{i}", s, 10 + i) for i, s in enumerate(shorts)]


def _fake_fold(proc, stack_counts, plane="app"):
    n = sum(stack_counts.values())
    return {"proc": proc, "hz": 19.0, "samples": n, "samples_dropped": 0,
            "stacks_evicted": 0, "stacks": dict(stack_counts),
            "planes": {plane: n}}


def _spin_thread(name="prof-spin"):
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(i * i for i in range(2000))

    t = threading.Thread(target=spin, name=name, daemon=True)
    t.start()
    return stop


# ---------------------------------------------------------------------------
# plane attribution + the shared stack renderer (no sampler)
# ---------------------------------------------------------------------------

def test_plane_attribution_buckets():
    # First ray_tpu_torch frame from the leaf decides the plane.
    assert stacks.plane_of(_rec("app.py", "ray_tpu_torch/serve/proxy.py")) == "serve"
    assert stacks.plane_of(_rec("ray_tpu_torch/serve/proxy.py", "helper.py")) == "serve"
    assert stacks.plane_of(_rec("ray_tpu_torch/collective/ring.py")) == "collective"
    assert stacks.plane_of(_rec("ray_tpu_torch/data/dataset.py")) == "data"
    # The wire is its own cost center.
    assert stacks.plane_of(_rec("ray_tpu_torch/core/worker.py", "ray_tpu_torch/core/rpc.py")) == "rpc"
    # worker.py with user frames above it = user code under the executor.
    assert stacks.plane_of(_rec("ray_tpu_torch/core/worker.py", "usercode.py")) == "exec"
    # worker.py as the leaf itself = the runtime's own bookkeeping.
    assert stacks.plane_of(_rec("ray_tpu_torch/core/worker.py")) == "core"
    # The serve replica's user-handler dispatch works the same way: a
    # deployment handler burning above replica.py is the request's exec
    # hop; replica.py at the leaf is serve machinery.
    assert stacks.plane_of(
        _rec("ray_tpu_torch/serve/replica.py", "my_deployment.py")) == "exec"
    assert stacks.plane_of(_rec("ray_tpu_torch/serve/replica.py")) == "serve"
    # Top-level module -> module name.
    assert stacks.plane_of(_rec("ray_tpu_torch/dashboard.py")) == "dashboard"
    # No ray_tpu_torch frame anywhere -> app; empty stack -> app.
    assert stacks.plane_of(_rec("mine.py", "yours.py")) == "app"
    assert stacks.plane_of([]) == "app"
    # A leaf parked in a stdlib wait primitive is idle — even when ray_tpu_torch
    # frames sit below it (a pool thread waiting for work is capacity).
    assert stacks.plane_of(_rec("ray_tpu_torch/serve/proxy.py", "threading.py")) == "idle"
    assert stacks.plane_of(_rec("selectors.py")) == "idle"
    # ...but a ray_tpu_torch file that happens to be NAMED like one is not.
    assert stacks.plane_of(_rec("ray_tpu_torch/queue.py")) == "queue"


def test_shared_frame_renderer_and_paths():
    assert stacks.shorten_path("/v/site-packages/ray_tpu_torch/serve/proxy.py") \
        == "ray_tpu_torch/serve/proxy.py"
    assert stacks.shorten_path("/usr/lib/python3.10/threading.py") == "threading.py"
    assert stacks.format_frame("go", "ray_tpu_torch/core/rpc.py", 7) \
        == "go (ray_tpu_torch/core/rpc.py:7)"
    recs = _rec("a.py", "b.py")
    assert stacks.collapse(recs) == "f0 (a.py:10);f1 (b.py:11)"


def test_health_thread_dump_rides_shared_renderer():
    # ONE stack formatter — the loop-lag thread dump names
    # frames exactly like the flamegraph does, so they cross-reference.
    from ray_tpu_torch.obs import health

    dumps = health.thread_dump(max_frames=8)
    mine = [d for d in dumps
            if any("test_health_thread_dump_rides_shared_renderer" in line
                   for line in d["stack"])]
    assert mine, "this thread's stack missing from the dump"
    pat = re.compile(r".+ \(.+:\d+\)$")
    assert all(pat.match(line) for d in dumps for line in d["stack"])


# ---------------------------------------------------------------------------
# fold accumulator + merge: bounds, counted evictions, truthful totals
# ---------------------------------------------------------------------------

def _check_invariant(fold):
    assert fold["samples"] - fold["samples_dropped"] == sum(fold["stacks"].values())
    assert fold["samples"] == sum(fold["planes"].values())


def test_profile_bound_counts_evictions():
    p = profiler.Profile(max_stacks=2)
    p.add("a;b", "serve", 5)
    p.add("a;c", "serve", 3)
    p.add("a;d", "rpc", 2)   # table full: counted, never silent
    p.add("a;b", "serve", 1)  # existing stacks still accumulate
    f = p.fold()
    assert f["stacks"] == {"a;b": 6, "a;c": 3}
    assert f["stacks_evicted"] == 1 and f["samples_dropped"] == 2
    assert f["samples"] == 11
    _check_invariant(f)


def test_merge_folds_n_workers_one_tree():
    folds = [_fake_fold(f"w{i}", {"main;hot": 10 + i, f"main;only{i}": 1})
             for i in range(8)]
    merged = profiler.merge_folds(folds, max_stacks=1024)
    assert merged["procs"] == [f"w{i}" for i in range(8)]
    assert merged["stacks"]["main;hot"] == sum(10 + i for i in range(8))
    assert merged["samples"] == sum(f["samples"] for f in folds)
    _check_invariant(merged)
    # The tree renderer agrees with the fold: root value == kept samples.
    tree = profiler.to_tree(merged)
    assert tree["name"] == "all"
    assert tree["value"] == sum(merged["stacks"].values())
    main = tree["children"][0]
    assert main["name"] == "main" and main["value"] == tree["value"]
    # Collapsed text round-trips counts, hottest first.
    lines = profiler.to_collapsed(merged).splitlines()
    assert lines[0] == f"main;hot {merged['stacks']['main;hot']}"
    assert len(lines) == len(merged["stacks"])


def test_merge_folds_bounded_keeps_hot_path():
    folds = [_fake_fold(f"w{i}", {"hot;path": 100, f"cold;{i}": 1})
             for i in range(4)]
    merged = profiler.merge_folds(folds, max_stacks=2)
    assert "hot;path" in merged["stacks"] and merged["stacks"]["hot;path"] == 400
    assert len(merged["stacks"]) == 2
    assert merged["stacks_evicted"] >= 3  # displaced cold stacks are counted
    _check_invariant(merged)


def test_merge_folds_dedups_by_proc():
    # In-process topologies (head==driver) share one sampler: the same
    # proc's fold arriving via two fan-out legs must count ONCE.
    f = _fake_fold("headproc", {"a;b": 7})
    merged = profiler.merge_folds([f, dict(f)], max_stacks=64)
    assert merged["procs"] == ["headproc"]
    assert merged["samples"] == 7 and merged["stacks"]["a;b"] == 7
    # Garbage rows (error strings from dead daemons) are skipped.
    merged = profiler.merge_folds([f, "node x: timeout", None], max_stacks=64)
    assert merged["samples"] == 7


def test_top_frames_and_plane_split():
    fold = {"stacks": {"a;b;leaf": 6, "c;leaf": 4, "c;other": 1},
            "planes": {"serve": 8, "idle": 2}, "samples": 11,
            "samples_dropped": 0, "stacks_evicted": 0}
    assert profiler.top_frames(fold, 2) == [("leaf", 10), ("other", 1)]
    split = profiler.plane_split(fold)
    assert split[0] == ("serve", 0.8) and split[1] == ("idle", 0.2)


# ---------------------------------------------------------------------------
# capture rate limiter: one capture per burn alert, like flight dumps
# ---------------------------------------------------------------------------

def test_capture_limiter_once_per_alert():
    lim = profiler.CaptureLimiter(min_interval_s=2.0)
    assert lim.allow("slo-a", now=100.0)
    # The SAME objective re-alerting inside the window: suppressed, counted.
    assert not lim.allow("slo-a", now=100.5)
    assert not lim.allow("slo-a", now=101.9)
    assert lim.suppressed == 2
    # A different objective is its own budget.
    assert lim.allow("slo-b", now=100.5)
    # Past the window the same objective may capture again.
    assert lim.allow("slo-a", now=102.1)


def test_capture_limiter_key_table_bounded():
    lim = profiler.CaptureLimiter(min_interval_s=1.0)
    for i in range(400):
        lim.allow(f"obj-{i}", now=50.0)
    assert lim.keys_evicted >= 400 - 256 - 1
    assert len(lim._last) <= 256


# ---------------------------------------------------------------------------
# live sampler: hot frames, ring, traces, sessions, overhead
# ---------------------------------------------------------------------------

def test_sampler_finds_synthetic_spin_thread():
    s = profiler.Sampler(hz=97.0, proc="unit-hot")
    stop = _spin_thread("unit-hot-spin")
    s.start()
    try:
        deadline = time.time() + 15
        fold = {}
        while time.time() < deadline:
            fold = s.total_fold()
            hot = {st: n for st, n in fold["stacks"].items() if "spin" in st}
            if sum(hot.values()) >= 5:
                break
            time.sleep(0.1)
        assert hot and sum(hot.values()) >= 5, \
            f"spin thread never became hot: {list(fold['stacks'])[:5]}"
        _check_invariant(fold)
        assert fold["proc"] == "unit-hot" and fold["hz"] == 97.0
        # The spin frames render through the shared formatter.
        assert any(re.search(r"spin \(.+:\d+\)", st) for st in hot)
        # Plane attribution: the spin thread is non-ray_tpu_torch code -> "app".
        assert fold["planes"].get("app", 0) >= 5
    finally:
        stop.set()
        s.stop()


def test_epoch_ring_bounded_and_counted():
    s = profiler.Sampler(hz=97.0, proc="unit-ring", epoch_s=0.25,
                         window_epochs=2)
    stop = _spin_thread("unit-ring-spin")
    s.start()
    try:
        deadline = time.time() + 15
        while time.time() < deadline:
            st = s.status()
            if st["epochs_dropped"] > 0:
                break
            time.sleep(0.1)
        st = s.status()
        assert st["epochs"] <= 2
        assert st["epochs_dropped"] > 0, "ring overflow was never counted"
        # window_fold sees ring + live epoch; a tiny window sees less.
        wide = s.window_fold(60.0)
        assert wide["samples"] > 0 and wide["window_s"] == 60.0
        _check_invariant(wide)
    finally:
        stop.set()
        s.stop()


def test_per_trace_scoping_through_tracing_hook():
    # arm() wires the module sampler into tracing.activate/deactivate —
    # the exact path a traced exec span takes on a worker.
    from ray_tpu_torch.util import tracing

    profiler.arm(hz=97.0, proc="unit-trace")
    noise = _spin_thread("unit-trace-noise")
    try:
        tok = tracing.activate(("trace-prof-1", "span-1"))
        assert tok is not None
        deadline = time.time() + 15
        while time.time() < deadline:
            if profiler.trace_fold("trace-prof-1")["samples"] >= 3:
                break
            sum(i * i for i in range(20000))  # visible work on THIS thread
        tracing.deactivate(tok)
        tf = profiler.trace_fold("trace-prof-1")
        assert tf["trace_id"] == "trace-prof-1" and tf["samples"] >= 3
        # The noise thread's frames never leak into the trace's fold.
        assert not any("unit-trace-noise" in st or "spin" in st
                       for st in tf["stacks"])
        # After deactivate the thread stops accruing to the trace.
        before = tf["samples"]
        time.sleep(0.2)
        assert profiler.trace_fold("trace-prof-1")["samples"] == before
        # Unknown traces are empty folds, not errors.
        assert profiler.trace_fold("no-such-trace")["samples"] == 0
    finally:
        noise.set()
        profiler.disarm()


def test_trace_registry_bounded_and_counted():
    s = profiler.Sampler(hz=0.0, proc="unit-bound", max_traces=8)
    for i in range(13):
        s.thread_trace_end(s.thread_trace_begin(f"tr-{i}"))
    st = s.status()
    assert st["traces"] <= 8
    assert st["traces_evicted"] >= 5


def test_capture_sessions_armed_and_disarmed():
    s = profiler.Sampler(hz=97.0, proc="unit-cap")
    stop = _spin_thread("unit-cap-spin")
    try:
        # Disarmed: capture() self-samples in the calling thread.
        cap = s.capture(seconds=0.3, hz=97.0)
        assert cap["samples"] > 0 and cap["duration_s"] == pytest.approx(0.3)
        assert any("spin" in st for st in cap["stacks"])
        _check_invariant(cap)
        # Armed: the background thread feeds the session accumulator.
        s.start()
        cap = s.capture(seconds=0.3)
        assert cap["samples"] > 0
        assert any("spin" in st for st in cap["stacks"])
        assert s.status()["sessions_started"] == 2
    finally:
        stop.set()
        s.stop()


def test_capture_session_bound_is_typed():
    s = profiler.Sampler(hz=0.0, proc="unit-busy")
    sids = [s.session_begin("cpu") for _ in range(profiler.MAX_SESSIONS)]
    with pytest.raises(profiler.ProfilerBusy, match="capture sessions"):
        s.session_begin("cpu")
    for sid in sids:
        s.session_end(sid)
    assert s.session_begin("cpu") is not None  # freed slots reopen


def test_local_fold_dispatch():
    profiler.arm(hz=97.0, proc="unit-dispatch")
    try:
        st = profiler.local_fold({"status": 1})
        assert st["armed"] and "occupancy" in st
        tf = profiler.local_fold({"trace_id": "nope"})
        assert tf["trace_id"] == "nope" and tf["samples"] == 0
        wf = profiler.local_fold({"window_s": 30.0})
        assert wf["window_s"] == 30.0
        cap = profiler.local_fold({"seconds": 0.1})
        assert cap["duration_s"] == pytest.approx(0.1)
        assert "stacks" in profiler.local_fold({})
    finally:
        profiler.disarm()


def test_aggregate_status_rollup():
    rows = [
        {"proc": "a", "armed": True, "hz": 19.0, "samples": 10,
         "samples_dropped": 1, "stacks": 5, "max_stacks": 10,
         "occupancy": 0.5, "traces": 2, "sessions": [{"kind": "cpu"}]},
        {"proc": "b", "armed": False, "hz": 7.0, "samples": 4,
         "samples_dropped": 0, "stacks": 9, "max_stacks": 10,
         "occupancy": 0.9, "traces": 0, "sessions": []},
        "node x: timeout",  # error rows never poison the rollup
    ]
    agg = profiler.aggregate_status(rows)
    assert agg["procs"] == 2 and agg["armed"] == 1
    assert agg["hz"] == 19.0 and agg["occupancy"] == 0.9  # worst occupancy
    assert agg["samples"] == 14 and agg["samples_dropped"] == 1
    assert agg["sessions"] == 1


def test_armed_idle_overhead_interleaved():
    """Interleaved armed-vs-disabled pairs on a pure-python workload. The
    authoritative <2% gate is bench_core's profiler_overhead row (best-of
    interleaved halves on the RPC path); this asserts the mechanism with CI
    slack — an always-on sampler that costs double digits is a regression
    whatever the weather."""
    def ops(reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            sum(i * i for i in range(500))
        return reps / (time.perf_counter() - t0)

    reps = 400
    ops(reps)  # warm
    s = profiler.Sampler(hz=19.0, proc="unit-ovh")
    on, off = [], []
    try:
        for _ in range(5):
            s.start()
            on.append(ops(reps))
            s.stop()
            off.append(ops(reps))
    finally:
        s.stop()
    best_on, best_off = max(on), max(off)
    overhead = best_off / best_on - 1.0
    assert overhead < 0.10, \
        f"armed-but-idle sampler overhead {overhead:.1%} (on={best_on:.0f} " \
        f"off={best_off:.0f} ops/s)"


# ---------------------------------------------------------------------------
# device profiling: typed-and-loud degrade on this CPU-only host
# ---------------------------------------------------------------------------

def test_device_profiling_typed_on_cpu(tmp_path):
    from ray_tpu_torch.util import tracing

    with pytest.raises(profiler.DeviceProfilerUnavailable, match="device_capture"):
        with profiler.device_capture(str(tmp_path)):
            pass
    # The public API routes through the same session gate and raises the
    # same typed error — no AttributeError mid-capture.
    with pytest.raises(profiler.DeviceProfilerUnavailable):
        with tracing.profile_tpu(str(tmp_path)):
            pass
    with pytest.raises(profiler.DeviceProfilerUnavailable, match="device_server"):
        tracing.profile_server()
    # The failed session never leaks a slot.
    assert not profiler.status()["sessions"]


def test_device_memory_records_gated_on_cpu():
    # A process that has not initialised CUDA reports nothing (and on hosts
    # that never imported torch, nothing gets imported); the port's gauge is
    # gpu.device.bytes_in_use.
    recs = profiler.device_memory_records(ts=123.0)
    assert recs == [] or all(r["name"] == "gpu.device.bytes_in_use"
                             for r in recs)


def test_trace_summary_unions_device_events(tmp_path):
    """The busy share counts the card's own events (kernels, memcpys,
    memsets) as the union of their intervals, never host ops or runtime
    calls, and counts launches per kernel name."""
    import json

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}

    trace = {"traceEvents": [
        ev("cpu_op", "aten::mm", 0.0, 5000.0),
        ev("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0),
        ev("kernel", "flash_fwd_kernel", 100.0, 300.0),
        ev("kernel", "paged_decode_kernel", 250.0, 250.0),  # overlaps the first
        ev("gpu_memcpy", "Memcpy HtoD", 1000.0, 100.0),
        ev("kernel", "paged_decode_kernel", 2000.0, 50.0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3000.0, "pid": 0, "tid": 7},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    out = profiler.trace_summary(str(path), wall_s=0.004)
    assert out["device_events"] == 4
    assert out["device_ms"] == pytest.approx((400.0 + 100.0 + 50.0) / 1e3)
    assert out["kernels"] == {"flash_fwd_kernel": 1, "paged_decode_kernel": 2}
    assert out["wall_ms"] == pytest.approx(4.0)
    assert out["busy"] == pytest.approx(0.55 / 4.0)


def test_device_capture_without_device_events_raises(tmp_path, monkeypatch):
    """Past the device gate (faked here), a window whose trace holds no
    device event raises at exit instead of handing back an empty trace, and
    the session slot is released."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="holds no device event"):
        with profiler.device_capture(str(tmp_path)) as tr:
            torch.ones(64) @ torch.ones(64)
    assert tr.path is None
    assert not profiler.status()["sessions"]


def test_device_server_protocol(tmp_path):
    """The listener behind profile_server (built directly: its gate refuses
    this CPU host): an unknown path answers 404 naming the protocol; a
    capture answers 500 with the capture's own typed error (here, no CUDA
    device), never an empty trace; close() stops it."""
    import json
    import urllib.error
    import urllib.request

    srv = profiler.DeviceServer(0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(f"{base}/status", timeout=30)
        assert e404.value.code == 404 and "/capture" in json.loads(e404.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e500:
            urllib.request.urlopen(f"{base}/capture?seconds=0&logdir={tmp_path}", timeout=30)
        assert e500.value.code == 500
        assert json.loads(e500.value.read())["error"].startswith("DeviceProfilerUnavailable: device_capture")
    finally:
        srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/capture?logdir={tmp_path}", timeout=5)
    assert not profiler.status()["sessions"]


@pytest.mark.cuda
def test_device_capture_finds_one_k1_launch(tmp_path):
    """On the card: one K1 launch (``flash_attention`` on CUDA tensors)
    inside ``profile_tpu`` is in the window's trace, by its kernel name,
    once; the summary's device time is positive and within the wall time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: device traces need the card")
    from ray_tpu_torch.ops import _build, attention as att
    from ray_tpu_torch.util import tracing

    try:
        _build._nvcc()
    except _build.KernelBuildError as e:
        pytest.skip(str(e))
    q = torch.randn(2, 256, 4, 64, device="cuda").bfloat16()
    k, v = (torch.randn(2, 256, 2, 64, device="cuda").bfloat16() for _ in range(2))
    att.flash_attention(q, k, v)  # build and load outside the window
    torch.cuda.synchronize()
    before = att.LAUNCHES
    with tracing.profile_tpu(str(tmp_path)) as tr:
        att.flash_attention(q, k, v)
    assert att.LAUNCHES - before == 1
    out = tr.summary()
    k1 = {n: c for n, c in out["kernels"].items() if "flash_fwd" in n}
    assert sum(k1.values()) == 1, out["kernels"]
    assert 0 < out["device_ms"] <= out["wall_ms"]


# ---------------------------------------------------------------------------
# flight dumps carry their own flamegraph
# ---------------------------------------------------------------------------

def test_flight_dump_carries_profile_window(tmp_path):
    from ray_tpu_torch.obs import flight

    profiler.arm(hz=97.0, proc="unit-flight")
    stop = _spin_thread("unit-flight-spin")
    try:
        deadline = time.time() + 15
        while (time.time() < deadline
               and profiler.window_fold(60.0)["samples"] < 3):
            time.sleep(0.1)
        rec = flight.FlightRecorder(capacity=16)
        rec.configure(proc_id="unit-flight", dump_dir=str(tmp_path))
        rec.record("unit.tick")
        path = rec.dump("manual", reason="profiler round trip")
        header, _events = flight.load_dump(path)
        prof = header.get("profile")
        assert prof and prof["samples"] >= 3, \
            "incident dump is missing its flamegraph"
        _check_invariant(prof)
    finally:
        stop.set()
        profiler.disarm()

    # Disarmed process: dumps simply omit the profile — never an error.
    rec = flight.FlightRecorder(capacity=4)
    rec.configure(proc_id="unit-flight2", dump_dir=str(tmp_path))
    rec.record("unit.tick")
    header, _ = flight.load_dump(rec.dump("manual"))
    assert "profile" not in header


# ---------------------------------------------------------------------------
# live cluster: traced request -> per-trace profile on /api/profile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prof_cluster():
    from ray_tpu_torch.core.api import Cluster, init
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.profile_hz = 97.0  # fast ticks so a ~300ms handler lands samples
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=16)
    init(address=cluster.address, config=cfg)
    serve.start(proxy=True)

    @serve.deployment
    class Burner:
        def __call__(self, request):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.3:  # sampled, visible burn
                sum(i * i for i in range(1000))
            return {"ok": True}

    serve.run(Burner.bind(), name="prof_app", route_prefix="/prof")
    from ray_tpu_torch import dashboard

    dash_port = dashboard.start_dashboard(port=0)
    yield serve.http_port(), dash_port
    dashboard.stop_dashboard()
    serve.shutdown()
    rt.shutdown()
    cluster.shutdown()


def _api(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=90) as r:
        assert r.status == 200
        ctype = r.headers.get("Content-Type", "")
        body = r.read()
    if ctype.startswith("application/json"):
        return json.loads(body)
    return body.decode()


def test_traced_request_profile_on_api(prof_cluster):
    http_port, dash_port = prof_cluster
    req = urllib.request.Request(f"http://127.0.0.1:{http_port}/prof",
                                 headers={"x-trace": "1"})
    with urllib.request.urlopen(req, timeout=90) as resp:
        assert resp.status == 200

    from ray_tpu_torch.core import api as _api_mod

    core = _api_mod._require_worker()
    deadline = time.time() + 45
    trace_id = None
    while time.time() < deadline and trace_id is None:
        traces = core._run(core.controller.call(
            "list_traces", {"q": "serve.request"}))
        if traces:
            trace_id = traces[0]["trace_id"]
            break
        time.sleep(0.5)
    assert trace_id, "the traced request never reached the trace index"

    # The request's own flamegraph is retrievable from /api/profile, and
    # its exec hop lands in the right plane bucket: the handler's burn loop
    # is user code under the executor -> "exec".
    deadline = time.time() + 60
    fold = {}
    while time.time() < deadline:
        fold = _api(dash_port, f"/api/profile?trace={trace_id}")
        if fold.get("samples", 0) >= 2:
            break
        time.sleep(0.5)
    assert fold.get("samples", 0) >= 2, \
        f"per-trace profile never materialised: {fold}"
    assert fold.get("trace_id") == trace_id
    assert fold["planes"].get("exec", 0) >= 1, \
        f"exec hop not attributed: planes={fold.get('planes')}"
    _check_invariant(fold)


def test_cluster_flamegraph_and_summary_on_api(prof_cluster):
    http_port, dash_port = prof_cluster
    with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/prof",
                                timeout=90) as resp:
        assert resp.status == 200

    fold = _api(dash_port, "/api/profile?window=120")
    assert fold["samples"] > 0 and fold["stacks"]
    # Merged across processes: the driver/head plus worker subprocesses.
    assert len(fold["procs"]) >= 2, fold["procs"]
    _check_invariant(fold)

    # Collapsed-stack text renders the same fold, hottest first.
    text = _api(dash_port, "/api/profile?window=120&fmt=collapsed")
    assert isinstance(text, str) and text
    first = text.splitlines()[0]
    assert re.match(r"^.+ \d+$", first), first

    # The ?summary=1 rollup backs the `raytpu status` one-liner.
    summary = _api(dash_port, "/api/profile?summary=1")
    agg = summary["aggregate"]
    assert agg["procs"] >= 2 and agg["armed"] >= 2
    assert agg["hz"] == pytest.approx(97.0)
    assert 0.0 <= agg["occupancy"] <= 1.0

    # Incident registry is reachable (empty here — nothing alerted).
    inc = _api(dash_port, "/api/profile?incidents=1")
    assert "incidents" in inc and "suppressed" in inc

