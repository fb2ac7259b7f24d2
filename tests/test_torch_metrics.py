"""The port's metrics pipeline: the cases of ``tests/test_metrics.py``, the
four live-dashboard cases included.

Metrics pipeline + dashboard: Prometheus exposition correctness
(contiguous metric blocks, cumulative histogram buckets, label escaping),
multi-reporter merge semantics (counters sum, gauges stay per-reporter),
dropped-event accounting, and the dashboard JSON endpoints on a live
cluster. Mirrors the reference's metrics-agent/exporter tests
(python/ray/tests/test_metrics_agent.py) at the controller layer."""
import json
import re
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util.metrics import prometheus_text
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


# ---------------------------------------------------------------------------
# exposition-format round-trip parser
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$")


def parse_prometheus(text: str) -> dict:
    """Strict-enough exposition parser: every sample must sit inside the
    block opened by its metric's TYPE line (contiguity), values must parse
    as floats, and TYPE must not repeat. Returns
    {name: {"type": kind, "samples": [(sample_name, labels, value)]}}."""
    metrics: dict = {}
    current = None
    closed = set()
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if current is not None and current != name:
                closed.add(current)
            assert name not in metrics, f"TYPE repeated for {name}"
            assert name not in closed, f"{name} block reopened (samples interleaved)"
            metrics[name] = {"type": kind, "samples": []}
            current = name
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        sname, labels, value = m.group(1), m.group(2) or "", m.group(3)
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[: -len(suffix)] in metrics:
                base = sname[: -len(suffix)]
                break
        assert base == current, (
            f"sample {sname} appears inside {current}'s block (non-contiguous)"
        )
        float(value)
        metrics[base]["samples"].append((sname, labels, value))
    return metrics


# ---------------------------------------------------------------------------
# prometheus_text unit tests (no cluster)
# ---------------------------------------------------------------------------

def test_prometheus_empty_registry():
    text = prometheus_text([])
    assert parse_prometheus(text) == {}


def test_prometheus_groups_interleaved_metrics():
    # A merged-series list can interleave metrics (multi-reporter dict merge
    # order): the renderer must still emit contiguous blocks.
    series = [
        {"name": "alpha", "kind": "counter", "description": "", "tags": {"w": "1"}, "value": 1.0},
        {"name": "beta", "kind": "gauge", "description": "", "tags": {}, "value": 2.0},
        {"name": "alpha", "kind": "counter", "description": "", "tags": {"w": "2"}, "value": 3.0},
    ]
    parsed = parse_prometheus(prometheus_text(series))
    assert set(parsed) == {"raytpu_alpha", "raytpu_beta"}
    assert len(parsed["raytpu_alpha"]["samples"]) == 2


def test_prometheus_histogram_cumulative_buckets():
    series = [{
        "name": "lat", "kind": "histogram", "description": "d", "tags": {"k": "v"},
        "value": 0.0, "buckets": [0.1, 1.0, 10.0], "counts": [2, 3, 1, 4],
        "sum": 12.5, "n": 10,
    }]
    text = prometheus_text(series)
    parsed = parse_prometheus(text)
    samples = parsed["raytpu_lat"]["samples"]
    values = [float(v) for s, _l, v in samples if s.endswith("_bucket")]
    # Cumulative: non-decreasing, +Inf equals total observations in-range.
    assert values == sorted(values)
    assert values == [2.0, 5.0, 6.0, 10.0]
    count = [float(v) for s, _l, v in samples if s.endswith("_count")]
    assert count == [10.0]
    assert any('le="+Inf"' in l for _s, l, _v in samples)


def test_prometheus_label_escaping():
    series = [{
        "name": "esc", "kind": "gauge", "description": "multi\nline",
        "tags": {"path": 'a"b\\c\nnew'}, "value": 1.0,
    }]
    text = prometheus_text(series)
    parsed = parse_prometheus(text)
    (_s, labels, _v), = parsed["raytpu_esc"]["samples"]
    assert '\\"' in labels and "\\\\" in labels and "\\n" in labels
    assert "\n" not in labels  # raw newline would break line-oriented parsing


def test_prometheus_unobserved_histogram_renders_empty():
    # A histogram series that exists (bound) but never observed must not
    # crash the renderer and must stay internally consistent.
    series = [{"name": "h", "kind": "histogram", "description": "", "tags": {}, "value": 0.0}]
    parsed = parse_prometheus(prometheus_text(series))
    samples = parsed["raytpu_h"]["samples"]
    assert [float(v) for s, _l, v in samples if s.endswith("_count")] == [0.0]


# ---------------------------------------------------------------------------
# controller merge semantics (direct Controller instance, no sockets)
# ---------------------------------------------------------------------------

def _mk_controller(**cfg_overrides):
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.controller import Controller

    cfg = Config()
    for k, v in cfg_overrides.items():
        setattr(cfg, k, v)
    return Controller(cfg)


def _series(name, kind, value, tags=None, **extra):
    return {"name": name, "kind": kind, "description": "", "tags": tags or {},
            "value": value, "ts": time.time(), **extra}


def test_merge_counters_sum_across_reporters():
    c = _mk_controller()
    c.handle_report_metrics(None, {"reporter": "w1", "series": [_series("reqs", "counter", 3.0)]})
    c.handle_report_metrics(None, {"reporter": "w2", "series": [_series("reqs", "counter", 4.0)]})
    merged = {r["name"]: r for r in c.handle_get_metrics(None, {}) if r["name"] == "reqs"}
    assert merged["reqs"]["value"] == 7.0


def test_merge_gauges_stay_per_reporter():
    # Regression: gauges used to be summed like counters — a per-process
    # memory fraction of 0.3 + 0.5 reported 0.8 cluster-wide.
    c = _mk_controller()
    c.handle_report_metrics(None, {"reporter": "w1aaaaaaaaaaaaaa", "series": [_series("mem.frac", "gauge", 0.3)]})
    c.handle_report_metrics(None, {"reporter": "w2bbbbbbbbbbbbbb", "series": [_series("mem.frac", "gauge", 0.5)]})
    gauges = [r for r in c.handle_get_metrics(None, {}) if r["name"] == "mem.frac"]
    assert sorted(g["value"] for g in gauges) == [0.3, 0.5]
    assert all("reporter" in g["tags"] for g in gauges)
    assert len({g["tags"]["reporter"] for g in gauges}) == 2


def test_merge_histograms_sum_matching_buckets_only():
    c = _mk_controller()
    h1 = _series("lat", "histogram", 0.0, buckets=[1, 2], counts=[1, 0, 0], sum=0.5, n=1)
    h2 = _series("lat", "histogram", 0.0, buckets=[1, 2], counts=[0, 2, 0], sum=3.0, n=2)
    h3 = _series("lat", "histogram", 0.0, buckets=[5, 10], counts=[1, 0, 0], sum=2.0, n=1)
    c.handle_report_metrics(None, {"reporter": "w1", "series": [h1]})
    c.handle_report_metrics(None, {"reporter": "w2", "series": [h2]})
    c.handle_report_metrics(None, {"reporter": "w3", "series": [h3]})
    hists = [r for r in c.handle_get_metrics(None, {}) if r["name"] == "lat"]
    assert len(hists) == 2  # mismatched boundaries keep their own series
    merged = next(h for h in hists if h["buckets"] == [1, 2])
    assert merged["counts"] == [1, 2, 0] and merged["n"] == 3


def test_controller_counts_dropped_events():
    c = _mk_controller(event_buffer_size=8)
    for i in range(40):
        c._event("tick", i=i)
    assert c.events_dropped > 0
    # Task-event buffer trims are counted too and surfaced via get_events.
    c.handle_report_task_events(None, {"events": [{"ts": 0.0, "kind": "x"}] * (4 * 8 + 1)})
    out = c.handle_get_events(None, {"with_stats": True})
    assert out["dropped"]["controller_events"] == c.events_dropped
    assert out["dropped"]["task_events"] == c.task_events_dropped > 0
    # Metrics view carries the same counters.
    dropped = [r for r in c.handle_get_metrics(None, {}) if r["name"] == "events_dropped_total"]
    assert dropped and all(r["kind"] == "counter" for r in dropped)


def test_trace_index_bounded():
    c = _mk_controller()
    for i in range(c.MAX_TRACES + 20):
        c.handle_report_task_events(None, {"events": [
            {"ts": float(i), "kind": "span", "worker": "w", "name": f"t{i}",
             "trace_id": f"trace{i:04d}", "span_id": "s", "parent_id": ""},
        ]})
    assert len(c.traces) == c.MAX_TRACES
    assert c.traces_evicted == 20  # whole-trace evictions are tallied
    listed = c.handle_list_traces(None, {"limit": 10})
    assert len(listed) == 10
    assert listed[0]["trace_id"] == f"trace{c.MAX_TRACES + 19:04d}"  # newest first
    # filter by name
    assert c.handle_list_traces(None, {"q": listed[0]["name"]})


# ---------------------------------------------------------------------------
# live cluster: dashboard endpoints + /metrics round-trip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dash(shared_ray):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    port = start_dashboard(port=0)
    yield port
    stop_dashboard()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def test_dashboard_api_cluster(shared_ray, dash):
    status, body = _get(dash, "/api/cluster")
    assert status == 200
    state = json.loads(body)
    assert state["nodes"] and any(n["state"] == "ALIVE" for n in state["nodes"].values())


def test_dashboard_api_events_surfaces_drops(shared_ray, dash):
    status, body = _get(dash, "/api/events")
    assert status == 200
    payload = json.loads(body)
    assert "events" in payload
    assert set(payload["dropped"]) == {
        "controller_events", "task_events", "worker_events", "traces_evicted",
        "tasks_evicted", "flight_dumps",
    }


def test_metrics_exposition_live_round_trip(shared_ray, dash):
    from ray_tpu_torch.core import api

    @rt.remote
    def burn():
        return 1

    rt.get([burn.remote() for _ in range(4)], timeout=120)
    core = api._require_worker()
    core._run(core._report_metrics())  # driver series land immediately

    # Worker-side series (task latency) arrive with the worker's reporter
    # tick; poll /metrics until present.
    deadline = time.time() + 45
    parsed = {}
    while time.time() < deadline:
        status, body = _get(dash, "/metrics")
        assert status == 200
        parsed = parse_prometheus(body.decode())
        if "raytpu_task_exec_latency_s" in parsed:
            break
        time.sleep(1.0)
    # Acceptance: envelope-batch, bytes-on-wire, object-store and
    # task-latency series flow through reporter -> controller -> /metrics.
    for name in ("raytpu_rpc_envelope_messages", "raytpu_rpc_bytes",
                 "raytpu_object_store_ops", "raytpu_object_store_bytes",
                 "raytpu_task_exec_latency_s", "raytpu_scheduler_queue_depth",
                 "raytpu_scheduler_pending"):
        assert name in parsed, f"{name} missing from /metrics ({sorted(parsed)})"
    assert parsed["raytpu_task_exec_latency_s"]["type"] == "histogram"
    # Histogram buckets cumulative on the live output too.
    values = [float(v) for s, _l, v in parsed["raytpu_task_exec_latency_s"]["samples"]
              if s.endswith("_bucket")]
    assert values and values == sorted(values)


def test_dashboard_api_traces_endpoint(shared_ray, dash):
    from ray_tpu_torch.util import tracing

    @rt.remote
    def traced():
        return 2

    with tracing.span("dash-trace-test") as s:
        rt.get(traced.remote(), timeout=60)
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    deadline = time.time() + 30
    found = []
    while time.time() < deadline and not found:
        _status, body = _get(dash, "/api/traces?q=dash-trace-test")
        found = [t for t in json.loads(body) if t["trace_id"] == s.trace_id]
        if not found:
            time.sleep(0.5)
    assert found, "trace not indexed on /api/traces"
    _status, body = _get(dash, f"/api/traces?id={s.trace_id}")
    events = json.loads(body)
    assert any(e.get("kind") == "span" and e.get("name") == "dash-trace-test" for e in events)
