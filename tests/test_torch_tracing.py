"""The port's distributed tracing: the cases of ``tests/test_tracing.py`` on
port clusters, plus a compiled-DAG run traced stage by stage.

Distributed tracing: span propagation through every cross-process hop.

The acceptance path: one serve HTTP request drives
proxy -> replica -> nested actor; every resulting span must share one
trace_id with correct parent/child links, and export_timeline must emit
connected flow events (ph s/f) for the hops."""
import json
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.util import tracing
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module")
def serve_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=True)
    yield rt
    serve.shutdown()
    rt.shutdown()


# ---------------------------------------------------------------------------
# span API semantics (in-process)
# ---------------------------------------------------------------------------

def test_span_nesting_and_context(serve_cluster):
    assert tracing.current_trace() is None
    with tracing.span("outer") as outer:
        assert tracing.current_trace() == (outer.trace_id, outer.span_id)
        assert outer.parent_id == ""
        with tracing.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert tracing.current_trace() == (inner.trace_id, inner.span_id)
        assert tracing.current_trace() == (outer.trace_id, outer.span_id)
    assert tracing.current_trace() is None


def test_child_span_noop_without_active_trace(serve_cluster):
    with tracing.child_span("ignored") as s:
        assert s is None  # nullcontext: no ids minted, nothing recorded
        assert tracing.current_trace() is None
    with tracing.span("root") as root:
        with tracing.child_span("kid") as kid:
            assert kid is not None and kid.parent_id == root.span_id


def test_task_spans_share_trace_and_parent(serve_cluster):
    @rt.remote
    def leaf(x):
        return x + 1

    with tracing.span("task-root") as root:
        assert rt.get(leaf.remote(1), timeout=60) == 2

    events = _wait_trace(root.trace_id, want_kinds={"task_submitted", "task_exec_start"})
    subs = [e for e in events if e["kind"] == "task_submitted"]
    execs = [e for e in events if e["kind"] == "task_exec_start"]
    assert subs and execs
    assert all(e["trace_id"] == root.trace_id for e in subs + execs)
    assert subs[0]["span_id"] == root.span_id  # submission annotated with caller span
    assert execs[0]["parent_id"] == root.span_id  # exec span is the caller's child


def _wait_trace(trace_id: str, want_kinds=frozenset(), min_workers: int = 1,
                predicate=None, timeout_s: float = 90.0):
    """Poll the controller's trace index until the wanted event kinds, enough
    distinct worker processes, AND an optional predicate over the events all
    hold (remote workers flush their buffers on the reporter tick, so hops
    arrive staggered — see tracing.get_trace's staleness note)."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    deadline = time.time() + timeout_s
    events: list = []
    while time.time() < deadline:
        core._run(core._flush_task_events())
        events = core._run(core.controller.call("get_trace", {"trace_id": trace_id}))
        if (set(want_kinds) <= {e.get("kind") for e in events}
                and len({e.get("worker") for e in events}) >= min_workers
                and (predicate is None or predicate(events))):
            return events
        time.sleep(0.5)
    return events


# ---------------------------------------------------------------------------
# acceptance: serve request through proxy -> replica -> actor
# ---------------------------------------------------------------------------

def test_serve_request_single_trace_across_hops(serve_cluster, tmp_path):
    @rt.remote
    class Shouter:
        def shout(self, s):
            return s.upper()

    @serve.deployment
    class Ingress:
        def __init__(self, downstream):
            self.downstream = downstream

        def __call__(self, request):
            return {"msg": rt.get(self.downstream.shout.remote("hello"), timeout=30)}

    downstream = Shouter.remote()
    rt.get(downstream.shout.remote("warm"), timeout=60)
    serve.run(Ingress.bind(downstream), name="traced_app", route_prefix="/traced")
    port = serve.http_port()

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/traced", headers={"x-trace": "1"}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        assert json.loads(resp.read()) == {"msg": "HELLO"}

    # Find the request's trace via the root span name.
    from ray_tpu_torch.core import api

    core = api._require_worker()
    deadline = time.time() + 45
    trace_id = None
    while time.time() < deadline and trace_id is None:
        traces = core._run(core.controller.call("list_traces", {"q": "serve.request"}))
        if traces:
            trace_id = traces[0]["trace_id"]
            break
        time.sleep(0.5)
    assert trace_id, "no serve.request trace was indexed"

    events = _wait_trace(
        trace_id, want_kinds={"span", "task_exec_start"}, min_workers=3,
        # All three hops must have landed: the replica's serve span and the
        # downstream actor's exec span arrive on their own reporter ticks.
        predicate=lambda evs: (
            any(e.get("name", "").startswith("serve.replica.") for e in evs)
            and any(e.get("fn") == "shout" and e["kind"] == "task_exec_start" for e in evs)
        ),
    )
    assert all(e.get("trace_id") == trace_id for e in events)

    spans = {}  # span_id -> event (spans + exec spans both mint span ids)
    for e in events:
        if e.get("span_id") and e["kind"] in ("span", "task_exec_start"):
            spans[e["span_id"]] = e

    roots = [e for e in spans.values() if e["kind"] == "span" and not e.get("parent_id")]
    assert len(roots) == 1 and roots[0]["name"] == "serve.request"

    # The request crossed at least proxy + replica + downstream-actor
    # processes, each contributing spans to the SAME trace.
    workers = {e.get("worker") for e in spans.values()}
    assert len(workers) >= 3, f"expected >=3 processes in trace, got {workers}"

    # Every non-root span's parent resolves inside the trace: one connected
    # tree, no orphaned hops.
    ids = set(spans)
    for e in spans.values():
        if e is roots[0]:
            continue
        assert e.get("parent_id") in ids, f"orphaned span {e}"

    # The replica's serve span and the downstream actor's exec span are on
    # the path: replica span parents the shout exec (via the replica's
    # active context at submission).
    replica_spans = [e for e in spans.values()
                     if e["kind"] == "span" and e["name"].startswith("serve.replica.")]
    assert replica_spans
    shout_execs = [e for e in spans.values()
                   if e["kind"] == "task_exec_start" and e.get("fn") == "shout"]
    assert shout_execs

    # Flow events connect the hops in the exported timeline.
    out = str(tmp_path / "serve_trace.json")
    tracing.export_timeline(out)
    data = json.load(open(out))
    flows = [e for e in data["traceEvents"] if e.get("ph") in ("s", "f")
             and e.get("args", {}).get("trace_id") == trace_id]
    starts = {e["id"] for e in flows if e["ph"] == "s"}
    finishes = {e["id"] for e in flows if e["ph"] == "f"}
    assert starts & finishes, "no connected flow (s/f) pair for the request's hops"

    serve.delete("traced_app")


def test_trace_overhead_guard_no_context_cost(serve_cluster):
    """With no span active, submission attaches None and no trace events are
    recorded — the guard path."""
    @rt.remote
    class Quiet:
        def ping(self):
            return b"ok"

    a = Quiet.remote()
    rt.get(a.ping.remote(), timeout=60)
    from ray_tpu_torch.core import api

    core = api._require_worker()
    before = len(core.task_events)
    rt.get([a.ping.remote() for _ in range(50)], timeout=120)
    # Untraced actor calls emit no tracing events (task_finished bookkeeping
    # predates this feature and stays).
    new = core.task_events[before:]
    assert not [e for e in new
                if "trace_id" in e
                or e["kind"] in ("span", "task_submitted", "task_exec_start")]


def test_dag_stages_are_spans_of_the_callers_trace(serve_cluster):
    """A compiled-DAG execution under a root span: each stage records one
    ``dag.<method>`` span in its actor's process, the first a child of the
    root, the second a child of the first (the context rides ``dag_push``)."""
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    class Stage:
        def first(self, x):
            return x + 1

        def second(self, x):
            return x * 2

    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        out = b.second.bind(a.first.bind(inp))
    dag = out.experimental_compile()
    try:
        with tracing.span("dag-root") as root:
            assert dag.execute(3).result(timeout=60) == 8
    finally:
        dag.teardown()

    def two_stages(evs):
        return {"dag.first", "dag.second"} <= {e.get("name") for e in evs}

    events = _wait_trace(root.trace_id, want_kinds={"span"}, min_workers=2,
                         predicate=two_stages)
    spans = {e["name"]: e for e in events if e.get("kind") == "span"}
    assert spans["dag.first"]["parent_id"] == root.span_id
    assert spans["dag.second"]["parent_id"] == spans["dag.first"]["span_id"]
    assert spans["dag.first"]["worker"] != spans["dag.second"]["worker"]
