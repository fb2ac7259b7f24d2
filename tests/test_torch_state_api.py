"""The port's state introspection (``ray_tpu_torch.state``, the controller's
task index): the cases of ``tests/test_state_api.py`` on port clusters.
``test_every_worker_event_kind_maps_to_fsm`` lints the port's worker with
the port's own analyzer (``ray_tpu_torch.analysis``), whose fsm-emitter
rule reads the port's ``core/task_state.py``.

State introspection: task lifecycle FSM completeness, the controller's
bounded per-task index (filters, truncation, eviction accounting), the
`since` event cursor, and the live state API (`ray_tpu_torch.state`) against a
real cluster — RUNNING attribution and the `ray memory` equivalent's
owner/borrower round trip. Mirrors the reference's state-API tests
(python/ray/tests/test_state_api.py) at this controller's layer."""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import task_state as ts
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


# ---------------------------------------------------------------------------
# FSM definition + emitter lint (no cluster)
# ---------------------------------------------------------------------------

def test_fsm_tables_consistent():
    # Every mapped state is a declared state; terminal states emit nothing.
    for state in ts.EVENT_STATE.values():
        assert state is None or state in ts.STATES
    for src, dsts in ts.TRANSITIONS.items():
        assert src in ts.STATES
        for dst in dsts:
            assert dst in ts.STATES
    for terminal in ts.TERMINAL:
        assert not ts.TRANSITIONS[terminal]
    # Every non-initial state is reachable.
    reachable = set()
    for dsts in ts.TRANSITIONS.values():
        reachable |= dsts
    assert reachable | {ts.PENDING_ARGS_AVAIL, ts.PENDING_NODE_ASSIGNMENT} == set(ts.STATES)


def test_every_worker_event_kind_maps_to_fsm():
    """Thin wrapper over graftlint's fsm-emitter rule (the ad-hoc AST scan
    that used to live here migrated into ray_tpu_torch/analysis/rules_fsm.py).
    Asserts the rule still SEES emitters — a scan that finds zero emitters
    has silently gone dead and gates nothing — and that worker.py's kinds
    all map into the FSM."""
    import ray_tpu_torch.core.worker as worker_mod
    from ray_tpu_torch.analysis import lint_paths

    result = lint_paths([worker_mod.__file__])
    stats = result.stats.get(worker_mod.__file__, {}).get("fsm-emitter")
    assert stats and stats["emitters"] >= 1, "fsm-emitter scan found no emitters — the scan is broken"
    fsm_findings = [f for f in result.findings if f.rule == "fsm-emitter"]
    assert not fsm_findings, "\n".join(f.render() for f in fsm_findings)




def test_fold_converges_regardless_of_arrival_order():
    """Caller and executor report through different buffers: the fold must
    reach the same record for any interleaving of the same events."""
    evs = [
        {"kind": "task_pending_args", "task_id": "t1", "attempt": 0, "ts": 1.0, "fn": "f"},
        {"kind": "task_submitted", "task_id": "t1", "attempt": 0, "ts": 2.0, "fn": "f"},
        {"kind": "task_dispatched", "task_id": "t1", "attempt": 0, "ts": 3.0,
         "node": "nodeA", "exec_worker": "workerB"},
        {"kind": "task_exec_start", "task_id": "t1", "attempt": 0, "ts": 4.0,
         "worker": "workerB", "node": "nodeA"},
        {"kind": "task_exec_end", "task_id": "t1", "attempt": 0, "ts": 5.0, "worker": "workerB"},
        {"kind": "task_finished", "task_id": "t1", "attempt": 0, "ts": 6.0, "status": "ok"},
    ]
    import itertools

    records = []
    for perm in itertools.permutations(evs):
        rec = {"task_id": "t1", "attempt": 0}
        for ev in perm:
            ts.fold(rec, ev)
        records.append(rec)
    first = records[0]
    assert first["state"] == ts.FINISHED
    assert first["node_id"] == "nodeA" and first["worker_id"] == "workerB"
    assert first["times"][ts.RUNNING] == 4.0 and first["times"]["exec_end"] == 5.0
    for rec in records[1:]:
        assert rec == first


def test_fold_failed_is_terminal_and_carries_error_type():
    rec = {"task_id": "t", "attempt": 0}
    ts.fold(rec, {"kind": "task_failed", "task_id": "t", "ts": 1.0,
                  "error_type": "ValueError"})
    ts.fold(rec, {"kind": "task_exec_start", "task_id": "t", "ts": 2.0})
    assert rec["state"] == ts.FAILED  # terminal: a late exec event can't revive it
    assert rec["error_type"] == "ValueError"
    # task_finished with status=error maps to FAILED too.
    rec2 = {"task_id": "t2", "attempt": 0}
    ts.fold(rec2, {"kind": "task_finished", "task_id": "t2", "ts": 1.0,
                   "status": "error", "error_type": "ZeroDivisionError"})
    assert rec2["state"] == ts.FAILED and rec2["error_type"] == "ZeroDivisionError"


# ---------------------------------------------------------------------------
# controller index: bounds, eviction, filters, truncation, cursor (no sockets)
# ---------------------------------------------------------------------------

def _mk_controller(**cfg_overrides):
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.controller import Controller

    cfg = Config()
    for k, v in cfg_overrides.items():
        setattr(cfg, k, v)
    return Controller(cfg)


def _report(c, *events):
    c.handle_report_task_events(None, {"events": list(events)})


def _lifecycle(task_id, kind, attempt=0, **kw):
    return {"kind": kind, "task_id": task_id, "attempt": attempt,
            "ts": time.time(), **kw}


def test_task_index_bounded_terminal_first_eviction():
    c = _mk_controller(task_index_size=32)
    # 8 live tasks first (oldest), then a flood of finished ones.
    for i in range(8):
        _report(c, _lifecycle(f"live{i}", "task_exec_start", fn="live"))
    for i in range(100):
        _report(c, _lifecycle(f"done{i}", "task_finished", status="ok", fn="done"))
    assert len(c.task_index) == 32
    assert c.tasks_evicted == 76
    # The live (non-terminal) records survived: finished ones were shed first.
    live = [r for r in c.task_index.values() if r["state"] == ts.RUNNING]
    assert len(live) == 8
    # Eviction is surfaced on the events endpoint and list replies.
    out = c.handle_get_events(None, {"with_stats": True})
    assert out["dropped"]["tasks_evicted"] == 76
    assert c.handle_list_tasks(None, {})["evicted"] == 76
    # ... and raw-buffer trims don't touch the index (live-task state
    # survives task_events trims — the point of the index).
    c.task_events_dropped += 0
    before = dict(c.task_index)
    c.task_events.clear()
    assert c.task_index == before


def test_task_index_keyed_per_attempt():
    c = _mk_controller()
    _report(c, _lifecycle("t", "task_submitted", attempt=0, fn="f"))
    _report(c, _lifecycle("t", "task_failed", attempt=0, error_type="ConnectionLost"))
    _report(c, _lifecycle("t", "task_submitted", attempt=1, fn="f"))
    _report(c, _lifecycle("t", "task_finished", attempt=1, status="ok"))
    attempts = c.handle_get_task(None, {"task_id": "t"})
    assert [a["attempt"] for a in attempts] == [0, 1]
    assert attempts[0]["state"] == ts.FAILED
    assert attempts[0]["error_type"] == "ConnectionLost"
    assert attempts[1]["state"] == ts.FINISHED


def test_list_tasks_filters_and_truncation():
    c = _mk_controller()
    for i in range(10):
        _report(c, _lifecycle(f"a{i:02d}", "task_exec_start", fn="alpha_fn",
                              node="node1", job="jobA"))
    for i in range(5):
        _report(c, _lifecycle(f"b{i:02d}", "task_finished", status="ok",
                              fn="beta_fn", job="jobB"))
    out = c.handle_list_tasks(None, {"state": "RUNNING"})
    assert out["total"] == 10 and out["truncated"] == 0
    assert all(t["state"] == "RUNNING" for t in out["tasks"])
    out = c.handle_list_tasks(None, {"fn": "beta"})
    assert out["total"] == 5
    out = c.handle_list_tasks(None, {"job": "jobA"})
    assert out["total"] == 10
    out = c.handle_list_tasks(None, {"node": "node1"})
    assert out["total"] == 10
    # Truncation marker: total counts matches, tasks holds only the limit.
    out = c.handle_list_tasks(None, {"limit": 3})
    assert out["total"] == 15 and out["truncated"] == 12 and len(out["tasks"]) == 3
    # Newest first.
    assert out["tasks"][0]["task_id"] == "b04"
    # Summary rollup.
    s = c.handle_summary_tasks(None, {})
    assert s["summary"]["alpha_fn"]["states"]["RUNNING"] == 10
    assert s["summary"]["beta_fn"]["states"]["FINISHED"] == 5
    assert s["total_tasks"] == 15
    s = c.handle_summary_tasks(None, {"job": "jobB"})
    assert list(s["summary"]) == ["beta_fn"]


def test_unknown_event_kinds_do_not_index():
    c = _mk_controller()
    _report(c, {"kind": "x", "ts": 0.0}, {"kind": "span", "ts": 0.0, "task_id": "s"})
    assert c.task_index == {}


def test_get_task_events_since_cursor():
    c = _mk_controller(event_buffer_size=8)
    _report(c, *[_lifecycle(f"t{i}", "task_submitted") for i in range(6)])
    out = c.handle_get_task_events(None, {"since": 0, "limit": 4})
    assert len(out["events"]) == 4 and out["next"] == 4 and out["missed"] == 0
    assert out["truncated"] is True
    out = c.handle_get_task_events(None, {"since": out["next"], "limit": 100})
    assert len(out["events"]) == 2 and out["next"] == 6 and not out["truncated"]
    # Nothing new: an idle poll is an empty copy, not a 20k-event re-send.
    out = c.handle_get_task_events(None, {"since": out["next"], "limit": 100})
    assert out["events"] == [] and out["next"] == 6
    # Force a trim; a stale cursor reports exactly how many events it missed.
    _report(c, *[_lifecycle(f"u{i}", "task_submitted") for i in range(30)])
    assert c.task_events_dropped > 0
    out = c.handle_get_task_events(None, {"since": 6, "limit": 1000})
    assert out["missed"] == c.task_events_dropped - 6
    assert out["next"] == c.task_events_dropped + len(c.task_events)
    # The legacy no-cursor form still returns a plain list.
    assert isinstance(c.handle_get_task_events(None, {"limit": 5}), list)
    # A cursor past the end (controller restarted: base + buffer reset)
    # REWINDS to the current end instead of freezing on empty replies —
    # the poller adopts the smaller `next` and self-heals.
    end = c.task_events_dropped + len(c.task_events)
    out = c.handle_get_task_events(None, {"since": end + 10_000, "limit": 100})
    assert out["events"] == [] and out["next"] == end


# ---------------------------------------------------------------------------
# live cluster: RUNNING attribution + memory round trip
# ---------------------------------------------------------------------------

@rt.remote
def _sleepy(barrier_dir, i):
    import os
    import time as _t

    open(os.path.join(barrier_dir, f"started-{i}"), "w").close()
    _t.sleep(8)
    return i


@rt.remote
def _boom():
    raise ValueError("intended")


@rt.remote
class _Owner:
    def make(self, nbytes):
        self.ref = rt.put(b"m" * nbytes)
        return [self.ref]


@rt.remote
class _Borrower:
    def take(self, refs):
        self.held = refs[0]
        return len(rt.get(refs[0]))


def _wait_for(fn, timeout=20.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.slow  # heavy battery, slow as in the reference suite
def test_state_api_live_cluster(tmp_path):
    from ray_tpu_torch import state

    rt.init(num_cpus=4)
    try:
        refs = [_sleepy.remote(str(tmp_path), i) for i in range(2)]
        _wait_for(lambda: len(list(tmp_path.iterdir())) >= 1, what="task start")

        # RUNNING with node/worker attribution (events ride the debounced
        # flush, so poll briefly).
        running = _wait_for(
            lambda: state.list_tasks(state="RUNNING", fn="_sleepy")["tasks"],
            what="RUNNING task in index",
        )
        workers = {w["worker_id"]: w for w in state.list_workers()["workers"]}
        nodes = {n["node_id"] for n in state.list_nodes()["nodes"]}
        for t in running:
            assert t["node_id"] in nodes
            # worker ids in events are the 12-char form.
            assert any(w.startswith(t["worker_id"]) for w in workers)
            assert t["times"]["RUNNING"] >= t["times"]["PENDING_NODE_ASSIGNMENT"]

        # A failing task lands FAILED with the user exception's type.
        with pytest.raises(ValueError):
            rt.get(_boom.remote(), timeout=60)
        failed = _wait_for(
            lambda: [t for t in state.list_tasks(fn="_boom")["tasks"]
                     if t["state"] == "FAILED"],
            what="FAILED record",
        )
        assert failed[0]["error_type"] == "ValueError"

        assert rt.get(refs, timeout=60) == [0, 1]
        done = _wait_for(
            lambda: [t for t in state.list_tasks(fn="_sleepy")["tasks"]
                     if t["state"] == "FINISHED"] or None,
            what="FINISHED records",
        )
        assert {t["task_id"] for t in done} == {r.id.task_id().hex() for r in refs}
        summary = state.summary_tasks()["summary"]
        assert summary["_sleepy"]["states"]["FINISHED"] == 2

        # Nodes report object-store occupancy; workers are listed.
        n = state.list_nodes()["nodes"][0]
        assert "capacity" in n["store"] and n["workers"] >= 1

        # Dashboard passthrough: same queries over HTTP with query-string
        # filters (the /api/tasks|summary endpoints).
        import json as _json
        import urllib.request

        from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

        port = start_dashboard(0)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/tasks?fn=_sleepy&state=FINISHED", timeout=10
            ).read()
            payload = _json.loads(body)
            assert payload["total"] == 2 and len(payload["tasks"]) == 2
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/summary", timeout=10
            ).read()
            assert "_sleepy" in _json.loads(body)["summary"]
        finally:
            stop_dashboard()
    finally:
        rt.shutdown()


def test_memory_summary_owner_and_borrower():
    from ray_tpu_torch import state

    rt.init(num_cpus=4)
    try:
        owner = _Owner.remote()
        borrower = _Borrower.remote()
        refs = rt.get(owner.make.remote(512 * 1024), timeout=60)  # shm-sized
        assert rt.get(borrower.take.remote(refs), timeout=60) == 512 * 1024
        oid = refs[0].id.hex()

        def check():
            ms = state.memory_summary()
            owners = [
                (w, o)
                for node in ms["nodes"] for w in node.get("workers", [])
                if "error" not in w for o in w.get("owned", []) if o["oid"] == oid
            ]
            borrows = [
                (w, b)
                for node in ms["nodes"] for w in node.get("workers", [])
                if "error" not in w for b in w.get("borrowed", []) if b["oid"] == oid
            ]
            drv = [b for b in ms["driver"]["borrowed"] if b["oid"] == oid]
            if owners and borrows and drv:
                return ms, owners, borrows, drv
            return None

        ms, owners, borrows, drv = _wait_for(check, what="owner+borrower visibility")
        (owner_w, owned_rec) = owners[0]
        # The object is attributed to its owning worker with both borrowers
        # counted (the borrower actor + the driver's ref).
        assert owned_rec["where"] == "shm" and owned_rec["size"] >= 512 * 1024
        assert owned_rec["borrowers"] == 2
        # ... and the borrower names the owner it borrows from.
        assert borrows[0][1]["owner_addr"] == owner_w["address"]
        assert drv[0]["owner_addr"] == owner_w["address"]
        # Per-node store occupancy rides the same reply.
        assert all("store" in node for node in ms["nodes"])
    finally:
        rt.shutdown()
