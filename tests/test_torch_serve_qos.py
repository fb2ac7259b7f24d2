"""The port's QoS plane: every case of ``tests/test_qos.py`` on
``ray_tpu_torch.qos`` and the port's serve.

Layers covered:
  * unit — RequestContext wire codec, FairWaitQueue policy (FIFO within a
    tenant, strict class priority, DRR tenant fairness), the AIMD admission
    controller (converges under standing delay, recovers after, never sheds
    the protected class);
  * unit — the replica's deadline gate and cancel event;
  * router — the handle's fair admission queue under concurrent admits (the
    Condition.notify-scrum regression) and deadline expiry while queued;
  * cluster — deadline enforcement at the handle and worker hops (an
    expired request NEVER reaches user code), cancel-on-client-timeout
    actually freeing replica capacity, and the binary-RPC pickle lane
    honoring the client timeout (the proxy.py result(timeout=60) fix).

``test_expired_at_worker_hop_typed_across_the_wire`` pins the port's repair
of ``CoreWorker._run``: a ``DeadlineExceeded`` raised by the remote call
comes out of ``rt.get`` typed, not as a ``GetTimeoutError``.
"""
from __future__ import annotations

import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import qos, serve
from ray_tpu_torch.qos import AdmissionController, FairWaitQueue, Waiter
from ray_tpu_torch.qos.context import to_wire
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.util import metrics as _metrics


def _counter_value(name: str, **tags) -> float:
    return sum(
        rec["value"] for rec in _metrics.snapshot()
        if rec["name"] == name
        and all(rec["tags"].get(k) == v for k, v in tags.items())
    )


# ---------------------------------------------------------------------------
# RequestContext + wire codec
# ---------------------------------------------------------------------------

def test_context_wire_roundtrip_and_nesting():
    assert qos.current() is None
    assert qos.current_wire() is None
    with qos.request_context(priority="batch", tenant="team-a", timeout_s=5) as ctx:
        assert ctx.rank == 1
        wire = qos.current_wire()
        back = qos.from_wire(wire)
        assert (back.priority, back.tenant) == ("batch", "team-a")
        assert 0 < back.remaining() <= 5
        # Nested contexts inherit missing fields and override present ones.
        with qos.request_context(priority="interactive") as inner:
            assert inner.tenant == "team-a" and inner.rank == 0
            assert inner.deadline == ctx.deadline
        assert qos.current().priority == "batch"
    assert qos.current() is None


def test_context_activate_deactivate_and_expiry():
    tok = qos.activate((2, "t9", time.time() - 1.0, "rid9"))
    try:
        ctx = qos.current()
        assert ctx.priority == "best_effort" and ctx.rid == "rid9"
        assert ctx.expired() and ctx.remaining() < 0
    finally:
        qos.deactivate(tok)
    assert qos.current() is None
    with pytest.raises(ValueError):
        qos.request_context(priority="urgent")


def test_raise_expired_counts_and_is_typed():
    before = _counter_value("serve.request.expired_total", hop="unit-test")
    with pytest.raises(qos.DeadlineExceeded):
        qos.raise_expired("unit-test", "fixture")
    assert _counter_value("serve.request.expired_total", hop="unit-test") == before + 1
    # Typed as a TimeoutError subclass: existing timeout handlers keep working.
    assert issubclass(qos.DeadlineExceeded, TimeoutError)


# ---------------------------------------------------------------------------
# FairWaitQueue policy
# ---------------------------------------------------------------------------

def _w(rank=0, tenant="t", deadline=None):
    return Waiter(rank=rank, tenant=tenant, deadline=deadline)


def test_fair_queue_fifo_within_tenant():
    q = FairWaitQueue()
    ws = [_w() for _ in range(10)]
    for w in ws:
        q.push(w)
    assert [q.pop_next() for _ in range(10)] == ws
    assert q.pop_next() is None and q.empty()


def test_fair_queue_strict_class_priority():
    q = FairWaitQueue()
    batch, best, inter = _w(rank=1), _w(rank=2), _w(rank=0)
    q.push(batch)
    q.push(best)
    q.push(inter)  # queued LAST, served FIRST
    assert q.pop_next() is inter
    assert q.pop_next() is batch
    assert q.pop_next() is best


def test_fair_queue_drr_tenant_fairness_under_skew():
    """Two tenants with wildly skewed offered load get ~equal admitted
    throughput within a class (the DRR contract)."""
    q = FairWaitQueue()
    flood = [_w(tenant="flood") for _ in range(30)]
    trickle = [_w(tenant="trickle") for _ in range(5)]
    for w in flood:
        q.push(w)
    for w in trickle:
        q.push(w)
    first10 = [q.pop_next() for _ in range(10)]
    by_tenant = {"flood": 0, "trickle": 0}
    for w in first10:
        by_tenant[w.tenant] += 1
    assert by_tenant == {"flood": 5, "trickle": 5}, by_tenant
    # Once the trickle drains, the flood gets everything.
    rest = [q.pop_next() for _ in range(25)]
    assert all(w.tenant == "flood" for w in rest)
    assert q.empty()


def test_fair_queue_weighted_tenants():
    q = FairWaitQueue(weights={"heavy": 2.0})
    for _ in range(12):
        q.push(_w(tenant="heavy"))
        q.push(_w(tenant="light"))
    first9 = [q.pop_next() for _ in range(9)]
    heavy = sum(1 for w in first9 if w.tenant == "heavy")
    assert heavy == 6, first9  # 2:1 service ratio


def test_fair_queue_lazy_discard():
    q = FairWaitQueue()
    a, b, c = _w(), _w(), _w()
    for w in (a, b, c):
        q.push(w)
    q.discard(b)
    assert len(q) == 2
    assert q.pop_next() is a
    assert q.pop_next() is c
    assert q.pop_next() is None


# ---------------------------------------------------------------------------
# AIMD admission controller
# ---------------------------------------------------------------------------

def test_aimd_converges_under_standing_delay_and_recovers():
    t = [0.0]
    ctl = AdmissionController(target_delay_s=0.1, min_limit=2, max_limit=64,
                              initial_limit=32, interval_s=1.0, now=lambda: t[0])
    # Standing queue: every window's MINIMUM delay exceeds target ->
    # multiplicative decrease all the way to the floor.
    for _ in range(12):
        t[0] += 1.1
        ctl.record_delay(0.5, rank=2)
    assert ctl.limit == 2.0, ctl.snapshot()
    # Load drops: delays below target -> additive recovery.
    for _ in range(10):
        t[0] += 1.1
        ctl.record_delay(0.01, rank=2)
    assert ctl.limit >= 10.0, ctl.snapshot()


def test_aimd_per_class_minima_interactive_cannot_mask_background_queue():
    """With strict priority, interactive delays are ~0 even when best_effort
    has a standing queue — a single global window-min would never decrease.
    The controller keys on the WORST class's window minimum."""
    t = [0.0]
    ctl = AdmissionController(target_delay_s=0.1, min_limit=2, max_limit=64,
                              initial_limit=32, interval_s=1.0, now=lambda: t[0])
    for _ in range(6):
        t[0] += 1.1
        ctl.record_delay(0.0, rank=0)   # interactive: jumped the queue
        ctl.record_delay(0.8, rank=2)   # best_effort: standing queue
    assert ctl.limit < 32.0, ctl.snapshot()


def test_admission_sheds_background_first_protects_interactive():
    ctl = AdmissionController(target_delay_s=0.1, min_limit=2, max_limit=64,
                              initial_limit=2, interval_s=3600.0)
    # best_effort cap = 0.6 * 2 = 1.2 against TOTAL inflight: admits while
    # inflight <= 1, sheds from the 3rd concurrent background request on.
    assert ctl.try_admit(2)[0]
    assert ctl.try_admit(2)[0]
    ok, retry_after = ctl.try_admit(2)
    assert not ok and retry_after >= 0.2
    # batch cap = 0.85 * 2 = 1.7: total inflight is already 2 -> sheds too.
    assert not ctl.try_admit(1)[0]
    # interactive caps against its OWN inflight (1.5 * 2 = 3), so the
    # converged-down limit and the background load cannot shed it.
    assert ctl.try_admit(0)[0]
    assert ctl.try_admit(0)[0]
    assert ctl.try_admit(0)[0]
    assert not ctl.try_admit(0)[0]  # own-class headroom exhausted
    ctl.release(0)
    assert ctl.try_admit(0)[0]


# ---------------------------------------------------------------------------
# router admission (offline _ReplicaSet: no cluster)
# ---------------------------------------------------------------------------

def _offline_rs(max_ongoing=1, replicas=("r1",)):
    from ray_tpu_torch.serve.handle import _ReplicaSet

    rs = _ReplicaSet("qapp", "dep")
    rs._maybe_refresh = lambda: None  # membership is fixed for the test
    rs.replicas = {n: object() for n in replicas}
    rs.max_ongoing = max_ongoing
    return rs


def test_handle_admission_fifo_regression_no_notify_scrum():
    """Same tenant, concurrent admits: grants must follow ENQUEUE order.
    With the old Condition.notify_all scrum, whichever thread the OS woke
    first stole the freed slot — this pins the fair-queue handoff."""
    rs = _offline_rs(max_ongoing=1)
    holder = rs._admit(5.0)  # occupy the only slot
    started, admitted = [], []
    lock = threading.Lock()

    def worker(i):
        name, _ = rs._admit(10.0)
        with lock:
            admitted.append(i)
        rs._release(name)  # hand the slot to the next waiter in order

    threads = []
    for i in range(6):
        t = threading.Thread(target=worker, args=(i,))
        started.append(i)
        t.start()
        threads.append(t)
        time.sleep(0.05)  # deterministic enqueue order
    rs._release(holder[0])  # start the chain
    for t in threads:
        t.join(timeout=10)
    assert all(not t.is_alive() for t in threads)
    assert admitted == started, f"grant order {admitted} != enqueue order {started}"


def test_handle_admission_strict_priority_and_tenant_fairness():
    rs = _offline_rs(max_ongoing=1)
    holder = rs._admit(5.0)
    admitted = []
    lock = threading.Lock()

    def worker(tag, prio, tenant):
        with qos.request_context(priority=prio, tenant=tenant):
            name, _ = rs._admit(10.0)
        with lock:
            admitted.append(tag)
        rs._release(name)

    spec = (
        [("be-flood", "best_effort", "flood")] * 4
        + [("be-trickle", "best_effort", "trickle")] * 2
        + [("inter", "interactive", "u")] * 2
    )
    threads = []
    for tag, prio, tenant in spec:
        t = threading.Thread(target=worker, args=(tag, prio, tenant))
        t.start()
        threads.append(t)
        time.sleep(0.04)
    rs._release(holder[0])
    for t in threads:
        t.join(timeout=10)
    assert all(not t.is_alive() for t in threads)
    # Interactive jumps the whole best_effort queue despite arriving last...
    assert admitted[:2] == ["inter", "inter"], admitted
    # ...and within best_effort the two tenants alternate (DRR), so the
    # trickle tenant is fully served before the flood finishes.
    flood_after_trickle = admitted[2:].index("be-trickle")
    assert flood_after_trickle <= 1, admitted


def test_handle_admission_deadline_expires_while_queued():
    rs = _offline_rs(max_ongoing=1)
    holder = rs._admit(5.0)  # never released: the queue can't drain
    before = _counter_value("serve.request.expired_total", hop="handle")
    t0 = time.time()
    with qos.request_context(timeout_s=0.3):
        with pytest.raises(qos.DeadlineExceeded):
            rs._admit(30.0)
    assert time.time() - t0 < 2.0  # expired at ITS deadline, not the admit timeout
    assert _counter_value("serve.request.expired_total", hop="handle") == before + 1
    # A queue-free slot released later must not resurrect anything.
    rs._release(holder[0])
    assert len(rs._wfq) == 0


def test_handle_admission_plain_timeout_still_timeouterror():
    rs = _offline_rs(max_ongoing=1)
    rs._admit(5.0)
    with pytest.raises(TimeoutError) as err:
        rs._admit(0.2)
    assert not isinstance(err.value, qos.DeadlineExceeded)


def test_cancel_downstream_masks_the_request_context():
    """Regression (found by the overload_storm exact-accounting check): the
    cancel notification fired by an EXPIRED request's teardown inherited
    the dead context — the worker gate dropped the cancel itself with a
    SECOND counted expiry and the replica never saw it. Control-plane sends
    must carry no request context."""
    captured = []

    class FakeMethod:
        def remote(self, rid):
            captured.append(qos.current_wire())

    class FakeReplica:
        cancel_request = FakeMethod()

    rs = _offline_rs()
    rs.replicas = {"r1": FakeReplica()}
    tok = qos.activate((2, "t", time.time() - 5.0, "rid-x"))  # long expired
    try:
        rs._cancel_downstream("r1", "rid-x")
    finally:
        qos.deactivate(tok)
    assert captured == [None], captured


# ---------------------------------------------------------------------------
# replica inbox gate (direct instance: no cluster)
# ---------------------------------------------------------------------------

def test_replica_gate_drops_expired_before_user_code():
    from ray_tpu_torch.serve.replica import Replica

    calls = []
    rep = Replica("a", "d", "r0", lambda x: calls.append(x) or "ran", (), {})
    before = _counter_value("serve.request.expired_total", hop="replica")
    tok = qos.activate((0, "t", time.time() - 0.5, "rid1"))
    try:
        with pytest.raises(qos.DeadlineExceeded):
            rep.handle_request("__call__", (1,), {})
    finally:
        qos.deactivate(tok)
    assert calls == [], "expired request reached user code"
    assert _counter_value("serve.request.expired_total", hop="replica") == before + 1
    assert rep.get_metrics()["ongoing"] == 0  # accounting unwound


def test_replica_cancel_event_and_early_cancel_memory():
    from ray_tpu_torch.serve.replica import Replica

    seen = {}

    def body():
        ev = qos.cancel_event()
        seen["registered"] = ev is not None
        seen["pre_set"] = qos.cancel_requested()
        return "ok"

    rep = Replica("a", "d", "r0", body, (), {})
    # Cancel arriving BEFORE its request: remembered, event pre-set.
    rep.cancel_request("early-rid")
    tok = qos.activate((0, "t", None, "early-rid"))
    try:
        assert rep.handle_request("__call__", (), {}) == "ok"
    finally:
        qos.deactivate(tok)
    assert seen == {"registered": True, "pre_set": True}
    # Unknown rid after the request finished: nothing to cancel.
    assert rep.cancel_request("early-rid") is False


# ---------------------------------------------------------------------------
# cluster: end-to-end hops + cancel + the rpc-lane timeout fix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qos_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


@serve.deployment(max_ongoing_requests=4)
class Probe:
    def __init__(self):
        self._lock = threading.Lock()
        self.invoked = 0
        self.cancelled = 0

    def __call__(self, x="-"):
        with self._lock:
            self.invoked += 1
        return {"ran": x}

    def wait_for_cancel(self):
        with self._lock:
            self.invoked += 1
        deadline = time.time() + 20
        while time.time() < deadline:
            if qos.cancel_requested():
                with self._lock:
                    self.cancelled += 1
                return "cancelled"
            time.sleep(0.02)
        return "completed"

    def expire_inside(self, delay):
        """Outlives its own deadline, then its next hop's gate drops it."""
        time.sleep(delay)
        qos.check_deadline("exec", detail="expire_inside")
        return "late"

    def stats(self):
        with self._lock:
            return {"invoked": self.invoked, "cancelled": self.cancelled}


def test_expired_at_handle_never_reaches_replica(qos_cluster):
    handle = serve.run(Probe.bind(), name="qhop", http=False)
    assert handle.remote("warm").result(timeout=30) == {"ran": "warm"}
    base = handle.stats.remote().result(timeout=30)["invoked"]
    with qos.request_context(deadline=time.time() - 1.0):
        with pytest.raises(qos.DeadlineExceeded):
            handle.remote("dead")
    assert handle.stats.remote().result(timeout=30)["invoked"] == base
    serve.delete("qhop")


def test_expired_at_worker_hop_typed_across_the_wire(qos_cluster):
    """Bypass the handle (direct replica actor call): the EXECUTOR-side
    worker-dispatch gate drops the expired call and the typed error crosses
    the wire (rt.get re-raises the pickled DeadlineExceeded cause)."""
    handle = serve.run(Probe.bind(), name="qworker", http=False)
    assert handle.remote("warm").result(timeout=30) == {"ran": "warm"}
    base = handle.stats.remote().result(timeout=30)["invoked"]
    info = rt.get(
        serve.api._get_controller().get_routing_info.remote("qworker", "Probe"),
        timeout=10,
    )
    replica = rt.get_actor(info["replica_names"][0], namespace="serve")
    with qos.request_context(deadline=time.time() - 1.0):
        ref = replica.handle_request.remote("__call__", ("dead",), {})
    with pytest.raises(qos.DeadlineExceeded):
        rt.get(ref, timeout=30)
    assert handle.stats.remote().result(timeout=30)["invoked"] == base
    serve.delete("qworker")


def test_routing_refresh_masks_the_request_context(qos_cluster):
    """A membership refresh is a control-plane send (qos.suspend's
    contract): with an expired request context active in the caller's
    thread, it still reaches the controller. Carrying the context, the
    controller's worker gate dropped it, so the proxy answered an expired
    request from hop "worker" (get_routing_info) and the refresh backed
    off."""
    from ray_tpu_torch.serve.handle import _replica_set

    handle = serve.run(Probe.bind(), name="qrefresh", http=False)
    assert handle.remote("warm").result(timeout=30) == {"ran": "warm"}
    rs = _replica_set("qrefresh", "Probe")
    with rs.cond:
        rs.fetched_at, rs.version, rs.replicas = 0.0, -1, {}  # due for a refresh
    tok = qos.activate((0, "t", time.time() - 1.0, "rid-refresh"))
    try:
        rs._maybe_refresh()
    finally:
        qos.deactivate(tok)
    with rs.cond:
        assert rs.replicas and rs.version >= 0
    serve.delete("qrefresh")


def test_result_surfaces_a_typed_deadline_without_cancelling(qos_cluster):
    """A request that outlives its deadline inside the replica: the typed
    DeadlineExceeded crosses rt.get, so DeploymentResponse.result raises it
    as is, before the caller's own result timeout, and does not take it for
    the caller giving up (no cancel of downstream work). Before the port's
    CoreWorker._run repair it came out as a GetTimeoutError and cancelled."""
    handle = serve.run(Probe.bind(), name="qtyped", http=False)
    assert handle.remote("warm").result(timeout=30) == {"ran": "warm"}
    with qos.request_context(timeout_s=0.5):
        resp = handle.options(method_name="expire_inside").remote(1.0)
    t0 = time.time()
    with pytest.raises(qos.DeadlineExceeded) as err:
        resp.result(timeout=30)
    assert not isinstance(err.value, rt.GetTimeoutError)
    assert time.time() - t0 < 15
    assert resp._cancelled is False
    assert handle.stats.remote().result(timeout=30)["cancelled"] == 0
    serve.delete("qtyped")


def test_expired_error_is_typed_through_the_streaming_lane(qos_cluster):
    """Regression: a DeadlineExceeded raised on
    the executor used to surface from ObjectRefGenerator as the raw
    RemoteError wrapper — the proxy's typed 504 mapping missed it and
    returned 500. The streaming lane now re-raises the picklable cause,
    same contract as rt.get."""
    handle = serve.run(Probe.bind(), name="qstream", http=False)
    assert handle.remote("warm").result(timeout=30) == {"ran": "warm"}
    info = rt.get(
        serve.api._get_controller().get_routing_info.remote("qstream", "Probe"),
        timeout=10,
    )
    replica = rt.get_actor(info["replica_names"][0], namespace="serve")
    with qos.request_context(deadline=time.time() - 1.0):
        gen = replica.handle_request_proxy.options(num_returns="streaming").remote(
            "__call__", ("dead",), {},
        )
    with pytest.raises(qos.DeadlineExceeded):
        next(gen)
    serve.delete("qstream")


def test_cancel_on_client_timeout_frees_replica_capacity(qos_cluster):
    from ray_tpu_torch.serve.handle import _replica_set

    handle = serve.run(Probe.bind(), name="qcancel", http=False)
    resp = handle.options(method_name="wait_for_cancel").remote()
    with pytest.raises(TimeoutError):
        resp.result(timeout=1.0)
    # The handle's admission slot freed IMMEDIATELY (not after the 20s body).
    rs = _replica_set("qcancel", "Probe")
    with rs.cond:
        assert sum(rs.ongoing.values()) == 0
    # The replica-side body observed the cancel and returned early.
    deadline = time.time() + 10
    st = {}
    while time.time() < deadline:
        st = handle.stats.remote().result(timeout=30)
        if st.get("cancelled") == 1:
            break
        time.sleep(0.1)
    assert st.get("cancelled") == 1, st
    serve.delete("qcancel")


def test_rpc_pickle_lane_honors_client_timeout(qos_cluster):
    """Regression for the proxy's legacy dispatch hardcoding
    result(timeout=60): the pickle lane accepts a trailing timeout_s and
    both lanes share one capped-timeout policy."""
    import pickle
    import socket

    from ray_tpu_torch.serve.proxy import _capped_timeout

    assert _capped_timeout(0.0) == 60.0     # no opinion -> default
    assert _capped_timeout(5.5) == 5.5      # client-controlled
    assert _capped_timeout(10_000) == 600.0  # capped
    assert _capped_timeout(None) == 60.0

    serve.run(Probe.bind(), name="qrpc", http=False)
    serve.start(proxy=True)  # rpc ingress rides the proxy actor
    port = serve.rpc_port()

    def rpc(payload_tuple, deadline_s=30):
        from ray_tpu_torch.core import rpc as _rpc

        blob = pickle.dumps(payload_tuple, protocol=5)
        if _rpc.get_auth_token():
            blob = _rpc.frame_tag(blob) + blob
        with socket.create_connection(("127.0.0.1", port), timeout=deadline_s) as s:
            s.settimeout(deadline_s)
            s.sendall(len(blob).to_bytes(4, "little") + blob)
            n = int.from_bytes(s.recv(4), "little")
            buf = b""
            while len(buf) < n:
                buf += s.recv(n - len(buf))
        if _rpc.get_auth_token():
            buf = buf[_rpc.FRAME_TAG_LEN:]
        return pickle.loads(buf)

    # Legacy 5-tuple still works.
    status, result = rpc(("qrpc", "Probe", "__call__", ("five",), {}))
    assert (status, result) == ("ok", {"ran": "five"})
    # 6-tuple with a client timeout: honored end to end — a blocking method
    # fails in ~the client's budget, not the old hardcoded 60s.
    t0 = time.time()
    status, result = rpc(("qrpc", "Probe", "wait_for_cancel", (), {}, 1.0))
    elapsed = time.time() - t0
    assert status == "err", (status, result)
    assert elapsed < 30, f"client timeout ignored: {elapsed:.1f}s"
    serve.delete("qrpc")


def test_qos_queue_delay_histogram_recorded(qos_cluster):
    handle = serve.run(Probe.bind(), name="qmetrics", http=False)
    with qos.request_context(priority="batch", tenant="m"):
        assert handle.remote("m").result(timeout=30) == {"ran": "m"}
    recs = [
        rec for rec in _metrics.snapshot()
        if rec["name"] == "qos.queue.delay_s"
        and rec["tags"].get("class") == "batch"
        and rec["tags"].get("deployment") == "Probe"
    ]
    assert recs and recs[0]["n"] >= 1
    serve.delete("qmetrics")
