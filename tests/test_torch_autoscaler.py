"""The port's autoscaler: the 4 cases of ``tests/test_autoscaler.py`` that
need no cloud API, then the GCE GPU provider (``ray_tpu_torch.gcp``) against
its fake Compute Engine API: its lifecycle, the instance body of an A3 and
an N1 node type, and a pending (stocked-out) instance that the autoscaler
does not request again; plus a GPU node type launched for a ``num_gpus``
task on a CPU-only head.

Autoscaler: demand-driven scale-up and idle scale-down on a fake provider
(reference analogue: autoscaler/v2/tests with FakeMultiNodeProvider). Own
module: needs its own cluster session with infeasible_as_pending set."""
import time

import pytest

import ray_tpu_torch as rt


def test_autoscaler_scales_up_and_down():
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.infeasible_as_pending = True
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=1)
    init(address=cluster.address, config=cfg)
    try:
        provider = LocalNodeProvider(cluster)
        autoscaler = Autoscaler(
            [NodeType("cpu4", {"CPU": 4.0}, max_workers=3)], provider, idle_timeout_s=1.0
        )
        # Demand exceeding the 1-CPU head: a pending lease + pending PG.
        @rt.remote(num_cpus=4)
        def heavy():
            return 42

        ref = heavy.remote()
        pg = rt.placement_group([{"CPU": 4}], strategy="PACK")
        time.sleep(0.5)  # demand lands in pending queues
        result = autoscaler.update()
        assert sum(result["launched"].values()) >= 1, result
        assert rt.get(ref, timeout=120) == 42
        assert pg.ready(timeout=30)
        rt.remove_placement_group(pg)
        # Scale-down is three-phase now: arm idle timers -> drain -> terminate.
        time.sleep(3.0)
        autoscaler.update()  # arms idle timers (post-workload idle)
        time.sleep(1.5)
        result = autoscaler.update()  # idle past timeout: drains first
        assert result["draining"], result
        result = autoscaler.update()  # still idle: terminates
        assert result["terminated"], result
    finally:
        shutdown()
        cluster.shutdown()


def test_external_demand_drives_node_launch_and_clears():
    """Scale plane hand-off: demand registered through the core
    controller's external-demand table (the serve controller's
    unplaceable-replica path) makes the NODE autoscaler launch capacity;
    clearing the source stops holding nodes up."""
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    cluster.add_node(num_cpus=1)
    init(address=cluster.address)
    try:
        core = api._require_worker()

        def ctl(method, payload):
            return core._run(core.controller.call(method, payload))

        provider = LocalNodeProvider(cluster)
        autoscaler = Autoscaler(
            [NodeType("cpu4", {"CPU": 4.0}, max_workers=3)], provider,
            idle_timeout_s=3600.0)
        # No external demand: nothing to launch.
        assert autoscaler.update()["launched"] == {}
        # Two unplaceable 3-CPU replicas -> two cpu4 nodes.
        out = ctl("set_external_demand", {
            "source": "serve:app/dep",
            "items": [{"demand": {"CPU": 3.0}}, {"demand": {"CPU": 3.0}}],
        })
        assert out["ok"]
        state = ctl("get_autoscaler_state", {})
        assert sum(1 for p in state["pending"] if p.get("kind") == "external") == 2
        result = autoscaler.update()
        assert result["launched"].get("cpu4") == 2, result
        # Satisfied: the source clears and pending demand drops to zero.
        assert ctl("set_external_demand", {"source": "serve:app/dep", "items": []})["ok"]
        state = ctl("get_autoscaler_state", {})
        assert not any(p.get("kind") == "external" for p in state["pending"])
        assert autoscaler.update()["launched"] == {}
    finally:
        shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_serve_unplaceable_replica_requests_node_capacity():
    """E2E scale-plane hand-off: a serve replica whose footprint fits NO
    live node makes the serve controller register external demand, the
    node autoscaler launches a matching node, and the deployment then
    converges HEALTHY on the new capacity."""
    import threading

    from ray_tpu_torch import serve
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    cluster.add_node(num_cpus=4)  # no SRV resource anywhere
    init(address=cluster.address)
    try:
        @serve.deployment(name="Pinned",
                          ray_actor_options={"resources": {"SRV": 1.0}})
        class Pinned:
            def __call__(self, x="-"):
                return "ok"

        serve.start(proxy=False)
        err: list = []

        def deploy():
            try:
                serve.run(Pinned.bind(), name="pinned", http=False, timeout_s=120)
            except Exception as e:  # noqa: BLE001 — surfaced by the assert below
                err.append(e)

        th = threading.Thread(target=deploy, daemon=True)
        th.start()
        provider = LocalNodeProvider(cluster)
        autoscaler = Autoscaler(
            [NodeType("srv", {"CPU": 2.0, "SRV": 4.0}, max_workers=2)],
            provider, idle_timeout_s=3600.0)
        launched = {}
        deadline = time.time() + 60
        while time.time() < deadline and not launched:
            launched = autoscaler.update()["launched"]
            time.sleep(0.5)
        assert launched.get("srv") == 1, (
            f"unplaceable replica never became node-autoscaler demand: {launched}")
        th.join(timeout=120)
        assert not th.is_alive() and not err, f"app never became healthy: {err}"
        h = serve.get_deployment_handle("Pinned", "pinned")
        assert h.remote("x").result(timeout=30) == "ok"
    finally:
        try:
            serve.shutdown()
        except Exception:
            pass
        shutdown()
        cluster.shutdown()


def test_drain_excludes_node_from_scheduling():
    """A draining node accepts no new work but keeps serving running actors
    (reference: DrainRaylet semantics)."""
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    cluster.add_node(num_cpus=1, resources={"head": 1.0})
    victim = cluster.add_node(num_cpus=2, resources={"spec": 2.0})
    init(address=cluster.address)
    try:
        @rt.remote(num_cpus=1, resources={"spec": 1.0})
        class Pinned:
            def ping(self):
                return "alive"

        a = Pinned.remote()
        assert rt.get(a.ping.remote(), timeout=60) == "alive"

        from ray_tpu_torch.core import api
        core = api._require_worker()
        reply = core._run(core.controller.call("drain_node", {"node_id": victim.node_id}))
        assert reply["ok"] and not reply["idle"]  # actor still holds resources

        # Existing actor keeps serving.
        assert rt.get(a.ping.remote(), timeout=60) == "alive"
        # New demand for that node's resources cannot schedule (drained).
        @rt.remote(num_cpus=1, resources={"spec": 1.0})
        def probe():
            return 1
        ref = probe.remote()
        ready, not_ready = rt.wait([ref], timeout=2.0)
        assert not ready, "task scheduled onto a draining node"
        # Undrain: the task proceeds.
        core._run(core.controller.call("undrain_node", {"node_id": victim.node_id}))
        assert rt.get(ref, timeout=60) == 1
    finally:
        shutdown()
        cluster.shutdown()


def test_gpu_node_type_launched_for_a_gpu_task():
    """A ``num_gpus=1`` task pending on a 0-GPU head makes the autoscaler
    launch one GPU-shaped node (labelled with its card), the task runs
    there, and the node goes through drain to termination once idle."""
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.infeasible_as_pending = True
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=1)
    init(address=cluster.address, config=cfg)
    try:
        provider = LocalNodeProvider(cluster)
        card = {"accelerator_type": "NVIDIA H100 80GB HBM3"}
        autoscaler = Autoscaler(
            [NodeType("h100", {"CPU": 2.0, "GPU": 1.0}, labels=card, max_workers=1)],
            provider, idle_timeout_s=1.0)

        @rt.remote(num_gpus=1)
        def where():
            return rt.get_runtime_context().node_id

        ref = where.remote()
        deadline = time.time() + 30
        launched = {}
        while time.time() < deadline and not launched:
            time.sleep(0.3)
            launched = autoscaler.update()["launched"]
        assert launched == {"h100": 1}
        (pid,) = provider.non_terminated_nodes()
        assert rt.get(ref, timeout=120) == provider.controller_node_id(pid)
        assert autoscaler.update()["launched"] == {}  # max_workers=1, demand met
        # Three-phase scale-down once the lease is returned: arm the idle
        # timer, drain after idle_timeout_s, terminate on the next update.
        deadline = time.time() + 30
        res = {}
        while time.time() < deadline and not res.get("draining"):
            time.sleep(0.5)
            res = autoscaler.update()
        assert res["draining"] == [pid], res
        assert autoscaler.update()["terminated"] == [pid]
        assert provider.non_terminated_nodes() == {}
    finally:
        shutdown()
        cluster.shutdown()


def _h100(gpus=8, max_workers=10):
    from ray_tpu_torch.autoscaler import NodeType

    return NodeType(f"h100x{gpus}", {"CPU": 26.0 * gpus, "GPU": float(gpus)},
                    labels={"accelerator_type": "NVIDIA H100 80GB HBM3"},
                    max_workers=max_workers)


def test_gce_gpu_provider_lifecycle():
    """The GCE GPU provider against the fake instances API: create (A3 body,
    the provider label in the startup metadata), list through
    PROVISIONING/STAGING/RUNNING, map to a controller node, terminate."""
    from ray_tpu_torch.gcp import FakeGCEAPI, GCEGPUNodeProvider, PROVIDER_ID_LABEL

    api = FakeGCEAPI(provision_delay_s=0.2)
    prov = GCEGPUNodeProvider("proj", "us-central1-a", api, startup_script="boot.sh")
    pid1 = prov.create_node(_h100(8))
    pid2 = prov.create_node(_h100(1))
    assert [c for c in api.calls] == [("create_instance", pid1), ("create_instance", pid2)]
    body = api.instances[pid1]
    assert body["machineType"] == "zones/us-central1-a/machineTypes/a3-highgpu-8g"
    assert "guestAccelerators" not in body  # A3 carries its H100s
    assert api.instances[pid2]["machineType"].endswith("/a3-highgpu-1g")
    meta = {m["key"]: m["value"] for m in body["metadata"]["items"]}
    assert meta == {"startup-script": "boot.sh", "raytpu-node-labels": f"{PROVIDER_ID_LABEL}={pid1}"}
    assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    # Pending instances are live: listed from the first call on.
    assert prov.non_terminated_nodes() == {pid1: "h100x8", pid2: "h100x1"}
    assert {r["status"] for r in api.list_instances(prov.zone_path)} <= {"PROVISIONING", "STAGING"}
    time.sleep(0.25)
    assert {r["status"] for r in api.list_instances(prov.zone_path)} == {"RUNNING"}

    nodes = {"n1": {"labels": {PROVIDER_ID_LABEL: pid1}}}
    assert prov.controller_node_id(pid1, nodes) == "n1"
    assert prov.controller_node_id(pid2, nodes) is None  # not yet registered

    prov.terminate_node(pid1)
    prov.terminate_node(pid2)
    assert prov.non_terminated_nodes() == {}
    assert ("delete_instance", pid1) in api.calls and ("delete_instance", pid2) in api.calls


def test_gce_guest_accelerators_where_the_machine_type_needs_them():
    from ray_tpu_torch.autoscaler import NodeType
    from ray_tpu_torch.gcp import FakeGCEAPI, GCEGPUNodeProvider

    api = FakeGCEAPI()
    prov = GCEGPUNodeProvider("proj", "us-central1-a", api)
    t4 = NodeType("t4x2", {"CPU": 8.0, "GPU": 2.0},
                  labels={"accelerator_type": "Tesla T4", "machine_type": "n1-standard-8",
                          "gce_accelerator": "nvidia-tesla-t4"})
    pid = prov.create_node(t4)
    assert api.instances[pid]["guestAccelerators"] == [{
        "acceleratorType": "zones/us-central1-a/acceleratorTypes/nvidia-tesla-t4",
        "acceleratorCount": 2}]
    with pytest.raises(ValueError, match="gce_accelerator"):
        prov.create_node(NodeType("bare", {"GPU": 1.0}, labels={
            "accelerator_type": "x", "machine_type": "n1-standard-4"}))
    with pytest.raises(ValueError, match="accelerator_type"):
        prov.create_node(NodeType("nolabel", {"GPU": 8.0}))
    with pytest.raises(ValueError, match="machine_type"):
        prov.create_node(_h100(3))


def test_gce_pending_instance_not_respawned():
    """A stocked-out instance (parked in PROVISIONING) still counts as
    non-terminated, so it holds its node type's one slot and repeated
    autoscaler updates for the same pending demand request it once (were it
    not listed, every update would create another)."""
    from ray_tpu_torch.autoscaler import Autoscaler
    from ray_tpu_torch.gcp import FakeGCEAPI, GCEGPUNodeProvider

    api = FakeGCEAPI(capacity=0)  # everything parks in PROVISIONING
    prov = GCEGPUNodeProvider("proj", "us-central1-a", api)

    class _Offline(Autoscaler):
        """The cluster's state without a cluster: one GPU task pending, no
        node has registered (the instance never boots)."""

        def _cluster_state(self):
            return {"nodes": {}, "pending_gangs": [],
                    "pending": [{"kind": "task", "demand": {"CPU": 1.0, "GPU": 1.0}}]}

    auto = _Offline([_h100(8, max_workers=1)], prov, idle_timeout_s=0.0)
    assert auto.update()["launched"] == {"h100x8": 1}
    for _ in range(3):
        res = auto.update()
        assert res["launched"] == {} and res["terminated"] == [], res
    (pid,) = prov.non_terminated_nodes()
    assert api.instances[pid]["status"] == "PROVISIONING"
    assert sum(1 for c in api.calls if c[0] == "create_instance") == 1
