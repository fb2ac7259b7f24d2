"""The port's scheduling (``ray_tpu_torch.core``): the cases of
``tests/test_scheduling.py`` on port clusters, except
``test_fake_tpu_slice_resources``, which is not copied: TPU slice labels
(``accel.tpu``) have no counterpart on GPU nodes.

Multi-node scheduling, placement groups, label selectors, fault tolerance.

Reference analogue: python/ray/tests with ray_start_cluster fixtures
(cluster_utils.Cluster, conftest.py:686) — multi-node semantics on one
machine with fake resources.
"""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.task_spec import SchedulingStrategy
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module")
def two_node_ray():
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    n1 = cluster.add_node(num_cpus=2, resources={"gadget": 1.0}, labels={"zone": "a"})
    n2 = cluster.add_node(num_cpus=2, resources={"widget": 1.0}, labels={"zone": "b"})
    init(address=cluster.address)
    yield cluster, n1, n2
    shutdown()
    # shutdown() detaches the DRIVER only — an address-connected session
    # never owns the cluster it dialed. Leaving this cluster running leaked
    # its service thread + minted auth token into every later module; the
    # module-boundary sentinel fails any module that forgets this line.
    cluster.shutdown()


def test_custom_resource_routing(two_node_ray):
    cluster, n1, n2 = two_node_ray

    @rt.remote(resources={"gadget": 1.0})
    def where():
        return rt.get_runtime_context().node_id

    assert rt.get(where.remote(), timeout=60) == n1.node_id

    @rt.remote(resources={"widget": 1.0})
    def where2():
        return rt.get_runtime_context().node_id

    assert rt.get(where2.remote(), timeout=60) == n2.node_id


def test_label_selector_scheduling(two_node_ray):
    cluster, n1, n2 = two_node_ray

    @rt.remote(label_selector={"zone": "b"})
    def where():
        return rt.get_runtime_context().node_id

    assert rt.get(where.remote(), timeout=60) == n2.node_id


def test_node_affinity(two_node_ray):
    cluster, n1, n2 = two_node_ray

    @rt.remote
    def where():
        return rt.get_runtime_context().node_id

    strat = SchedulingStrategy(kind="NODE_AFFINITY", node_id=n1.node_id)
    ref = where.options(scheduling_strategy=strat).remote()
    assert rt.get(ref, timeout=60) == n1.node_id


def test_infeasible_task_raises(two_node_ray):
    @rt.remote(num_cpus=1000)
    def huge():
        return 1

    with pytest.raises(Exception):
        rt.get(huge.remote(), timeout=10)


def test_placement_group_strict_spread(two_node_ray):
    cluster, n1, n2 = two_node_ray
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    nodes = pg.bundle_nodes()
    assert len(set(nodes)) == 2

    @rt.remote
    def where():
        return rt.get_runtime_context().node_id

    ref = where.options(placement_group=pg, placement_group_bundle_index=0).remote()
    assert rt.get(ref, timeout=60) == nodes[0]
    rt.remove_placement_group(pg)


def _settle(expect_cpu):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) >= expect_cpu:
            return
        time.sleep(0.1)


def test_placement_group_pack(two_node_ray):
    _settle(4)  # wait for lingering task leases to be reaped
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=10)
    nodes = pg.bundle_nodes()
    assert len(set(nodes)) == 1  # both fit on one node
    rt.remove_placement_group(pg)


def test_placement_group_pending_until_capacity(two_node_ray):
    cluster, n1, n2 = two_node_ray
    # Demand exceeding the cluster -> PENDING, then satisfied by a new node.
    pg = rt.placement_group([{"CPU": 4}], strategy="PACK")
    assert not pg.ready(timeout=0.5)
    n3 = cluster.add_node(num_cpus=4)
    assert pg.ready(timeout=10)
    rt.remove_placement_group(pg)
    cluster.remove_node(n3)


def test_actor_restart_on_worker_death(two_node_ray):
    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.lives = 1

        def pid(self):
            import os

            return os.getpid()

        def die(self):
            import os

            os._exit(1)

    p = Phoenix.remote()
    pid1 = rt.get(p.pid.remote(), timeout=60)
    try:
        rt.get(p.die.remote(), timeout=10)
    except Exception:
        pass
    # The controller should restart the actor on a fresh worker.
    deadline = time.monotonic() + 30
    pid2 = None
    while time.monotonic() < deadline:
        try:
            pid2 = rt.get(p.pid.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.2)
    assert pid2 is not None and pid2 != pid1


def test_node_death_fails_actor(two_node_ray):
    cluster, n1, n2 = two_node_ray
    n3 = cluster.add_node(num_cpus=1, resources={"special": 1.0})

    @rt.remote(resources={"special": 1.0})
    class Doomed:
        def ping(self):
            return "pong"

    d = Doomed.remote()
    assert rt.get(d.ping.remote(), timeout=60) == "pong"
    cluster.remove_node(n3)
    with pytest.raises(Exception):
        rt.get(d.ping.remote(), timeout=10)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_object_transfer_between_nodes(two_node_ray, payload):
    cluster, n1, n2 = two_node_ray
    import numpy as np

    @rt.remote(resources={"gadget": 1.0})
    def produce():
        if payload == "torch":
            import torch

            return torch.ones(300_000, dtype=torch.float64)  # large -> node 1 shm
        return np.ones(300_000)  # large -> node 1 shm

    @rt.remote(resources={"widget": 1.0})
    def consume(a):
        return float(a.sum())

    # produce on node1, consume on node2 -> chunked pull between daemons
    assert rt.get(consume.remote(produce.remote()), timeout=90) == 300_000.0


def test_kv_store(two_node_ray):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core.controller.call("kv_put", {"ns": "test", "key": "k", "value": b"v"}))
    assert core._run(core.controller.call("kv_get", {"ns": "test", "key": "k"})) == b"v"
    assert core._run(core.controller.call("kv_keys", {"ns": "test", "prefix": "k"})) == ["k"]
