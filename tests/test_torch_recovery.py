"""The port's spilling and lineage reconstruction (``ray_tpu_torch.core``):
the cases of ``tests/test_recovery.py`` on port clusters.

Object spilling and lineage reconstruction.

Reference analogues: python/ray/tests/test_object_spilling*.py (spill under
store pressure, restore on get) and test_reconstruction*.py (lost objects
re-created by re-executing the producing task — task_manager.h:184,
object_recovery_manager.h:41).

The reconstruction tests force object loss with DETERMINISTIC chaos
schedules (seeded nth-hit eviction at the ``node.chunk.serve`` gate) rather
than the original remove-node/add-node dance: under full-suite load the
node-churn version raced worker-spawn and re-registration timing and went
flaky; a chaos-evicted object is lost at an exact,
replayable point with zero cluster churn.
"""
import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import chaos
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import SharedMemoryClient
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture
def chaos_evict():
    """Arm an eviction schedule for named object ids; disarm on exit."""

    def arm(*refs, seed=7):
        chaos.install(chaos.FaultSchedule.from_spec({
            "seed": seed,
            "rules": [
                {"site": "node.chunk.serve", "kind": "evict", "nth": 1,
                 "ctx": {"oid": r.id.hex()[:16]}}
                for r in refs
            ],
        }))

    yield arm
    chaos.uninstall()


# ---------------------------------------------------------------- spilling


def test_store_spill_and_restore(tmp_path):
    s = SharedMemoryClient(
        str(tmp_path / "store"), capacity=4 * 1024 * 1024, create=True, spill_dir=str(tmp_path / "spill")
    )
    blobs = {}
    for _ in range(12):  # 12 * 700KB ≈ 2x capacity
        oid = ObjectID.from_put()
        data = os.urandom(700 * 1024)
        s.put(oid, data)
        blobs[oid] = data
    # Everything is still retrievable: resident or restored from disk.
    for oid, data in blobs.items():
        if not s.contains(oid):
            assert s.is_spilled(oid)
            assert s.restore(oid)
        assert s.get_copy(oid) == data
    s.close()


def test_store_spill_delete_drops_file(tmp_path):
    s = SharedMemoryClient(
        str(tmp_path / "store"), capacity=1024 * 1024, create=True, spill_dir=str(tmp_path / "spill")
    )
    a = ObjectID.from_put()
    s.put(a, os.urandom(700 * 1024))
    s.put(ObjectID.from_put(), os.urandom(700 * 1024))  # pressure -> a spills
    assert s.is_spilled(a)
    s.delete(a, drop_spilled=True)
    assert not s.is_spilled(a)
    assert not s.contains_or_spilled(a)
    s.close()


def test_spill_integration_10x_capacity():
    """Fill the store ~10x over capacity through the public API; every object
    must come back (reference: test_object_spilling.py fill-beyond-capacity)."""
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    cluster.add_node(num_cpus=2, object_store_memory=16 * 1024 * 1024)
    init(address=cluster.address)
    try:
        arrays = [np.full(1_000_000, i, dtype=np.float64) for i in range(20)]  # 20 x 8MB = 160MB
        refs = [rt.put(a) for a in arrays]
        for i, ref in enumerate(refs):
            got = rt.get(ref, timeout=60)
            assert got[0] == float(i) and got.shape == (1_000_000,)
    finally:
        shutdown()
        cluster.shutdown()


# ------------------------------------------------- lineage reconstruction


@pytest.fixture
def recovery_cluster():
    from ray_tpu_torch.core.api import Cluster, init, shutdown

    cluster = Cluster(initialize_head=False)
    head = cluster.add_node(num_cpus=2)
    init(address=cluster.address)
    yield cluster
    shutdown()
    cluster.shutdown()


def _exec_marker_dir(tmp_path):
    d = str(tmp_path / "exec_markers")
    os.makedirs(d, exist_ok=True)
    return d


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_lost_object_reexecuted(recovery_cluster, tmp_path, chaos_evict, payload):
    cluster = recovery_cluster
    marker_dir = _exec_marker_dir(tmp_path)
    cluster.add_node(num_cpus=2, resources={"special": 1.0})

    @rt.remote(resources={"special": 1.0}, max_retries=2)
    def make():
        with open(os.path.join(marker_dir, os.urandom(6).hex()), "w"):
            pass
        if payload == "torch":
            import torch

            return torch.arange(500_000, dtype=torch.float64)  # 4MB -> shm
        return np.arange(500_000, dtype=np.float64)  # 4MB -> shm on the special node

    ref = make.remote()
    ready, _ = rt.wait([ref], timeout=120)  # completes WITHOUT pulling payload to the driver node
    assert ready
    n0 = len(os.listdir(marker_dir))
    assert n0 >= 1  # >=: a retried first attempt is legal, not what we test
    # The ONLY copy is chaos-evicted the instant the driver's pull asks for
    # it (deterministic nth=1 on that oid) — the get must fall through the
    # empty directory to lineage re-execution on the same live node.
    chaos_evict(ref)
    got = rt.get(ref, timeout=120)
    assert type(got).__module__.split(".")[0] == payload
    assert tuple(got.shape) == (500_000,) and float(got[-1]) == 499_999.0
    assert len(os.listdir(marker_dir)) > n0  # really re-executed
    assert [e["site"] for e in chaos.injection_log()] == ["node.chunk.serve"]


def test_lineage_chain_recovers_dependencies(recovery_cluster, tmp_path, chaos_evict):
    cluster = recovery_cluster
    marker_dir = _exec_marker_dir(tmp_path)
    # Producer and consumer on DIFFERENT nodes: the consumer pulls its
    # dependency over the transfer plane, so both the result AND the
    # dependency have a chunk-serve gate their loss can strike through.
    cluster.add_node(num_cpus=2, resources={"specialA": 1.0})
    cluster.add_node(num_cpus=2, resources={"specialB": 1.0})

    @rt.remote(resources={"specialA": 1.0}, max_retries=2)
    def produce():
        with open(os.path.join(marker_dir, "p_" + os.urandom(6).hex()), "w"):
            pass
        return np.ones(400_000, dtype=np.float64)

    @rt.remote(resources={"specialB": 1.0}, max_retries=2)
    def double(a):
        with open(os.path.join(marker_dir, "d_" + os.urandom(6).hex()), "w"):
            pass
        return a * 2.0

    a = produce.remote()
    ready, _ = rt.wait([a], timeout=120)
    assert ready
    p0 = sum(m.startswith("p_") for m in os.listdir(marker_dir))
    # Two deterministic losses, one per lineage level, each armed BEFORE the
    # pull it strikes (no submit-vs-arm race). Level 1: `a` evicts on its
    # FIRST serve — which is double's argument pull — so the borrowing
    # worker must recover its dependency through the owner (produce re-runs)
    # before double's body can start.
    chaos_evict(a)
    b = double.remote(a)
    ready, _ = rt.wait([b], timeout=120)
    assert ready
    markers = os.listdir(marker_dir)
    assert sum(m.startswith("p_") for m in markers) > p0  # dependency recovered
    assert [e["site"] for e in chaos.injection_log()] == ["node.chunk.serve"]
    d1 = sum(m.startswith("d_") for m in markers)
    # Level 2: `b` evicts on ITS first serve — the driver's get — so the
    # owner re-executes double from lineage (arg `a` is resident again).
    chaos_evict(b)
    got = rt.get(b, timeout=120)
    assert got[0] == 2.0
    markers = os.listdir(marker_dir)
    assert sum(m.startswith("d_") for m in markers) > d1  # consumer re-ran
    assert [e["site"] for e in chaos.injection_log()] == ["node.chunk.serve"]


def test_no_recovery_when_retries_disabled(recovery_cluster, tmp_path, chaos_evict):
    cluster = recovery_cluster
    cluster.add_node(num_cpus=2, resources={"special": 1.0})

    @rt.remote(resources={"special": 1.0}, max_retries=0)
    def make():
        return np.zeros(400_000, dtype=np.float64)

    ref = make.remote()
    ready, _ = rt.wait([ref], timeout=120)
    assert ready
    chaos_evict(ref)  # the only copy dies on its next serve, deterministically
    from ray_tpu_torch.core.object_ref import ObjectLostError

    with pytest.raises(ObjectLostError):
        rt.get(ref, timeout=60)
