"""The port's control-plane fault tolerance (``ray_tpu_torch.core.controller``):
the cases of ``tests/test_controller_ft.py`` on port clusters.

Control-plane fault tolerance: controller crash + restart with snapshot
restore, daemon/driver re-registration, actor reconciliation.
Reference analogue: python/ray/tests/test_gcs_fault_tolerance.py (GCS restart
with Redis persistence; detached actors survive, clients reconnect)."""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.api import Cluster, init, shutdown
from ray_tpu_torch.core.config import Config
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture
def ft_cluster(tmp_path):
    cfg = Config().apply_env()
    cfg.controller_reconcile_grace_s = 3.0
    cluster = Cluster(initialize_head=False, config=cfg, persist_path=str(tmp_path / "controller.snap"))
    cluster.add_node(num_cpus=4)
    init(address=cluster.address, config=cfg)
    yield cluster
    shutdown()
    cluster.shutdown()


def test_state_survives_controller_restart(ft_cluster):
    cluster = ft_cluster

    @rt.remote
    class Counter:
        def __init__(self):
            self.v = 0

        def inc(self):
            self.v += 1
            return self.v

    c = Counter.options(name="survivor", lifetime="detached").remote()
    assert rt.get(c.inc.remote(), timeout=60) == 1
    assert rt.get(c.inc.remote(), timeout=60) == 2

    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core.controller.call("kv_put", {"ns": "ft", "key": "k", "value": b"v1"}))
    time.sleep(0.6)  # let the snapshot loop persist

    cluster.restart_controller()
    time.sleep(1.5)  # daemons re-register over their persistent connections

    # KV survived.
    assert core._run(core.controller.call("kv_get", {"ns": "ft", "key": "k"})) == b"v1"
    # Named actor survived: same process, state intact, calls still work.
    c2 = rt.get_actor("survivor")
    assert rt.get(c2.inc.remote(), timeout=60) == 3
    # The ORIGINAL handle keeps working too (direct peer connection).
    assert rt.get(c.inc.remote(), timeout=60) == 4
    # PG reservation survived.
    info = core._run(core.controller.call("get_placement_group", {"pg_id": pg.id}))
    assert info is not None and info["state"] == "CREATED"
    # New tasks schedule on the restored control plane.

    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(2, 3), timeout=60) == 5
    rt.remove_placement_group(pg)


def test_actor_lost_during_outage_is_restarted(ft_cluster):
    cluster = ft_cluster
    victim = cluster.add_node(num_cpus=2, resources={"special": 1.0})

    @rt.remote(resources={"special": 1.0}, max_restarts=2)
    class Phoenix:
        def pid(self):
            import os

            return os.getpid()

    p = Phoenix.options(name="phoenix", lifetime="detached").remote()
    pid1 = rt.get(p.pid.remote(), timeout=60)
    time.sleep(0.6)  # snapshot
    # Crash the controller AND kill the actor's node while it is down.
    port = int(cluster.controller_addr.rsplit(":", 1)[1])
    cluster.host.call(cluster.controller.stop())
    cluster.remove_node(victim)
    from ray_tpu_torch.core.controller import Controller

    cluster.controller = Controller(cluster.config, persist_path=cluster.controller.persist_path)
    cluster.host.call(cluster.controller.start(port))
    # A replacement feasible node joins AFTER the restart; once the reconcile
    # grace expires the unconfirmed actor is restarted there.
    cluster.add_node(num_cpus=2, resources={"special": 1.0})
    deadline = time.time() + 40
    pid2 = None
    while time.time() < deadline:
        try:
            pid2 = rt.get(rt.get_actor("phoenix").pid.remote(), timeout=10)
            if pid2 != pid1:
                break
        except Exception:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1
