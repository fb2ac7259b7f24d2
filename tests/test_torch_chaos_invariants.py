"""The port's post-scenario invariant battery (``ray_tpu_torch.chaos.
invariants``, the reference's ``chaos/invariants.py``) on a port cluster: a
quiet cluster passes every check; a battery that fails says so and dumps
nothing itself; the scenario runner whose battery fails dumps the driver's
flight ring under the ``chaos.invariant`` trigger, and the dump loads."""
import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch import chaos
from ray_tpu_torch.chaos import invariants, scenarios
from ray_tpu_torch.core import api
from ray_tpu_torch.obs import flight


def test_battery_passes_quiet_and_dumps_when_it_fails(fresh_cluster):
    cluster = fresh_cluster
    cluster.add_node(num_cpus=2)
    rt.init(address=cluster.address)
    try:
        chaos.uninstall()

        @rt.remote
        def sq(x):
            return x * x

        assert rt.get([sq.remote(i) for i in range(4)], timeout=60) == [0, 1, 4, 9]
        core = api._require_worker()
        quiet = invariants.check_all(core, cluster, min_injections=0)
        assert quiet["ok"], quiet
        assert {"no_stuck_tasks", "transfer_plane_quiesced", "stores_consistent",
                "injections_recorded"} <= set(quiet)
        assert "faults_visible_in_metrics" not in quiet  # min 0: not asked
        assert "flight_dump" not in quiet

        # No schedule ran here, so a battery that expects one injection more
        # than this process has logged (earlier tests in the same process
        # may have logged some) fails, the green-by-vacuity guard.
        failed = invariants.check_all(core, cluster, min_injections=len(chaos.injection_log()) + 1,
                                      min_metric_injections=0)
        assert not failed["ok"] and not failed["injections_recorded"]["ok"]
        assert "flight_dump" not in failed
    finally:
        rt.shutdown()


def _scn_quiet_but_demanding(seed, quick):
    """A scenario that runs one task on a quiet cluster and asks its
    battery for an injection that never happened."""
    from ray_tpu_torch.core.api import Cluster, init

    cfg = scenarios._fresh_config()
    cluster = scenarios._register_cluster(Cluster(initialize_head=False, config=cfg))
    cluster.add_node(num_cpus=1)
    init(address=cluster.address, config=cfg)

    @rt.remote
    def one():
        return 1

    assert rt.get(one.remote(), timeout=60) == 1
    return {"cluster": cluster, "details": {}, "min_injections": 1, "min_metric_injections": 0}


def test_scenario_runner_dumps_when_its_battery_fails(monkeypatch):
    chaos.install(chaos.FaultSchedule([], seed=0))  # an empty log: the battery fails
    monkeypatch.setitem(scenarios.SCENARIOS, "quiet_but_demanding", _scn_quiet_but_demanding)
    report = scenarios.run_scenario("quiet_but_demanding", seed=0)
    assert not report["ok"] and not report["invariants"]["injections_recorded"]["ok"], report
    header, _events = flight.load_dump(report["flight_dump"])
    assert header["trigger"] == "chaos.invariant"
    assert "quiet_but_demanding: invariant battery failed" in header["reason"]
    assert not api.is_initialized() and chaos.active() is None  # the runner tore down
