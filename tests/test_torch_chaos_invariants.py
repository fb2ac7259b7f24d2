"""The port's post-scenario invariant battery (``ray_tpu_torch.chaos.
invariants``, the reference's ``chaos/invariants.py``) on a port cluster: a
quiet cluster passes every check; a battery that fails dumps the driver's
flight ring under the ``chaos.invariant`` trigger, and the dump loads."""
import os

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch import chaos
from ray_tpu_torch.chaos import invariants
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
        # may have logged some) fails, the green-by-vacuity guard, and
        # leaves a flight dump behind.
        failed = invariants.check_all(core, cluster, min_injections=len(chaos.injection_log()) + 1,
                                      min_metric_injections=0)
        assert not failed["ok"] and not failed["injections_recorded"]["ok"]
        path = failed["flight_dump"]
        assert path and os.path.exists(path)
        header, _events = flight.load_dump(path)
        assert header["trigger"] == "chaos.invariant"
        assert "injections_recorded" in header["reason"]
    finally:
        rt.shutdown()
