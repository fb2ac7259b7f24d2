"""The port's streaming fast lane under seeded chaos (the case of
``tests/test_stream_chaos.py`` on a port cluster): a dropped generator batch frame
must surface through the EXISTING retry/failure path, not a silent stall.

Own module (no shared rt.init fixture): the chaos spec must be armed in the
cluster config BEFORE the driver connects so the spawned executor worker
installs it ahead of its first task.
"""
import json
import time

import ray_tpu_torch as rt


def test_dropped_batch_frame_retries_and_dedups():
    """rpc.stream.item kind=drop: the SECOND batch frame of the first
    attempt is lost along with its transport (the shape a real frame loss
    takes — a conn that eats a frame dies), which the caller observes as
    connection loss on the in-flight push. The existing retry path resubmits
    on a fresh worker; the replay re-ships indices from 0 and the owner-side
    reserve() dedups, so the consumer still sees every index exactly once,
    in order."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.chaos_spec = json.dumps({"seed": 7, "rules": [
        # attempt-scoped: only the FIRST attempt's frames count hits, so the
        # replay (a fresh worker process with fresh per-rule counters) ships
        # clean instead of deterministically re-dropping its own 2nd frame.
        {"site": "rpc.stream.item", "kind": "drop", "nth": 2,
         "ctx": {"attempt": "0"}},
    ]})
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=2)
    init(address=cluster.address, config=cfg)
    try:
        @rt.remote(num_returns="streaming")
        def tokens(n):
            for i in range(n):
                time.sleep(0.05)  # paces frames: >= 2 per attempt
                yield i

        got = [rt.get(ref, timeout=120) for ref in tokens.remote(8)]
        assert got == list(range(8)), got
        core = _api._require_worker()
        retried = [e for e in core.task_events
                   if e["kind"] == "task_failed" and e.get("retrying")]
        assert retried, (
            "no retrying task_failed event — the chaos drop never fired and "
            "this test asserted nothing"
        )
    finally:
        shutdown()
        cluster.shutdown()
        # The driver adopted the cluster's chaos spec at register_job; disarm
        # so later test modules in this process run chaos-free.
        from ray_tpu_torch import chaos

        chaos.uninstall()
        assert _api._global_worker is None, "port driver session left initialized"
        assert not _api._LIVE_CLUSTERS, "port cluster left running"
