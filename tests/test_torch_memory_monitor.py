"""The port's OOM worker-killing policy: the cases of
``tests/test_memory_monitor.py``.

OOM worker-killing policy (reference: raylet memory monitor +
worker_killing_policy: retriable-first/newest-first victim selection)."""
import time
from dataclasses import dataclass, field

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.memory_monitor import (
    MemoryMonitor,
    pick_oom_victim,
    system_memory_usage,
)
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@dataclass
class FakeWorker:
    worker_id: str
    state: str
    state_ts: float
    proc: object = None
    actor_ids: list = field(default_factory=list)


def test_system_memory_usage_sane():
    u = system_memory_usage()
    assert 0.0 < u < 1.0


def test_victim_order_idle_first():
    ws = [
        FakeWorker("task-old", "LEASED", 1.0),
        FakeWorker("idle", "IDLE", 0.5),
        FakeWorker("actor", "ACTOR", 2.0),
    ]
    assert pick_oom_victim(ws).worker_id == "idle"


def test_victim_order_newest_leased_then_actor():
    ws = [
        FakeWorker("task-old", "LEASED", 1.0),
        FakeWorker("task-new", "LEASED", 3.0),
        FakeWorker("actor", "ACTOR", 5.0),
    ]
    assert pick_oom_victim(ws).worker_id == "task-new"
    ws = [FakeWorker("a-old", "ACTOR", 1.0), FakeWorker("a-new", "ACTOR", 2.0)]
    assert pick_oom_victim(ws).worker_id == "a-new"
    assert pick_oom_victim([FakeWorker("d", "DEAD", 1.0)]) is None


def test_monitor_kills_only_over_threshold():
    killed = []
    usage = {"v": 0.5}
    mon = MemoryMonitor(
        threshold=0.9,
        interval_s=1.0,
        get_workers=lambda: [FakeWorker("w1", "IDLE", 1.0)],
        kill=lambda w, reason: killed.append((w.worker_id, reason)),
        usage_fn=lambda: usage["v"],
    )
    assert mon.poll_once() is None and not killed
    usage["v"] = 0.95
    assert mon.poll_once().worker_id == "w1"
    assert killed and "OOM" in killed[0][1]
    assert mon.kills == 1


def test_oom_killed_task_is_retried():
    """Kill the worker mid-task via a forced monitor poll: the task must
    retry on a fresh worker and still complete (reference behavior: OOM
    kills surface as worker death -> retriable tasks resubmit)."""
    cluster = rt.Cluster(head_node_args={"num_cpus": 2})
    rt.init_cluster(cluster)
    try:
        @rt.remote(max_retries=2)
        def slow():
            time.sleep(1.5)
            return "done"

        ref = slow.remote()
        daemon = cluster.daemons[0]
        deadline = time.time() + 30
        while time.time() < deadline:
            leased = [w for w in daemon.workers.values() if w.state == "LEASED"]
            if leased:
                break
            time.sleep(0.05)
        assert leased, "task worker never leased"
        mon = daemon._memory_monitor
        mon.usage_fn = lambda: 0.99
        victim = cluster.host.call(_poll_async(mon))
        assert victim is not None
        mon.usage_fn = lambda: 0.0
        assert rt.get(ref, timeout=120) == "done"
        assert mon.kills == 1
    finally:
        rt.shutdown()
        # rt.shutdown() only detaches the driver; the Cluster (service
        # thread, daemons, minted token) must be stopped explicitly or it
        # leaks into every later test module.
        cluster.shutdown()


async def _poll_async_inner(mon):
    return mon.poll_once()


def _poll_async(mon):
    return _poll_async_inner(mon)
