"""The port's actor concurrency groups: the cases of
``tests/test_concurrency_groups.py`` on a port cluster.

Actor concurrency groups (reference: ConcurrencyGroupManager +
@ray.method(concurrency_group=...), core_worker/task_execution)."""
import time

import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@rt.remote(concurrency_groups={"io": 2, "compute": 1})
class Grouped:
    def __init__(self):
        self.log = []

    @rt.method(concurrency_group="compute")
    def crunch(self, t):
        time.sleep(t)
        self.log.append("crunch")
        return "crunched"

    @rt.method(concurrency_group="io")
    def probe(self):
        return "alive"

    def default_lane(self):
        return "default"


def test_group_lane_not_blocked_by_default_lane():
    """A long call on the compute lane must not block the io lane: the probe
    returns while crunch is still sleeping."""
    a = Grouped.remote()
    rt.get(a.probe.remote(), timeout=60)  # actor constructed
    slow = a.crunch.remote(3.0)
    t0 = time.perf_counter()
    assert rt.get(a.probe.remote(), timeout=60) == "alive"
    probe_latency = time.perf_counter() - t0
    assert probe_latency < 2.0, f"io-lane probe stuck behind compute: {probe_latency:.2f}s"
    assert rt.get(slow, timeout=60) == "crunched"


def test_per_call_group_override():
    a = Grouped.remote()
    assert rt.get(a.default_lane.options(concurrency_group="io").remote(), timeout=60) == "default"


def test_unknown_group_is_an_error():
    a = Grouped.remote()
    with pytest.raises(Exception, match="unknown concurrency group"):
        rt.get(a.default_lane.options(concurrency_group="nope").remote(), timeout=60)


def test_group_parallelism_capped():
    """The io lane has 2 threads: three 0.8s sleeps take >=1.6s end-to-end,
    while two take ~0.8s wall (capped parallelism, not serialization)."""

    @rt.remote(concurrency_groups={"io": 2})
    class Sleeper:
        @rt.method(concurrency_group="io")
        def nap(self, t):
            time.sleep(t)
            return True

    s = Sleeper.remote()
    rt.get(s.nap.remote(0.01), timeout=60)
    t0 = time.perf_counter()
    assert all(rt.get([s.nap.remote(0.8) for _ in range(2)], timeout=60))
    two = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert all(rt.get([s.nap.remote(0.8) for _ in range(3)], timeout=60))
    three = time.perf_counter() - t0
    assert two < 1.55, f"2 naps should overlap on a 2-thread lane: {two:.2f}s"
    assert three >= 1.5, f"3 naps on a 2-thread lane must take 2 rounds: {three:.2f}s"


def test_chained_actor_calls_do_not_deadlock():
    """a.m2.remote(a.m1.remote()) lands both calls in one pump drain; the
    dep on m1's result must not hold m1's send hostage (review regression)."""

    @rt.remote
    class Chain:
        def m1(self):
            return 5

        def m2(self, x):
            return x + 1

    a = Chain.remote()
    r1 = a.m1.remote()
    r2 = a.m2.remote(r1)
    assert rt.get(r2, timeout=30) == 6


def test_inherited_method_decorator_honored():
    class Base:
        @rt.method(num_returns=2)
        def pair(self):
            return 1, 2

    @rt.remote
    class Child(Base):
        pass

    c = Child.remote()
    r1, r2 = c.pair.remote()
    assert rt.get([r1, r2], timeout=60) == [1, 2]
