"""The port's core runtime (``ray_tpu_torch.core``): tasks, actors, objects,
wait, errors — the cases of ``tests/test_core_runtime.py`` on a port cluster,
plus one script run under both packages whose results must agree.

One module-scoped port cluster (4 CPUs; the reference's file uses 8, so
``test_cluster_resources`` asks for 4). The repo's leak sentinel watches only
``ray_tpu``, so the fixture also checks that the port's ``api`` holds no
worker or cluster once the module is done.
"""
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import api as port_api


@pytest.fixture(scope="module")
def port_rt():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def test_simple_task(port_rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2), timeout=30) == 3


def test_task_with_kwargs(port_rt):
    @rt.remote
    def f(a, b=10, c=0):
        return a + b + c

    assert rt.get(f.remote(1, c=5), timeout=30) == 16


def test_chained_dependencies(port_rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    assert rt.get(ref, timeout=30) == 5


def test_parallel_tasks(port_rt):
    @rt.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(8)]
    assert rt.get(refs, timeout=30) == [i * i for i in range(8)]


def test_num_returns(port_rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c], timeout=30) == [1, 2, 3]


def test_task_exception_propagates(port_rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError, match="kaboom"):
        rt.get(boom.remote(), timeout=30)


def test_nested_tasks(port_rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=30) + 1

    assert rt.get(outer.remote(10), timeout=60) == 21


def test_put_get_small(port_rt):
    ref = rt.put({"a": [1, 2, 3]})
    assert rt.get(ref, timeout=10) == {"a": [1, 2, 3]}


def test_put_get_large_zero_copy(port_rt):
    arr = np.random.rand(500_000)  # 4MB -> shared memory path
    ref = rt.put(arr)
    out = rt.get(ref, timeout=10)
    assert np.array_equal(arr, out)


def test_large_arg_to_task(port_rt):
    arr = np.ones(300_000)

    @rt.remote
    def total(a):
        return float(a.sum())

    assert rt.get(total.remote(rt.put(arr)), timeout=30) == 300_000.0


def test_ref_inside_container(port_rt):
    inner_ref = rt.put(41)

    @rt.remote
    def deref(d):
        return rt.get(d["ref"], timeout=10) + 1

    assert rt.get(deref.remote({"ref": inner_ref}), timeout=30) == 42


def test_wait(port_rt):
    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    fast = slow.remote(0.05)
    slow_ref = slow.remote(5.0)
    ready, not_ready = rt.wait([fast, slow_ref], num_returns=1, timeout=10)
    assert ready == [fast] and not_ready == [slow_ref]


def test_wait_timeout(port_rt):
    @rt.remote
    def slow():
        time.sleep(10)

    ready, not_ready = rt.wait([slow.remote()], num_returns=1, timeout=0.2)
    assert not ready and len(not_ready) == 1


def test_actor_basics(port_rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def incr(self, by=1):
            self.v += by
            return self.v

    c = Counter.remote(5)
    assert rt.get(c.incr.remote(), timeout=30) == 6
    assert rt.get(c.incr.remote(4), timeout=10) == 10


def test_actor_ordering(port_rt):
    @rt.remote
    class Acc:
        def __init__(self):
            self.log = []

        def add(self, i):
            self.log.append(i)
            return list(self.log)

    a = Acc.remote()
    refs = [a.add.remote(i) for i in range(10)]
    final = rt.get(refs[-1], timeout=30)
    assert final == list(range(10))


def test_async_actor(port_rt):
    @rt.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncActor.options(max_concurrency=4).remote()
    refs = [a.work.remote(i) for i in range(4)]
    assert rt.get(refs, timeout=30) == [0, 2, 4, 6]


def test_named_actor(port_rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    s = Store.options(name="kvstore").remote()
    rt.get(s.set.remote("x", 1), timeout=30)
    h = rt.get_actor("kvstore")
    assert rt.get(h.get.remote("x"), timeout=10) == 1
    names = rt.list_named_actors()
    assert any(n["name"] == "kvstore" for n in names)


def test_actor_exception(port_rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor oops")

    b = Bad.remote()
    with pytest.raises(RuntimeError, match="actor oops"):
        rt.get(b.fail.remote(), timeout=30)


def test_kill_actor(port_rt):
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert rt.get(v.ping.remote(), timeout=30) == "pong"
    rt.kill(v)
    time.sleep(0.2)
    with pytest.raises(Exception):
        rt.get(v.ping.remote(), timeout=5)


def test_actor_handle_passing(port_rt):
    @rt.remote
    class Counter2:
        def __init__(self):
            self.v = 0

        def incr(self):
            self.v += 1
            return self.v

    @rt.remote
    def bump(handle):
        return rt.get(handle.incr.remote(), timeout=10)

    c = Counter2.remote()
    assert rt.get(bump.remote(c), timeout=60) == 1
    assert rt.get(c.incr.remote(), timeout=10) == 2


def test_cluster_resources(port_rt):
    total = rt.cluster_resources()
    assert total.get("CPU", 0) >= 4


def test_runtime_context(port_rt):
    @rt.remote
    def whoami():
        ctx = rt.get_runtime_context()
        return (ctx.node_id, ctx.worker_id)

    node_id, worker_id = rt.get(whoami.remote(), timeout=30)
    assert node_id and worker_id


def _parity_script(pkg):
    """One fixed run of the core surface; returns plain values to compare."""
    out = {}

    @pkg.remote
    def f(a, b=10, c=0):
        return a + b + c

    out["kwargs"] = pkg.get(f.remote(1, c=5), timeout=60)

    @pkg.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    out["chain"] = pkg.get(ref, timeout=60)

    @pkg.remote(num_returns=3)
    def three():
        return "a", 2, [3.0]

    out["num_returns"] = pkg.get(list(three.remote()), timeout=60)

    @pkg.remote
    def boom(x):
        raise KeyError(f"missing {x}")

    try:
        pkg.get(boom.remote(7), timeout=60)
    except Exception as e:  # the cause is re-raised at the caller
        out["error"] = (type(e).__name__, str(e))

    @pkg.remote
    class Acc:
        def __init__(self, start):
            self.log = [start]

        def add(self, i):
            self.log.append(i)
            return list(self.log)

    a = Acc.remote(-1)
    refs = [a.add.remote(i) for i in range(6)]
    out["actor"] = pkg.get(refs, timeout=60)

    @pkg.remote
    def slow(t):
        time.sleep(t)
        return t

    fast, late = slow.remote(0.0), slow.remote(5.0)
    ready, not_ready = pkg.wait([fast, late], num_returns=1, timeout=30)
    out["wait"] = (ready == [fast], not_ready == [late], pkg.get(ready[0], timeout=10))

    arr = np.arange(300_000, dtype=np.float64) * 0.5  # 2.4 MB: over the inline limit
    got = pkg.get(pkg.put(arr), timeout=60)
    out["put"] = (got.dtype.str, got.shape, got.tobytes() == arr.tobytes())

    @pkg.remote
    def total(x):
        return float(x.sum())

    out["put_to_task"] = pkg.get(total.remote(pkg.put(arr)), timeout=60)
    return out


def test_parity_with_ray_tpu(port_rt):
    import ray_tpu

    ray_tpu.init(num_cpus=2)
    try:
        want = _parity_script(ray_tpu)
    finally:
        ray_tpu.shutdown()
    got = _parity_script(rt)
    assert got == want
    assert got["error"][0] == "KeyError" and "missing 7" in got["error"][1]


def test_placement_group_and_gpu_resource(port_rt):
    """A placement group reserves a bundle on the port's node; a task placed
    in it runs there; a num_gpus demand counts against the ``GPU``
    resource, which this CPU-only session does not advertise: the task is
    refused as infeasible."""
    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    @rt.remote
    def where():
        return rt.get_runtime_context().node_id

    node = rt.get(where.options(placement_group=pg, placement_group_bundle_index=0).remote(),
                  timeout=60)
    assert node in pg.bundle_nodes()
    rt.remove_placement_group(pg)
    assert "GPU" not in rt.cluster_resources()

    @rt.remote(num_gpus=1)
    def needs_gpu():
        return 1

    with pytest.raises(RuntimeError, match="infeasible.*GPU"):  # never run on a CPU instead
        rt.get(needs_gpu.remote(), timeout=30)


def _ported_dag(_capsys):
    from ray_tpu_torch.dag import DAGNode, InputNode

    @rt.remote
    class A:
        def m(self, x):
            return x + 1

    a = A.remote()
    with InputNode() as inp:
        node = a.m.bind(inp)
    assert isinstance(node, DAGNode)
    dag = node.experimental_compile()
    try:
        assert dag.execute(1).result(timeout=60) == 2
    finally:
        dag.teardown()
        rt.kill(a)


def _ported_device_trace(_capsys):
    from ray_tpu_torch.obs import profiler
    from ray_tpu_torch.util import tracing

    # This host has no CUDA device: the capture refuses at entry, typed.
    with pytest.raises(profiler.DeviceProfilerUnavailable, match="device_capture"):
        with tracing.profile_tpu("unused"):
            pass


def _ported_chaos_cli(capsys):
    import argparse

    from ray_tpu_torch import chaos
    from ray_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario

    assert chaos.cmd_chaos(argparse.Namespace(chaos_cmd="list")) == 0
    listed = capsys.readouterr().out
    assert all(f"  {name} " in listed for name in SCENARIOS) and "tpu.preempt" in listed
    # A scenario builds its own in-process cluster: inside this session it
    # refuses, typed, before touching anything.
    with pytest.raises(RuntimeError, match="fresh process-level session"):
        run_scenario("worker_kill", seed=0, quick=True)


def _ported_lint_cli(capsys):
    import os

    from ray_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["lint", "--no-cache", os.path.join(os.path.dirname(rt.__file__), "analysis")])
    assert exc.value.code == 0
    assert "graftlint: 0 findings" in capsys.readouterr().out


@pytest.mark.parametrize("call", [_ported_dag, _ported_device_trace, _ported_chaos_cli, _ported_lint_cli],
                         ids=["dag", "device_trace", "chaos_cli", "lint_cli"])
def test_formerly_deferred_parts_now_run(port_rt, call, capsys):
    """What used to raise NotImplementedError here is ported: ``bind``
    builds a DAG node that compiles and executes, the device trace goes
    through torch.profiler (on a host without a GPU, its typed refusal, as
    the reference's on a host without a device backend), ``chaos list``
    names every scenario and fault site, and ``lint`` runs the port's own
    analyzer."""
    call(capsys)


def test_get_reraises_a_typed_deadline_at_once(port_rt):
    """A task that raises qos.DeadlineExceeded (a TimeoutError subclass):
    rt.get raises that error, typed, as soon as the task fails, and not a
    GetTimeoutError after the wait (the port repairs CoreWorker._run, which
    took every TimeoutError for its own wait running out)."""
    from ray_tpu_torch import qos

    @rt.remote
    def expired():
        raise qos.DeadlineExceeded("expired in task")

    t0 = time.time()
    with pytest.raises(qos.DeadlineExceeded, match="expired in task") as err:
        rt.get(expired.remote(), timeout=30)
    assert not isinstance(err.value, rt.GetTimeoutError)
    assert time.time() - t0 < 15


def test_get_timeout_still_raises_get_timeout_error(port_rt):
    """A wait that really runs past its timeout is still the caller's
    GetTimeoutError."""
    @rt.remote
    def slow():
        time.sleep(3)
        return 1

    ref = slow.remote()
    t0 = time.time()
    with pytest.raises(rt.GetTimeoutError, match="timed out after 0.5s"):
        rt.get(ref, timeout=0.5)
    assert time.time() - t0 < 2.5
    assert rt.get(ref, timeout=30) == 1


_PROFILER_PROBE = """
import ray_tpu_torch as rt
from ray_tpu_torch.obs import profiler
rt.init(num_cpus=1)
armed = profiler.armed()
rt.shutdown()
print(armed, profiler.armed())
"""


def test_shutdown_disarms_the_profiler():
    """A session arms this process's sampler; shutdown stops it (a sampler
    left walking the driver's frames raises a later GPU workload's peak
    memory)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, RAYTPU_PROFILE_HZ="19")
    out = subprocess.run([sys.executable, "-c", _PROFILER_PROBE], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["True", "False"]
