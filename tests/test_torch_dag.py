"""The port's compiled DAGs (``ray_tpu_torch.dag``): the cases of
``tests/test_dag.py`` on a port cluster, torch tensors on the inline and
shared-memory edges, one script run under both packages whose results must
agree, and one ``cuda`` case: a CUDA tensor through two stages into K1.

Compiled actor-method DAGs with direct channels.
Reference analogue: python/ray/dag/tests/experimental/test_accelerated_dag.py
(compile, execute, pipelining, error propagation, teardown)."""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module")
def dag_actors(shared_ray):
    @rt.remote
    class Doubler:
        def apply(self, x):
            return x * 2

    @rt.remote
    class Adder:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x + self.k

        def add2(self, a, b):
            return a + b

        def boom(self, x):
            raise ValueError("stage exploded")

    d = Doubler.remote()
    a = Adder.remote(10)
    rt.get([d.apply.remote(0), a.apply.remote(0)], timeout=60)  # warm
    return d, a


def test_linear_chain(dag_actors):
    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    dag = out.experimental_compile()
    try:
        assert dag.execute(5).result(timeout=60) == 20  # 5*2 + 10
        assert dag.execute(0).result(timeout=60) == 10
    finally:
        dag.teardown()


def test_fan_in_join(dag_actors):
    d, a = dag_actors
    with InputNode() as inp:
        left = d.apply.bind(inp)    # x*2
        right = a.apply.bind(inp)   # x+10
        out = a.add2.bind(left, right)
    dag = out.experimental_compile()
    try:
        assert dag.execute(3).result(timeout=60) == 3 * 2 + 3 + 10
    finally:
        dag.teardown()


def test_pipelined_executions(dag_actors):
    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    dag = out.experimental_compile(max_in_flight=8)
    try:
        refs = [dag.execute(i) for i in range(20)]
        assert [r.result(timeout=120) for r in refs] == [i * 2 + 10 for i in range(20)]
    finally:
        dag.teardown()


def test_error_propagates_to_driver(dag_actors):
    d, a = dag_actors
    with InputNode() as inp:
        out = d.apply.bind(a.boom.bind(inp))
    dag = out.experimental_compile()
    try:
        with pytest.raises(ValueError, match="stage exploded"):
            dag.execute(1).result(timeout=60)
        # The DAG stays usable for later sequences after an error.
        with InputNode() as inp2:
            ok = d.apply.bind(inp2)
        dag2 = ok.experimental_compile()
        try:
            assert dag2.execute(4).result(timeout=60) == 8
        finally:
            dag2.teardown()
    finally:
        dag.teardown()


def test_faster_than_driver_round_trips(dag_actors):
    """The compiled path must beat chained .remote()+get through the driver
    (that's its reason to exist)."""
    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    dag = out.experimental_compile(max_in_flight=16)
    try:
        N = 50
        t0 = time.perf_counter()
        refs = [dag.execute(i) for i in range(N)]
        compiled = [r.result(timeout=120) for r in refs]
        dag_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        classic = [rt.get(a.apply.remote(d.apply.remote(i)), timeout=60) for i in range(N)]
        classic_time = time.perf_counter() - t0
        assert compiled == classic
        assert dag_time < classic_time, (dag_time, classic_time)
    finally:
        dag.teardown()


def test_large_tensor_rides_shm_channel(dag_actors, shared_ray):
    """A multi-MB ndarray between same-node stages moves through the shared
    arena (zero-copy channel; reference: shared_memory_channel.py), and the
    transient channel objects are acked + deleted afterwards."""
    import gc
    import time as _time

    import numpy as np

    from ray_tpu_torch.core import api as _api

    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    compiled = out.experimental_compile()
    try:
        x = np.ones(1 << 20, dtype=np.float64)  # 8MB >> inline cap
        res = compiled.execute(x).result(timeout=120)
        np.testing.assert_array_equal(res, x * 2 + 10)
        res2 = compiled.execute(x * 3).result(timeout=120)
        np.testing.assert_array_equal(res2, x * 6 + 10)
    finally:
        compiled.teardown()
    # Transient edge objects must be reclaimed once consumers acked.
    del res, res2
    gc.collect()
    store = _api._require_worker().store
    deadline = _time.time() + 15
    while _time.time() < deadline:
        leaked = [
            oid for oid, _size in store.list_objects()
            if oid.return_index() == 2**32 - 1  # put-style ids (dag transients + puts)
        ]
        if not leaked:
            break
        _time.sleep(0.3)
    # The driver's own puts may linger (owned refs); what must NOT linger
    # grows unboundedly with executions — allow a small constant.
    assert len(leaked) <= 2, f"dag shm channel leaked {len(leaked)} objects"


def test_shm_channel_path_actually_used(dag_actors, shared_ray):
    """The dag_shm_edges counter must tick for large same-node payloads —
    guards against the zero-copy path silently regressing to socket frames."""
    import time as _time

    import numpy as np

    from ray_tpu_torch.core import api as _api

    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    compiled = out.experimental_compile()
    try:
        x = np.ones(1 << 20, dtype=np.float64)
        compiled.execute(x).result(timeout=120)
    finally:
        compiled.teardown()
    core = _api._require_worker()
    deadline = _time.time() + 20  # metrics ship on a short timer
    total = 0
    while _time.time() < deadline:
        m = core._run(core.controller.call("get_metrics", {}))
        total = sum(
            s.get("value", 0)
            for s in (m if isinstance(m, list) else [])
            if isinstance(s, dict) and s.get("name") == "dag_shm_edges"
        )
        if total >= 1:
            break
        _time.sleep(0.5)
    assert total >= 1, f"shm edge counter never ticked: {m}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbytes", [4096, 8 << 20], ids=["inline", "shm"])
def test_torch_tensor_edges(dag_actors, nbytes, dtype):
    """The torch case of test_linear_chain and test_large_tensor_rides_shm_channel:
    a CPU tensor on an inline edge (4 KiB) and on the shared-memory edge
    (8 MiB), bf16 riding as a uint8 view. The result owns its memory (the
    port restores a tensor by copy, never as a view of the arena), so it
    may be written, and a second execution is unaffected."""
    import torch

    dt = getattr(torch, dtype)
    d, a = dag_actors
    with InputNode() as inp:
        out = a.apply.bind(d.apply.bind(inp))
    compiled = out.experimental_compile()
    try:
        x = (torch.arange(nbytes // dt.itemsize) % 251).to(dt)
        want = x * 2 + 10
        res = compiled.execute(x).result(timeout=120)
        assert res.dtype == dt and torch.equal(res, want)
        res.add_(1)
        assert torch.equal(compiled.execute(x).result(timeout=120), want)
    finally:
        compiled.teardown()


_PARITY_SCRIPT = r"""
import pickle, sys
import numpy as np
import torch
pkg = __import__(sys.argv[1])
dag_mod = __import__(sys.argv[1] + ".dag", fromlist=["InputNode"])

@pkg.remote
class Scale:
    def apply(self, x):
        return x * 3

@pkg.remote
class Shift:
    def apply(self, x):
        return x - 7

@pkg.remote
class Join:
    def apply(self, a, b):
        return (a, b, a + b)

pkg.init(num_cpus=3)
try:
    s, t, j = Scale.remote(), Shift.remote(), Join.remote()
    with dag_mod.InputNode() as inp:
        scaled = s.apply.bind(inp)
        out = j.apply.bind(scaled, t.apply.bind(scaled))
    dag = out.experimental_compile()
    rng = np.random.default_rng(0)
    payloads = [
        rng.standard_normal(1000),                        # numpy, inline
        rng.standard_normal(1 << 19),                     # numpy, 4 MiB
        torch.from_numpy(rng.standard_normal(1000).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).bfloat16(),
    ]
    try:
        results = [dag.execute(p).result(timeout=120) for p in payloads]
    finally:
        dag.teardown()
finally:
    pkg.shutdown()

def plain(v):
    if isinstance(v, torch.Tensor):
        return ("torch", str(v.dtype), v.float().numpy())
    return ("numpy", str(v.dtype), np.asarray(v))

sys.stdout.buffer.write(pickle.dumps([[plain(v) for v in r] for r in results]))
"""


def test_same_dag_script_under_both_packages():
    """One three-stage DAG (scale, shift, join of both: a fan-in) run as a
    script under ``ray_tpu`` and ``ray_tpu_torch`` in subprocesses, on
    numpy arrays and CPU torch tensors, inline and over the shared-memory
    edge: the two packages give equal results, of equal types and dtypes."""
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    repo = Path(__file__).resolve().parents[1]
    out = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        res = subprocess.run([sys.executable, "-c", _PARITY_SCRIPT, pkg], cwd=repo,
                             capture_output=True, timeout=240)
        assert res.returncode == 0, res.stderr.decode()[-4000:]
        out[pkg] = pickle.loads(res.stdout)
    assert len(out["ray_tpu"]) == len(out["ray_tpu_torch"]) == 4
    for ref_r, port_r in zip(out["ray_tpu"], out["ray_tpu_torch"]):
        for (k1, d1, v1), (k2, d2, v2) in zip(ref_r, port_r):
            assert (k1, d1) == (k2, d2)
            np.testing.assert_array_equal(v1, v2)


@pytest.mark.cuda
def test_cuda_tensor_through_two_stages_into_k1(shared_ray):
    """Stage A makes q, k, v on the card from a seed; they cross the edge
    to stage B (D2H, the shared-memory edge, H2D), which runs K1
    (``flash_attention``) and reports its launches. o matches the plain
    version on the same seeded inputs (max |o - ref| <= 2e-2, as the chip
    smoke holds K1)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K1 runs only on the GPU")
    from ray_tpu_torch.ops import _build, attention as att

    try:
        _build._nvcc()
    except _build.KernelBuildError as e:
        pytest.skip(str(e))
    from ray_tpu_torch.core import api as port_api

    if rt.cluster_resources().get("GPU", 0) < 1:
        # init() advertises only what it is given: the module's session has
        # no GPU resource, so a node that advertises the card joins it.
        port_api._LIVE_CLUSTERS[-1].add_node(num_cpus=2, resources={"GPU": 1})

    def make_qkv(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(2, 256, 4, 64, device="cuda", generator=g).bfloat16()
        k = torch.randn(2, 256, 2, 64, device="cuda", generator=g).bfloat16()
        v = torch.randn(2, 256, 2, 64, device="cuda", generator=g).bfloat16()
        return q, k, v

    @rt.remote(num_gpus=0.5)
    class Make:
        def qkv(self, seed):
            return make_qkv(seed)

    @rt.remote(num_gpus=0.5)
    class Attend:
        def run(self, qkv):
            from ray_tpu_torch.ops import attention

            before = attention.LAUNCHES
            o = attention.flash_attention(*qkv, causal=True)
            return o, attention.LAUNCHES - before

    m, a = Make.remote(), Attend.remote()
    with InputNode() as inp:
        out = a.run.bind(m.qkv.bind(inp))
    compiled = out.experimental_compile()
    try:
        o, launches = compiled.execute(7).result(timeout=300)
    finally:
        compiled.teardown()
        rt.kill(m)
        rt.kill(a)
    assert launches == 1 and o.is_cuda
    q, k, v = make_qkv(7)
    ref = att.mha_reference(q.float(), k.float(), v.float(), causal=True)
    assert (o.float() - ref).abs().max().item() <= 2e-2
