"""The port stands alone: importing ray_tpu_torch (the serving surface
included) brings in neither jax nor any ray_tpu module, its stdlib-only
modules (tokenizer, metrics, tracing, qos, the HTTP types) and its runtime
(core, obs, chaos, accel, serve, scale, dag) bring in no torch, its engine runs
on the GPU unless told otherwise, and a worker process of a port cluster,
a serve replica hosting the engine included, loads neither jax nor any
ray_tpu module, nor does either stage of a compiled DAG, a Data actor
pool's worker, a streaming split's consumer, a train worker (the train,
collective, ckpt and elastic packages imported in the driver too), a Tune
trial or an RL env runner (tune and rl imported in the driver too, without
gymnasium). The parallel package, the ring and Ulysses attentions and the
sharded train program import neither, and neither does a tensor-parallel
serve replica. The operator surface (runtime_env, job, autoscaler, the GCE
GPU provider, dashboard, the start/stop CLI and ``__main__``, the run
ledger and replay) imports neither, and no torch; nor do the analyzer
(every module of ``analysis/``) and the chaos scenario runner."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import ray_tpu_torch.llm.tokenizer, ray_tpu_torch.util.metrics, ray_tpu_torch.util.tracing, ray_tpu_torch.qos
import ray_tpu_torch.serve.proxy
import ray_tpu_torch, ray_tpu_torch.core, ray_tpu_torch.core.api, ray_tpu_torch.core.worker_main
import ray_tpu_torch.core.node, ray_tpu_torch.core.controller, ray_tpu_torch.state
import ray_tpu_torch.obs, ray_tpu_torch.obs.profiler, ray_tpu_torch.chaos, ray_tpu_torch.accel
import ray_tpu_torch.serve, ray_tpu_torch.scale, ray_tpu_torch.serve.controller, ray_tpu_torch.serve.replica
import ray_tpu_torch.serve.protocol
import ray_tpu_torch.dag, ray_tpu_torch.dag.runtime, ray_tpu_torch.chaos.invariants
import ray_tpu_torch.data, ray_tpu_torch.util.dtypes
import ray_tpu_torch.core.runtime_env, ray_tpu_torch.job, ray_tpu_torch.autoscaler, ray_tpu_torch.gcp
import ray_tpu_torch.dashboard, ray_tpu_torch.scripts, ray_tpu_torch.__main__, ray_tpu_torch.obs.ledger
import ray_tpu_torch.replay
assert "torch" not in sys.modules, "a stdlib-only module imported torch"
assert "jax" not in sys.modules, "the runtime imported jax"
leaked = [m for m in sys.modules if m == "ray_tpu" or m.startswith("ray_tpu.")]
assert not leaked, leaked
import ray_tpu_torch, ray_tpu_torch.llm, ray_tpu_torch.ops, ray_tpu_torch.models, ray_tpu_torch.convert
import ray_tpu_torch.llm.deployment, ray_tpu_torch.llm.openai, ray_tpu_torch.llm.batch, ray_tpu_torch.util
import ray_tpu_torch.parallel, ray_tpu_torch.parallel.pipeline, ray_tpu_torch.parallel._shard_map
import ray_tpu_torch.ops.ring_attention, ray_tpu_torch.ops.ulysses, ray_tpu_torch.models.sharded
from ray_tpu_torch.llm import LLMServer, OpenAIServer, Tokenizer, load_tokenizer
assert "jax" not in sys.modules, "jax imported"
leaked = [m for m in sys.modules if m == "ray_tpu" or m.startswith("ray_tpu.")]
assert not leaked, leaked
import torch
from ray_tpu_torch.llm import LLMEngine
from ray_tpu_torch.models import TransformerConfig
cfg = TransformerConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_seq_len=64)
if torch.cuda.is_available():
    print("cuda")
else:
    try:
        LLMEngine(cfg)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
        print("raised")
    else:
        raise AssertionError("LLMEngine(cfg) without a GPU did not raise")
"""


def test_port_imports_no_jax_and_no_ray_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("raised", "cuda")


_WORKER_PROBE = """
import sys
import ray_tpu_torch as rt
rt.init(num_cpus=1)
try:
    @rt.remote
    def modules():
        import sys
        return sorted(sys.modules)

    mods = rt.get(modules.remote(), timeout=120)
    assert "ray_tpu_torch.core.worker_main" in mods or "ray_tpu_torch.core.worker" in mods, mods
    bad = [m for m in mods if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]
    assert not bad, bad
    assert "torch" not in mods, "a worker imported torch at start-up"
    bad = [m for m in sys.modules if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]
    assert not bad, bad
finally:
    rt.shutdown()
print("clean")
"""


_ANALYSIS_PROBE = """
import sys
import ray_tpu_torch.analysis, ray_tpu_torch.analysis.cache, ray_tpu_torch.analysis.cli
import ray_tpu_torch.analysis.engine, ray_tpu_torch.analysis.index, ray_tpu_torch.analysis.rules_async
import ray_tpu_torch.analysis.rules_buffers, ray_tpu_torch.analysis.rules_chaos
import ray_tpu_torch.analysis.rules_fsm, ray_tpu_torch.analysis.rules_security
import ray_tpu_torch.analysis.rules_xfile, ray_tpu_torch.chaos.scenarios
from ray_tpu_torch.analysis import lint_source
r = lint_source("import asyncio\\n\\n\\nasync def f():\\n    asyncio.create_task(g())\\n", "fixture.py")
assert [f.rule for f in r.findings] == ["bg-strong-ref"], r.findings
bad = [m for m in sys.modules if m in ("ray_tpu", "jax", "torch") or m.startswith(("ray_tpu.", "jax.", "torch."))]
assert not bad, bad
print("clean")
"""


def test_analysis_and_scenarios_import_no_jax_no_ray_tpu_and_no_torch():
    """Every module of the port's analyzer (pure ``ast``, with its own fsm
    table read from the port's ``core/task_state.py``) and the chaos
    scenario runner import neither jax, ray_tpu nor torch."""
    out = subprocess.run([sys.executable, "-c", _ANALYSIS_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_worker_loads_no_jax_and_no_ray_tpu():
    """A task on a port cluster reports its worker's sys.modules: the node
    daemon spawns the port's own worker_main, which imports neither jax nor
    torch at start-up (the repo's test harness sets the variable that makes
    ``ray_tpu``'s workers import jax; the port's ignore it)."""
    out = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


_REPLICA_PROBE = """
import sys
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMServer

class Probe(LLMServer):
    def modules(self):
        import sys
        return sorted(sys.modules)

import os
os.environ["RAY_TPU_TORCH_DEVICE_SLOTS"] = "2"  # the workers inherit it: two CPU slots for the TP-2 replica
rt.init(num_cpus=2)
serve.start(proxy=False)
try:
    model = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64,
                 max_seq_len=64)
    engine = {"max_slots": 2, "max_seq": 64, "prefill_buckets": (16,)}
    tp_model = dict(model, n_kv_heads=2)
    tp_engine = dict(engine, tensor_parallel=2)
    for name, args in (("guard", (model, engine)), ("guard_tp", (tp_model, tp_engine))):
        handle = serve.run(serve.deployment(Probe).bind(*args, None, None, None, "cpu"), name=name, http=False)
        assert len(handle.remote({"tokens": [1, 2, 3], "max_tokens": 4}).result(timeout=120)["tokens"]) == 4
        mods = handle.modules.remote().result(timeout=60)
        assert "ray_tpu_torch.serve.replica" in mods and "torch" in mods, mods
        if name == "guard_tp":
            assert "ray_tpu_torch.parallel._shard_map" in mods, mods
        bad = [m for m in mods if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]
        assert not bad, bad
finally:
    serve.shutdown()
    rt.shutdown()
print("clean")
"""


def test_serve_replica_loads_no_jax_and_no_ray_tpu():
    """A serve replica that hosts the engine (an LLMServer on the CPU), and
    one that hosts a tensor-parallel engine over two CPU slots, report their
    processes' sys.modules after serving a request: torch, the port's
    replica (and its parallel package), and nothing of jax or ray_tpu."""
    out = subprocess.run([sys.executable, "-c", _REPLICA_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


_DAG_PROBE = """
import sys
import torch
import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode

@rt.remote
class Stage:
    def apply(self, x):
        return x * 2

    def modules(self):
        import sys
        return sorted(sys.modules)

rt.init(num_cpus=2)
try:
    a, b = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        out = b.apply.bind(a.apply.bind(inp))
    dag = out.experimental_compile()
    try:
        x = torch.arange(1 << 20, dtype=torch.float32)  # 4 MiB: the shared-memory edge
        assert torch.equal(dag.execute(x).result(timeout=120), x * 4)
    finally:
        dag.teardown()
    for mods in rt.get([a.modules.remote(), b.modules.remote()], timeout=60) + [sorted(sys.modules)]:
        assert "ray_tpu_torch.dag.runtime" in mods or "ray_tpu_torch.dag.graph" in mods, mods
        bad = [m for m in mods if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]
        assert not bad, bad
finally:
    rt.shutdown()
print("clean")
"""


def test_dag_stages_load_no_jax_and_no_ray_tpu():
    """A two-stage compiled DAG on a port cluster carries a torch tensor
    over the shared-memory edge; the driver and both stages' processes then
    report their sys.modules: the port's dag, and nothing of jax or
    ray_tpu."""
    out = subprocess.run([sys.executable, "-c", _DAG_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


_DATA_PROBE = """
import sys
import ray_tpu_torch.data as rd
bad = [m for m in sys.modules if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]
assert not bad, bad
import ray_tpu_torch as rt

def _bad():
    import sys
    return [m for m in sys.modules if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]

class Pool:
    def __call__(self, batch):
        import sys
        n = len(batch["id"])
        return {"id": batch["id"], "bad": [",".join(_bad())] * n,
                "pool": ["ray_tpu_torch.data.executor" in sys.modules] * n}

@rt.remote
class Consumer:
    def run(self, it):
        rows = sum(b.num_rows for b in it.iter_blocks())
        return rows, _bad(), "ray_tpu_torch.data.dataset" in sys.modules

rt.init(num_cpus=4)
try:
    rows = rd.range(16, parallelism=4).map_batches(Pool, compute="actors", concurrency=1).take_all()
    assert sorted(r["id"] for r in rows) == list(range(16))
    assert all(r["pool"] for r in rows) and not any(r["bad"] for r in rows), rows
    its = rd.range(16, parallelism=4).streaming_split(2)
    consumers = [Consumer.remote() for _ in its]
    got = rt.get([c.run.remote(it) for c, it in zip(consumers, its)], timeout=120)
    assert sum(n for n, _, _ in got) == 16 and all(not b and d for _, b, d in got), got
    assert not _bad(), _bad()
finally:
    rt.shutdown()
print("clean")
"""


def test_data_pool_and_split_consumer_load_no_jax_and_no_ray_tpu():
    """``import ray_tpu_torch.data`` in the driver, a Data actor pool's worker
    (map_batches with compute="actors") and a streaming_split consumer
    actor load neither jax nor any ray_tpu module."""
    out = subprocess.run([sys.executable, "-c", _DATA_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


_TRAIN_PROBE = """
import sys
import ray_tpu_torch.train, ray_tpu_torch.collective, ray_tpu_torch.ckpt, ray_tpu_torch.elastic
import ray_tpu_torch.train.grad_sync, ray_tpu_torch.elastic.transfer, ray_tpu_torch.collective.ring

def _bad():
    import sys
    return [m for m in sys.modules if m in ("ray_tpu", "jax") or m.startswith(("ray_tpu.", "jax."))]

assert not _bad(), _bad()
import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import DataParallelTrainer, FailureConfig, RunConfig, ScalingConfig

def train_fn():
    import sys
    import numpy as np
    # Every rank's count of bad modules rides the ring (rank 0 reports).
    gs = train.grad_sync(bucket_bytes=1024, average=False)
    out = gs.allreduce({"w": np.ones(8, np.float32),
                        "bad": np.array([len(_bad())], np.int64),
                        "ok": np.array([int("ray_tpu_torch.train.session" in sys.modules
                                            and "ray_tpu_torch.collective.ring" in sys.modules)])})
    train.report({"bad": int(out["bad"][0]), "ok": int(out["ok"][0]),
                  "sum": float(out["w"].sum())})

def gpu_fn():
    train.report({"trained": True})

rt.init(num_cpus=3, resources={"GPU": 1})
try:
    res = DataParallelTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="guard", storage_path=sys.argv[1])).fit()
    assert res.error is None, res.error
    assert res.metrics == {"bad": 0, "ok": 2, "sum": 16.0}, res.metrics
    # A GPU bundle on a process that sees no CUDA device raises; it never
    # trains on the CPU in the card's place.
    res = DataParallelTrainer(
        gpu_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="guard-gpu", storage_path=sys.argv[1],
                             failure_config=FailureConfig(max_failures=0))).fit()
    import torch
    if torch.cuda.is_available():
        assert res.error is None, res.error
    else:
        assert res.error is not None and "sees no CUDA device" in res.error, res.error
        assert not res.metrics_history
    assert not _bad(), _bad()
finally:
    rt.shutdown()
print("clean")
"""


def test_train_workers_load_no_jax_and_no_ray_tpu(tmp_path):
    """``import ray_tpu_torch.train`` (with .collective, .ckpt, .elastic) in
    the driver, and two train workers that sync a gradient over the ring,
    load neither jax nor any ray_tpu module. A worker given a GPU bundle
    that sees no CUDA device fails the run instead of training on the
    CPU."""
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


_TUNE_RL_PROBE = """
import sys
import ray_tpu_torch.tune, ray_tpu_torch.rl, ray_tpu_torch.tune.tuner, ray_tpu_torch.rl.offline

def _bad():
    import sys
    return [m for m in sys.modules if m in ("ray_tpu", "jax", "gymnasium")
            or m.startswith(("ray_tpu.", "jax.", "gymnasium."))]

assert not _bad(), _bad()
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.core.serialization import DeviceUnavailableError
from ray_tpu_torch.rl.module import init_params
from ray_tpu_torch.rl.multi_agent import CueMatchEnv, MultiAgentEnvRunner
from ray_tpu_torch.train import RunConfig

class Runner(MultiAgentEnvRunner):
    def modules(self):
        import sys
        return sorted(sys.modules)

def trainable(config):
    import sys
    tune.report({"bad": ",".join(_bad()), "session": "ray_tpu_torch.train.session" in sys.modules})

def gpu_trainable(config):
    tune.report({"trained": 1})

rt.init(num_cpus=3, resources={"GPU": 1})
try:
    grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([1, 2])},
                      run_config=RunConfig(name="guard", storage_path=sys.argv[1])).fit()
    assert not grid.errors, grid.errors
    assert all(r.metrics["bad"] == "" and r.metrics["session"] for r in grid), [r.metrics for r in grid]
    runner = rt.remote(Runner).remote(lambda: CueMatchEnv(n_agents=2, n_cues=4, ep_len=8), 2, 4,
                                      {"agent_0": "p", "agent_1": "p"}, seed=0)
    rt.get(runner.set_weights.remote({"p": init_params(np.random.default_rng(0), 4, 4, (8,))}), timeout=120)
    assert rt.get(runner.sample.remote(), timeout=120)["steps"] == 4 * 2 * 2
    mods = rt.get(runner.modules.remote(), timeout=60)
    assert "ray_tpu_torch.rl.multi_agent" in mods, mods
    bad = [m for m in mods if m in ("ray_tpu", "jax", "torch") or m.startswith(("ray_tpu.", "jax.", "torch."))]
    assert not bad, bad
    rt.kill(runner)
    # A trial given a GPU share runs only where CUDA is visible.
    grid = tune.Tuner(gpu_trainable, param_space={"x": tune.grid_search([1])},
                      tune_config=tune.TuneConfig(resources_per_trial={"GPU": 0.5}),
                      run_config=RunConfig(name="guard-gpu", storage_path=sys.argv[1])).fit()
    import torch
    if torch.cuda.is_available():
        assert not grid.errors, grid.errors
    else:
        assert len(grid.errors) == 1 and "DeviceUnavailableError" in grid.errors[0], grid.errors
        assert grid[0].metrics_history == []
finally:
    rt.shutdown()
# Every learner runs on the GPU unless told otherwise; with none visible it raises.
import chip_smoke as cs
for name in cs.RL_LEARNERS:
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in cs.rl_learner(name, cs.rl_case(name), None).params.values())
        continue
    try:
        cs.rl_learner(name, cs.rl_case(name), None)
    except DeviceUnavailableError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError(f"{name}'s learner built on the CPU with device=None")
assert not _bad(), _bad()
print("clean")
"""


def test_tune_trials_and_rl_runners_load_no_jax_and_no_ray_tpu(tmp_path):
    """``import ray_tpu_torch.tune`` and ``ray_tpu_torch.rl`` load neither
    jax, gymnasium nor any ray_tpu module; a Tune trial actor and a
    multi-agent env runner (numpy) load neither jax nor ray_tpu, and the
    runner no torch. A trial given {"GPU": 0.5} that sees no CUDA device
    fails with DeviceUnavailableError, and every RL learner asked for no
    device raises it where no GPU is visible."""
    out = subprocess.run([sys.executable, "-c", _TUNE_RL_PROBE, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"
