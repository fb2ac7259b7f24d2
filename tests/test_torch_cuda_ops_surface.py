"""The operator surface on the card: a ``num_gpus=1`` task given a
``runtime_env`` (``py_modules`` + ``env_vars``) runs K1 in its worker, and a
submitted job whose entrypoint builds an engine on ``cuda`` runs K1 and K4
in its own process and ends SUCCEEDED.

Runs only where a CUDA device exists (``-m cuda``; on the chip machine run
it with ``--noconftest``, the repo conftest imports jax); elsewhere each
test skips with the reason. ``python3 chip_smoke.py`` phase 6k runs the same
paths at the 250M model's full width.
"""
import json
import os
import sys

import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda

JOB = """
import json, numpy as np, torch
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.ops import attention, paged_attention
eng = LLMEngine(TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=1, d_ff=512,
                                  max_seq_len=256),
                engine_config=EngineConfig(max_slots=4, max_seq=256, kv_layout="paged", page_size=64,
                                           prefill_buckets=(64,)), device="cuda")
out = eng.generate(np.arange(1, 40, dtype=np.int32), max_tokens=8)
print(json.dumps({"tokens": out["tokens"], "k1": attention.LAUNCHES, "k4": paged_attention.LAUNCHES}))
"""


@pytest.fixture(scope="module")
def gpu_cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, resources={"GPU": 1})
    yield rt
    rt.shutdown()


def test_runtime_env_gpu_task_runs_k1(gpu_cluster, tmp_path):
    rt = gpu_cluster
    mods = tmp_path / "mods"
    (mods / "k1probe").mkdir(parents=True)
    (mods / "k1probe" / "__init__.py").write_text(cs.OPS_PROBE_SRC)

    @rt.remote(num_gpus=1, runtime_env={"py_modules": [str(mods)], "env_vars": {"K1_PROBE": "on"}})
    def probe(seed):
        import k1probe

        return k1probe.run(seed, "K1_PROBE")

    out = rt.get(probe.remote(cs.OPS_K1_SEED), timeout=300)
    assert out["env"] == "on" and out["pid"] != os.getpid() and "runtime_envs" in out["module"]
    mod = cs._ops_probe(str(mods / "k1probe" / "__init__.py"))
    held = cs._ops_hold_k1(torch.device("cuda", 0), mod, out, "runtime_env task")
    assert held["launches"] == 1


def test_job_entrypoint_runs_k1_and_k4(gpu_cluster, tmp_path):
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    script = tmp_path / "job.py"
    script.write_text(JOB)
    client = JobSubmissionClient(log_dir=str(tmp_path / "logs"))
    job_id = client.submit_job(f"{sys.executable} {script}")
    status = client.wait_until_finished(job_id, timeout_s=300)
    logs = client.get_job_logs(job_id)
    assert status == JobStatus.SUCCEEDED, logs[-3000:]
    res = json.loads([ln for ln in logs.splitlines() if ln.startswith("{")][-1])
    assert len(res["tokens"]) == 8 and res["k1"] > 0 and res["k4"] > 0, res
