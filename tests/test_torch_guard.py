"""The port stands alone: importing ray_tpu_torch brings in neither jax nor
any ray_tpu module, and its engine runs on the GPU unless told otherwise."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import ray_tpu_torch, ray_tpu_torch.llm, ray_tpu_torch.ops, ray_tpu_torch.models, ray_tpu_torch.convert
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
