"""GPU detection of the port's node daemon (``ray_tpu_torch/accel/gpu.py``),
the counterpart of ``ray_tpu/accel/tpu.py``'s ``detect_tpu_resources``:
``CUDA_VISIBLE_DEVICES`` first, then the driver's ``/proc`` entries, then
``nvidia-smi -L``. It never imports torch."""
import subprocess
import sys
from pathlib import Path

import pytest

from ray_tpu_torch.accel import gpu

REPO = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
_SMI_NAMES = gpu._smi_gpu_names


@pytest.fixture
def no_driver(monkeypatch):
    monkeypatch.setattr(gpu, "_proc_gpu_names", lambda: [])
    monkeypatch.setattr(gpu, "_smi_gpu_names", lambda: [])


@pytest.mark.parametrize("visible,count", [("0", 1), ("0,1", 2), ("2, 3 ,5", 3)])
def test_visible_devices_set_the_count(monkeypatch, visible, count):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(gpu, "_proc_gpu_names", lambda: [H100] * 8)
    res, labels = gpu.detect_gpu_resources()
    assert res == {"GPU": float(count)}
    assert labels == {gpu.GPU_NAME_LABEL: H100}


@pytest.mark.parametrize("visible", ["", "-1"])
def test_hidden_devices_advertise_nothing(monkeypatch, visible):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(gpu, "_proc_gpu_names", lambda: [H100])
    assert gpu.detect_gpu_resources() == ({}, {})


def test_driver_entries_when_nothing_is_set(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(gpu, "_proc_gpu_names", lambda: [H100, H100])
    assert gpu.detect_gpu_resources() == ({"GPU": 2.0}, {gpu.GPU_NAME_LABEL: H100})


def test_nvidia_smi_fallback_and_no_gpu(monkeypatch, no_driver):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.detect_gpu_resources() == ({}, {})
    out = subprocess.CompletedProcess(
        ["nvidia-smi", "-L"], 0, stdout=f"GPU 0: {H100} (UUID: GPU-1234)\n", stderr="")
    monkeypatch.setattr(gpu, "_smi_gpu_names", _SMI_NAMES)
    monkeypatch.setattr(gpu.subprocess, "run", lambda *a, **k: out)
    assert gpu.detect_gpu_resources() == ({"GPU": 1.0}, {gpu.GPU_NAME_LABEL: H100})


def test_set_visible_devices_writes_the_env():
    env = {}
    gpu.set_visible_devices([1, 3], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "1,3"}


def test_num_gpus_is_a_gpu_demand():
    from ray_tpu_torch.core.task_spec import ActorOptions, TaskOptions

    assert TaskOptions(num_gpus=1).resource_demand() == {"CPU": 1.0, "GPU": 1}
    assert ActorOptions(num_gpus=0.5).resource_demand() == {"GPU": 0.5}


def test_detection_imports_no_torch():
    probe = ("import sys; from ray_tpu_torch.accel import gpu; gpu.detect_gpu_resources(); "
             "assert 'torch' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
