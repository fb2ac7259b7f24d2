"""GPU accelerator manager: device detection, labels, device isolation.

Counterpart of ``ray_tpu/accel/tpu.py`` for NVIDIA GPUs (reference:
python/ray/_private/accelerators/nvidia_gpu.py). A node daemon on a GPU host
advertises ``GPU`` (one unit per visible card) and a label with the card's
name, as the TPU manager advertises ``TPU`` and the slice labels. Detection:

- ``CUDA_VISIBLE_DEVICES`` first (an empty value hides every card);
- else the driver's ``/proc/driver/nvidia/gpus/*`` entries;
- else ``nvidia-smi -L`` under a timeout.

It never imports torch: the daemon stays light, and initializing CUDA in a
process that later forks would poison the children.
"""
from __future__ import annotations

import os
import re
import subprocess
from typing import Optional

# Node label keys (reference: ray_constants' accelerator-type label).
GPU_NAME_LABEL = "raytpu.io/gpu-name"
# The host-group labels that a preemption notice is matched on. They keep
# the reference's names and values (``ray_tpu/accel/tpu.py``), so fault
# specs and scenarios that name a slice and a worker carry over.
TPU_SLICE_NAME_LABEL = "raytpu.io/tpu-slice-name"
TPU_WORKER_ID_LABEL = "raytpu.io/tpu-worker-id"

VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
_PROC_GPUS = "/proc/driver/nvidia/gpus"
_SMI_TIMEOUT_S = 5.0


def get_visible_devices() -> Optional[list[str]]:
    raw = os.environ.get(VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    return [c.strip() for c in raw.split(",") if c.strip() != ""]


def set_visible_devices(device_ids: list[int] | list[str], env: dict | None = None):
    """Restrict a worker process to a subset of the host's cards (reference:
    CUDA_VISIBLE_DEVICES isolation, nvidia_gpu.py). The node daemon does not
    call it yet: the reference never wires its chip isolation into the node
    either."""
    target = env if env is not None else os.environ
    target[VISIBLE_DEVICES_ENV] = ",".join(str(c) for c in device_ids)


def _proc_gpu_names() -> list[str]:
    """Model names from the driver's per-card ``information`` files."""
    try:
        entries = sorted(os.listdir(_PROC_GPUS))
    except OSError:
        return []
    names = []
    for e in entries:
        name = "GPU"
        try:
            with open(os.path.join(_PROC_GPUS, e, "information")) as f:
                for line in f:
                    if line.startswith("Model:"):
                        name = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        names.append(name)
    return names


def _smi_gpu_names() -> list[str]:
    """``nvidia-smi -L`` lines: ``GPU 0: NVIDIA H100 80GB HBM3 (UUID: ...)``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=_SMI_TIMEOUT_S
        )
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    names = []
    for line in out.stdout.splitlines():
        m = re.match(r"GPU \d+: (.*?)(?: \(UUID: .*\))?$", line.strip())
        if m:
            names.append(m.group(1))
    return names


def detect_gpu_resources() -> tuple[dict, dict]:
    """Returns (resources, labels) the node daemon should advertise."""
    visible = get_visible_devices()
    if visible is not None:
        if not visible or visible == ["-1"]:
            return {}, {}
        names = _proc_gpu_names() or _smi_gpu_names()
        num = len(visible)
    else:
        names = _proc_gpu_names() or _smi_gpu_names()
        num = len(names)
    if num <= 0:
        return {}, {}
    labels = {GPU_NAME_LABEL: names[0]} if names else {}
    return {"GPU": float(num)}, labels


def preemption_notice(node_id: str, labels: Optional[dict] = None):
    """Consult the chaos plane for an injected host-preemption notice
    (reference: cloud VMs are preempted with a short notice). Called once per
    daemon heartbeat; returns the Fault (its ``delay_s`` is the grace
    window) or None. The chaos site keeps the reference's name,
    ``tpu.preempt``, so fault specs carry over."""
    from ray_tpu_torch import chaos

    labels = labels or {}
    return chaos.maybe_inject(
        "tpu.preempt",
        node=node_id[:12],
        worker_id=labels.get(TPU_WORKER_ID_LABEL, ""),
        slice=labels.get(TPU_SLICE_NAME_LABEL, ""),
    )

