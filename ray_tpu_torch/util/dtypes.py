"""Shared dtype predicates (counterpart of ``ray_tpu/util/dtypes.py``).

The one that matters: ``is_float_dtype``. numpy reports ml_dtypes types
(bfloat16 above all) as kind 'V', so a bare ``dtype.kind == "f"`` check
silently misclassifies them; every such check goes through here. A
``torch.dtype`` is answered too: torch's bf16 is the counterpart of
ml_dtypes' bfloat16 in the reference.
"""
from __future__ import annotations

import sys

import numpy as np


def is_float_dtype(dt) -> bool:
    """True for any floating dtype: numpy's, ml_dtypes' (bfloat16 registers
    with numpy as kind 'V'; a missing ml_dtypes answers False, never an
    error) and a floating ``torch.dtype``."""
    if "torch" in sys.modules:
        import torch

        if isinstance(dt, torch.dtype):
            return dt.is_floating_point
    dt = np.dtype(dt)
    if dt.kind == "f":
        return True
    try:
        import ml_dtypes

        ml_dtypes.finfo(dt)
        return True
    except Exception:
        return False


# -- host buffers for the planes that move array bytes (collective, ckpt,
# elastic). A leaf is a numpy array or a torch tensor (CPU or CUDA). On the
# host it stays a numpy array wherever numpy has the dtype, as in the
# reference; bfloat16, which numpy names only through ml_dtypes, stays a CPU
# torch tensor. Dtypes travel as the reference's names ("float32",
# "bfloat16"), so manifests and wire metadata read the same in both packages.


def is_tensor(x) -> bool:
    """True for a torch.Tensor (False, without importing torch, when no
    module has imported it)."""
    if "torch" not in sys.modules:
        return False
    import torch

    return isinstance(x, torch.Tensor)


def dtype_name(dt) -> str:
    """The reference's name of a numpy or torch dtype ("float32",
    "bfloat16", "int64", ...)."""
    if "torch" in sys.modules:
        import torch

        if isinstance(dt, torch.dtype):
            return str(dt).rsplit(".", 1)[-1]
    return np.dtype(dt).name


def itemsize(name: str) -> int:
    """Bytes per element of a dtype named as ``dtype_name`` names it."""
    if name == "bfloat16":
        return 2
    return np.dtype(name).itemsize


def host_array(leaf):
    """A C-contiguous host copy or view of ``leaf`` with its shape (0-d
    kept): a numpy array, or a CPU torch tensor for bfloat16. A CUDA tensor
    is copied to the host here (the caller picks the thread)."""
    if is_tensor(leaf):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if dtype_name(t.dtype) == "bfloat16":
            return t
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    return arr


def byte_view(arr) -> memoryview:
    """Flat unsigned-byte view of a C-contiguous host array from
    ``host_array`` (no copy)."""
    if is_tensor(arr):
        import torch

        return memoryview(arr.reshape(-1).view(torch.uint8).numpy())
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def from_bytes(buf, name: str, shape=None):
    """An array of dtype ``name`` over ``buf`` (no copy; writable when
    ``buf`` is), reshaped to ``shape`` when given: a numpy array, or a CPU
    torch tensor for bfloat16."""
    if name == "bfloat16":
        import torch

        if len(buf) == 0:
            t = torch.empty(0, dtype=torch.bfloat16)
        else:
            t = torch.frombuffer(buf, dtype=torch.bfloat16)
        return t if shape is None else t.reshape(tuple(shape))
    arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr if shape is None else arr.reshape(tuple(shape))


def copy_leaf(leaf):
    """An independent copy of ``leaf`` of the same kind: a torch tensor is
    cloned where it lies (a CUDA clone is queued on the current stream, so
    it orders after the step that wrote the tensor and before any later
    in-place update), anything else becomes a numpy copy."""
    if is_tensor(leaf):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


def numel(a) -> int:
    return int(np.prod(a.shape)) if len(a.shape) else 1


def nbytes(a) -> int:
    return numel(a) * itemsize(dtype_name(a.dtype))


def to_float32(a) -> np.ndarray:
    """A float32 numpy copy of a host array (bfloat16 widens exactly)."""
    if is_tensor(a):
        import torch

        return a.to(torch.float32).numpy()
    return a.astype(np.float32)


def from_float32(a: np.ndarray, name: str):
    """A float32 numpy array as a host array of dtype ``name`` (bfloat16
    rounds to nearest even, as ml_dtypes' astype does)."""
    if name == "bfloat16":
        import torch

        return torch.from_numpy(a).to(torch.bfloat16)
    return a.astype(name)


def concat(parts: list):
    """Flat concatenation of host arrays of one kind."""
    if is_tensor(parts[0]):
        import torch

        return torch.cat([p.reshape(-1) for p in parts])
    return np.concatenate([p.reshape(-1) for p in parts])


def zeros(n: int, name: str):
    if name == "bfloat16":
        import torch

        return torch.zeros(n, dtype=torch.bfloat16)
    return np.zeros(n, name)


def backer(leaf):
    """The function that hands a host result back in ``leaf``'s kind: a
    torch tensor on ``leaf``'s device for a torch leaf (host to device
    there), the host array itself otherwise."""
    if not is_tensor(leaf):
        return lambda a: a
    device = leaf.device

    def back(a):
        import torch

        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        return t.to(device) if device.type != "cpu" else t

    return back
