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
