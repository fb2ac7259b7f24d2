"""Carries a parameter tree between ``ray_tpu`` and the port.

The JAX package and the port share one parameter tree: the same names
(``embed``, ``layers.{attn_norm, wq, wk, wv, wo, ffn_norm, w_gate, w_up,
w_down}``, plus ``layers.router`` for MoE, ``final_norm``, ``lm_head``) and
shapes, layers stacked on a leading ``[L, ...]`` axis; a MoE tree's
``w_gate``/``w_up``/``w_down`` carry the expert axis after the layer axis.
``from_numpy_tree`` takes that tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side), checks every name
and shape against the config, and returns torch tensors on ``device``, in
the tree's own dtype. ``to_numpy_tree`` goes the other way. The JAX package
keeps fp32 parameters and casts each one to the activation dtype at every
matmul; the port may cast once at load instead (the engine does), which
gives the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.transformer import TransformerConfig, param_shapes


def _leaf(a, name: str, shape: tuple, device) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"parameter {name}: shape {tuple(a.shape)} != expected {tuple(shape)}")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: move the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_numpy_tree(tree: dict, cfg: TransformerConfig, device="cpu") -> dict:
    """numpy parameter tree -> the port's parameter tree on ``device``."""
    shapes = param_shapes(cfg)
    layers = tree.get("layers", {})
    extra = (set(tree) - set(shapes)) | (set(layers) - set(shapes["layers"]))
    if extra:
        raise ValueError(f"parameters the config does not have (n_experts?): {sorted(extra)}")
    return {
        "embed": _leaf(tree["embed"], "embed", shapes["embed"], device),
        "layers": {
            name: _leaf(layers[name], f"layers.{name}", shp, device)
            for name, shp in shapes["layers"].items()
        },
        "final_norm": _leaf(tree["final_norm"], "final_norm", shapes["final_norm"], device),
        "lm_head": _leaf(tree["lm_head"], "lm_head", shapes["lm_head"], device),
    }


def to_numpy_tree(params: dict) -> dict:
    """The port's parameter tree -> the same tree with numpy leaves on the
    host (bf16 leaves come back as fp32: numpy has no bf16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {
        "embed": leaf(params["embed"]),
        "layers": {name: leaf(t) for name, t in params["layers"].items()},
        "final_norm": leaf(params["final_norm"]),
        "lm_head": leaf(params["lm_head"]),
    }
