"""The model's weights, made by the benchmark on the device from the seed.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws every
leaf in one call each, in the type it is served or trained in, in the
port's tree layout (layers stacked on a leading [L] axis). The same seed on
the same device gives the same tensors, so the plain reference draws its own
copy again instead of reading the program's. Scales are those of the port's
``init_params``: normal / sqrt(fan_in) for the projections, sqrt(D / V) for
the embedding, ones for the norms.
"""
from __future__ import annotations

import math

import torch

from perfbench.harness import seed_for
from perfbench.metrics._counts import dims

# (leaf, fan-in key): the draw order. None = ones (a norm).
_LAYER_LEAVES = (("attn_norm", None), ("wq", "D"), ("wk", "D"), ("wv", "D"), ("wo", "HHd"),
                 ("ffn_norm", None), ("w_gate", "D"), ("w_up", "D"), ("w_down", "F"))


def shapes(m: dict) -> dict:
    L, D, H, KV, Hd, F, V = dims(m)
    return {
        "embed": (V, D),
        "layers": {"attn_norm": (L, D), "wq": (L, D, H, Hd), "wk": (L, D, KV, Hd), "wv": (L, D, KV, Hd),
                   "wo": (L, H, Hd, D), "ffn_norm": (L, D), "w_gate": (L, D, F), "w_up": (L, D, F),
                   "w_down": (L, F, D)},
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def make_params(m: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree for ``--seed``: {"embed", "layers": {...},
    "final_norm", "lm_head"}."""
    L, D, H, KV, Hd, F, V = dims(m)
    fan = {"D": D, "HHd": H * Hd, "F": F}
    shp = shapes(m)
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, "weights"))

    def draw(shape, std):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=g)

    layers = {}
    for name, fan_key in _LAYER_LEAVES:
        s = shp["layers"][name]
        layers[name] = (torch.ones(s, dtype=dtype, device=device) if fan_key is None
                        else draw(s, 1.0 / math.sqrt(fan[fan_key])))
    embed = draw(shp["embed"], math.sqrt(D / V))
    final_norm = torch.ones(shp["final_norm"], dtype=dtype, device=device)
    lm_head = draw(shp["lm_head"], 1.0 / math.sqrt(D))
    return {"embed": embed, "layers": layers, "final_norm": final_norm, "lm_head": lm_head}


def leaf_items(tree: dict):
    """(name, tensor) of every leaf: "embed", "layers.<name>", "final_norm",
    "lm_head"."""
    yield "embed", tree["embed"]
    for k, v in tree["layers"].items():
        yield f"layers.{k}", v
    yield "final_norm", tree["final_norm"]
    yield "lm_head", tree["lm_head"]
