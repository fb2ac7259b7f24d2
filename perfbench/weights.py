"""The model's weights, made by the benchmark on the device from the seed.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws every
leaf that the model type's ``leaves(m)`` lists, in its order, in one call
each, in the type it is served or trained in. The same seed on the same
device gives the same tensors, so the plain reference draws its own copy
again instead of reading the program's.
"""
from __future__ import annotations

import torch

from perfbench.harness import seed_for


def make_params(leaves, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree for ``--seed`` from ``leaves`` ([(dotted path,
    shape, std or None for ones)], in draw order): nested dicts by path."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, "weights"))
    tree: dict = {}
    for path, shape, std in leaves:
        *parents, name = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = (torch.ones(shape, dtype=dtype, device=device) if std is None
                      else torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=g))
    return tree


def leaf_items(tree: dict, prefix: str = ""):
    """(dotted path, tensor) of every leaf, in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v
