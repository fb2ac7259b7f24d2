"""The comparisons that decide ``correct``, each number against its limit
from ``limits/<workload>.json`` ({name: {"limit": x, ...}}).

Serving: the widest gap by which a served token's logit lies below the
plain reference's best, over a sample of the window's finished requests.
Training: the worst relative gap of each checked step's loss; the worst
leaf's gap between the program's and the reference's norm of the first
gradient; the same of the parameters' change over the checked steps, on the
leaves whose reference gradient is above a thousandth of the median leaf's.
A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger.
"""
from __future__ import annotations

from perfbench.metrics._counts import median

TINY_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


def limit(limits: dict, name: str) -> float:
    entry = limits.get(name)
    if entry is None or entry.get("limit") is None:
        raise KeyError(f"no limit for {name!r} in this cell's limits file")
    return float(entry["limit"])


def serving_numbers(records: list) -> dict:
    return {"max_logit_gap": max(r["gap"] for r in records)}


def leaf_gap(prog: dict, ref: dict, leaves=None):
    """(worst gap, leaf): |prog - ref| / max(ref[leaf], median of ref)."""
    med = median(list(ref.values()))
    worst, at = 0.0, None
    for name in (leaves if leaves is not None else ref):
        gap = abs(prog[name] - ref[name]) / max(ref[name], med)
        if gap >= worst:
            worst, at = gap, name
    return worst, at


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grad_norms": {leaf: x}, "change_norms":
    {leaf: x}}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = median(list(ref["grad_norms"].values()))
    moved = [k for k, g in ref["grad_norms"].items() if g >= TINY_GRADIENT * med]
    grad_gap, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    change_gap, change_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "_leaves": {"grad_norm_gap": grad_leaf, "change_norm_gap": change_leaf,
                        "left_out": sorted(set(ref["grad_norms"]) - set(moved))}}


def judge(numbers: dict, limits: dict):
    """(correct, compared): every number (keys without a leading _) held
    against its limit; compared = {name: {"value", "limit"}}."""
    compared = {k: {"value": float(v), "limit": limit(limits, k)}
                for k, v in numbers.items() if not k.startswith("_")}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared
