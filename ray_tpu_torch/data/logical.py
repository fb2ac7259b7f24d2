"""Logical plan: lazy op DAG built by the Dataset API.

Role-equivalent to the reference's logical operators + optimizer
(python/ray/data/_internal/logical/ — operators and rewrite
rules). The one rewrite that matters for throughput is operator fusion:
adjacent one-to-one ops (map/filter/flat_map) execute as a single task per
block, which the planner does by chain-splitting at all-to-all boundaries
(reference: ruleset.py fusion rules).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class LogicalOp:
    kind: str                      # source | map_batches | map | filter | flat_map
                                   # | repartition | random_shuffle | sort | limit
                                   # | union | groupby_map
    fn: Optional[Callable] = None
    params: dict = dataclasses.field(default_factory=dict)
    inputs: list = dataclasses.field(default_factory=list)  # upstream LogicalOps

    ONE_TO_ONE = ("map_batches", "map", "filter", "flat_map")

    @property
    def is_one_to_one(self) -> bool:
        return self.kind in self.ONE_TO_ONE

    def chain_from_source(self) -> list["LogicalOp"]:
        """Linearize (single-input chains only; union handled separately)."""
        chain: list[LogicalOp] = []
        node: Optional[LogicalOp] = self
        while node is not None:
            chain.append(node)
            node = node.inputs[0] if node.inputs else None
        chain.reverse()
        return chain
