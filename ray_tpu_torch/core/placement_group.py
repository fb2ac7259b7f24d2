"""Placement groups: gang resource reservation (reference:
python/ray/util/placement_group.py + GCS/raylet managers;
strategies PACK/SPREAD/STRICT_PACK/STRICT_SPREAD per
bundle_scheduling_policy.h:73-97).
"""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_specs(self):
        return self.bundles

    def ready(self, timeout: float | None = None) -> bool:
        """Block until all bundles are reserved (event-driven: the controller
        parks the request until the PG flips CREATED/REMOVED; no polling)."""
        from ray_tpu_torch.core import api

        core = api._require_worker()
        info = core._run(
            core.controller.call("wait_placement_group", {"pg_id": self.id, "timeout": timeout}),
            timeout=None if timeout is None else timeout + 10,
        )
        return info is not None and info.get("state") == "CREATED"

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def bundle_nodes(self) -> list[str]:
        from ray_tpu_torch.core import api

        core = api._require_worker()
        info = core._run(core.controller.call("get_placement_group", {"pg_id": self.id}))
        return [b["node_id"] for b in info["bundles"]] if info else []

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: list[dict], strategy: str = "PACK", name: str = "",
                    wait: bool = False, label_selector: Optional[dict] = None) -> PlacementGroup:
    """label_selector constrains every bundle to nodes matching the labels
    (TPU-slice gang pinning; reference LabelSelector + PG trick, SURVEY §7.4)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty resource dicts")
    from ray_tpu_torch.core import api

    core = api._require_worker()
    pg_id = PlacementGroupID.from_random()
    core._run(
        core.controller.call(
            "create_placement_group",
            {"pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name,
             "job_id": core.job_id, "wait": wait, "label_selector": label_selector or {}},
        )
    )
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core.controller.call("remove_placement_group", {"pg_id": pg.id}))
