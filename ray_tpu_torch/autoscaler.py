"""Autoscaler: demand-driven node provisioning over a provider interface.

Role-equivalent to the reference's autoscaler v2
(autoscaler/v2/autoscaler.py:50 `update_autoscaling_state`: read pending
demand from the GCS -> scheduler.py bin-packs onto node types ->
InstanceManager reconciles instances via cloud providers). Node types are
GPU-shaped: ``{"CPU": n, "GPU": g}`` with an ``accelerator_type`` label
naming the card, and gang (placement-group) demand is packed
whole-node-first — a pending gang of 8-GPU bundles scales up by whole
8-GPU hosts, not by one card at a time.

The provider is pluggable (reference: instance_manager/cloud_providers/*).
LocalNodeProvider spawns in-process daemons for tests; the GCE GPU provider
(``ray_tpu_torch.gcp``) implements the same three calls against the Compute
Engine instances API.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional


@dataclasses.dataclass
class NodeType:
    name: str
    resources: dict
    labels: dict = dataclasses.field(default_factory=dict)
    max_workers: int = 10


class NodeProvider:
    """Minimal provider contract (reference: v2 CloudInstanceProvider)."""

    def create_node(self, node_type: NodeType) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> dict[str, str]:
        """provider_id -> node_type name."""
        raise NotImplementedError

    def controller_node_id(self, provider_id: str, nodes: Optional[dict] = None) -> Optional[str]:
        """Map a provider instance to its registered controller node id (used
        to check THAT node's idleness before terminating it). `nodes` is the
        controller's node table for providers that map via labels. None =
        unknown (the autoscaler will then never downscale it)."""
        return None


class LocalNodeProvider(NodeProvider):
    """Spawns in-process NodeDaemons on the test Cluster (the reference tests
    its autoscaler with FakeMultiNodeProvider the same way)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._nodes: dict[str, tuple] = {}  # provider_id -> (daemon, type name)
        self._counter = 0

    def create_node(self, node_type: NodeType) -> str:
        daemon = self.cluster.add_node(resources=dict(node_type.resources), labels=dict(node_type.labels))
        self._counter += 1
        pid = f"local-{node_type.name}-{self._counter}"
        self._nodes[pid] = (daemon, node_type.name)
        return pid

    def terminate_node(self, provider_id: str) -> None:
        daemon, _ = self._nodes.pop(provider_id, (None, None))
        if daemon is not None:
            self.cluster.remove_node(daemon)

    def non_terminated_nodes(self) -> dict[str, str]:
        return {pid: tname for pid, (_, tname) in self._nodes.items()}

    def controller_node_id(self, provider_id: str, nodes: Optional[dict] = None) -> Optional[str]:
        daemon, _ = self._nodes.get(provider_id, (None, None))
        return None if daemon is None else daemon.node_id


# Feasibility/label/accounting logic shared with the scheduler so the
# autoscaler's simulation can never diverge from actual placement decisions.
from ray_tpu_torch.core.controller import _fits, _labels_match, _sub as _consume  # noqa: E402


class Autoscaler:
    """One reconciliation step per update(): launch nodes for unplaceable
    demand, retire idle autoscaled nodes after idle_timeout_s."""

    def __init__(self, node_types: list[NodeType], provider: NodeProvider,
                 idle_timeout_s: float = 60.0, max_launches_per_update: int = 8):
        self.node_types = {t.name: t for t in node_types}
        self.provider = provider
        self.idle_timeout_s = idle_timeout_s
        self.max_launches = max_launches_per_update
        self._idle_since: dict[str, float] = {}
        self._draining: dict[str, str] = {}  # provider_id -> controller node id

    def _cluster_state(self) -> dict:
        from ray_tpu_torch.core import api

        core = api._require_worker()
        return core._run(core.controller.call("get_autoscaler_state", {}))

    def update(self) -> dict:
        """Returns {"launched": {type: n}, "terminated": [provider_ids]}."""
        state = self._cluster_state()
        # Dead instances first (spot preemption, host loss): a provider record
        # whose controller node is DEAD will never serve again, but it still
        # counts against max_workers — release the slot so the replacement
        # for the preempted host can actually launch this update.
        pruned: list[str] = []
        for pid in list(self.provider.non_terminated_nodes()):
            nid = self.provider.controller_node_id(pid, state["nodes"])
            if nid is not None and state["nodes"].get(nid, {}).get("state") == "DEAD":
                try:
                    self.provider.terminate_node(pid)
                except Exception:
                    pass  # a half-dead instance may refuse teardown; the slot is freed either way
                pruned.append(pid)
                self._idle_since.pop(pid, None)
                self._draining.pop(pid, None)
        # Free capacity on live nodes absorbs some pending demand first.
        # Each entry carries the node's labels: label-selected demand only
        # fits nodes the scheduler would actually match.
        frees = [
            (dict(n["resources_available"]), n.get("labels", {}))
            for n in state["nodes"].values()
            if n["state"] == "ALIVE"
        ]
        # (demand, label_selector, no_colocate_key): entries sharing a
        # non-None key must land on DISTINCT planned nodes (STRICT_SPREAD).
        unmet: list[tuple[dict, dict, Optional[str]]] = []
        for item in state["pending"]:
            sel = item.get("label_selector") or {}
            placed = False
            for f, labels in frees:
                if _labels_match(labels, sel) and _fits(f, item["demand"]):
                    _consume(f, item["demand"])
                    placed = True
                    break
            if not placed:
                unmet.append((item["demand"], sel, None))
        for gang in state["pending_gangs"]:
            strategy = gang.get("strategy", "PACK")
            sel = gang.get("label_selector") or {}
            if strategy == "STRICT_PACK":
                # All bundles must land on ONE node — simulate (and demand)
                # the combined footprint, or scale-up never unblocks the PG.
                combined: dict = {}
                for b in gang["bundles"]:
                    for k, v in b.items():
                        combined[k] = combined.get(k, 0) + v
                for f, labels in frees:
                    if _labels_match(labels, sel) and _fits(f, combined):
                        _consume(f, combined)
                        break
                else:
                    unmet.append((combined, sel, None))
                continue
            used_idx: set[int] = set()
            gang_key = f"gang{id(gang)}" if strategy == "STRICT_SPREAD" else None
            for b in gang["bundles"]:
                placed = False
                for i, (f, labels) in enumerate(frees):
                    if strategy == "STRICT_SPREAD" and i in used_idx:
                        continue  # distinct node per bundle
                    if _labels_match(labels, sel) and _fits(f, b):
                        _consume(f, b)
                        used_idx.add(i)
                        placed = True
                        break
                if not placed:
                    unmet.append((b, sel, gang_key))

        launched: dict[str, int] = {}
        existing = self.provider.non_terminated_nodes()
        counts: dict[str, int] = {}
        for tname in existing.values():
            counts[tname] = counts.get(tname, 0) + 1
        planned: list[list] = []  # [free resources, labels, set(no_colocate keys)]
        for demand, sel, key in unmet:
            for node in planned:  # demand may fit on an already-planned node
                f, labels, keys = node
                if key is not None and key in keys:
                    continue  # STRICT_SPREAD sibling already planned here
                if _labels_match(labels, sel) and _fits(f, demand):
                    _consume(f, demand)
                    if key is not None:
                        keys.add(key)
                    break
            else:
                for t in self.node_types.values():
                    total = counts.get(t.name, 0) + launched.get(t.name, 0)
                    if (
                        total < t.max_workers
                        and _labels_match(t.labels, sel)
                        and _fits(dict(t.resources), demand)
                    ):
                        if sum(launched.values()) >= self.max_launches:
                            break
                        launched[t.name] = launched.get(t.name, 0) + 1
                        f = dict(t.resources)
                        _consume(f, demand)
                        planned.append([f, t.labels, {key} if key is not None else set()])
                        break
        for tname, n in launched.items():
            for _ in range(n):
                self.provider.create_node(self.node_types[tname])

        # Downscale (two-phase, reference: DrainRaylet before instance
        # termination — node_manager.proto DrainRaylet):
        #   1. idle past timeout -> DRAIN the controller node (scheduler stops
        #      placing new work there), remember it;
        #   2. next update, still idle -> terminate; anything landed/running
        #      in between -> undrain and reset the timer (never kill
        #      in-flight work).
        terminated: list[str] = []
        now = time.time()
        idle_controller_nodes = {
            nid for nid, n in state["nodes"].items()
            if n["state"] == "ALIVE" and all(
                abs(n["resources_available"].get(k, 0) - v) < 1e-6
                for k, v in n["resources_total"].items()
            )
        }
        quiet = not state["pending"] and not state["pending_gangs"] and not launched
        for pid in list(self.provider.non_terminated_nodes()):
            nid = self.provider.controller_node_id(pid, state["nodes"])
            if quiet and nid in idle_controller_nodes:
                first_idle = self._idle_since.setdefault(pid, now)
                if now - first_idle >= self.idle_timeout_s:
                    if pid not in self._draining:
                        reply = self._call_controller("drain_node", {"node_id": nid})
                        if reply.get("ok"):
                            self._draining[pid] = nid
                        continue  # terminate on the NEXT update if still idle
                    self.provider.terminate_node(pid)
                    terminated.append(pid)
                    self._idle_since.pop(pid, None)
                    self._draining.pop(pid, None)
            else:
                self._idle_since.pop(pid, None)  # busy/unknown: reset its timer
                nid_draining = self._draining.pop(pid, None)
                if nid_draining is not None:
                    # Work appeared while draining: reopen the node.
                    self._call_controller("undrain_node", {"node_id": nid_draining})
        return {"launched": launched, "terminated": pruned + terminated, "unmet": len(unmet),
                "draining": list(self._draining)}

    def _call_controller(self, method: str, payload: dict) -> dict:
        from ray_tpu_torch.core import api

        core = api._require_worker()
        try:
            return core._run(core.controller.call(method, payload)) or {}
        except Exception:
            return {}
