"""GCE GPU node provider: provisions GPU VMs for the autoscaler.

Role-equivalent to the reference's GCP provisioning
(python/ray/autoscaler/_private/gcp/ and autoscaler/v2/instance_manager/
cloud_providers/ — create/terminate/list instances behind a provider
interface), on the Compute Engine instances API:

- One instance per node: POST projects/{p}/zones/{z}/instances with an A3
  ``machineType`` (``a3-highgpu-{n}g``: n H100s come with the machine type)
  or, for a type that carries no GPUs of its own (N1), ``guestAccelerators``
  naming the GCE accelerator and its count.
- An instance sits in PROVISIONING or STAGING until capacity frees (a
  stockout can hold it there); the provider surfaces it as a live but
  pending instance, so the autoscaler does not request the node again every
  update.

The HTTP transport is injected (``api``): production would pass a small
authenticated REST client; tests pass FakeGCEAPI. There is deliberately no
default transport that dials out.
"""
from __future__ import annotations

import time
import uuid
from typing import Optional

from ray_tpu_torch.autoscaler import NodeProvider, NodeType

# Provider instances tag their controller node via this label: the VM's
# startup script passes RAYTPU_NODE_LABELS=raytpu.io/provider-id=<id> so the
# daemon registers carrying it, letting the autoscaler map instance -> node.
PROVIDER_ID_LABEL = "raytpu.io/provider-id"

# Instance statuses that count as "gone" (deleting or stopped: a stopped VM
# holds no GPU and runs no daemon). PROVISIONING and STAGING are live but
# pending; RUNNING and REPAIRING are live.
_TERMINAL = {"STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED", "TERMINATED"}
_BOOT_DISK_GB = 200  # the CUDA image plus the framework's environment

# Machine families whose machine type attaches its GPUs (A2: A100, A3:
# H100, A4: B200, G2: L4); any other family takes ``guestAccelerators``.
_GPU_FAMILIES = {"a2", "a3", "a4", "g2"}


class GCEApi:
    """Transport contract: one call per REST verb the provider needs."""

    def create_instance(self, zone_path: str, body: dict) -> dict:
        raise NotImplementedError

    def delete_instance(self, instance_path: str) -> dict:
        raise NotImplementedError

    def list_instances(self, zone_path: str) -> list[dict]:
        raise NotImplementedError


def _machine_type(node_type: NodeType) -> str:
    """The node type's ``machine_type`` label, else the A3 type with the
    node type's GPU count (``a3-highgpu-8g`` for ``{"GPU": 8}``)."""
    mt = node_type.labels.get("machine_type")
    if mt:
        return mt
    gpus = int(node_type.resources.get("GPU", 0))
    if gpus not in (1, 2, 4, 8):
        raise ValueError(
            f"node type {node_type.name} has {gpus} GPUs and no machine_type label "
            "(A3 machine types carry 1, 2, 4 or 8 H100s)")
    return f"a3-highgpu-{gpus}g"


class GCEGPUNodeProvider(NodeProvider):
    """Create/terminate/list GPU instances in one GCE zone."""

    def __init__(self, project: str, zone: str, api: GCEApi,
                 source_image: str = "projects/deeplearning-platform-release/global/images/family/common-cu124",
                 startup_script: str = "", network: str = "default"):
        self.project = project
        self.zone = zone
        self.api = api
        self.source_image = source_image
        self.startup_script = startup_script
        self.network = network
        self.zone_path = f"projects/{project}/zones/{zone}"
        # provider_id -> (instance path, node_type name)
        self._created: dict[str, tuple[str, str]] = {}

    def instance_body(self, node_type: NodeType, provider_id: str) -> dict:
        mt = _machine_type(node_type)
        body = {
            "name": provider_id,
            "machineType": f"zones/{self.zone}/machineTypes/{mt}",
            "disks": [{
                "boot": True,
                "autoDelete": True,
                "initializeParams": {
                    "sourceImage": self.source_image,
                    "diskSizeGb": str(_BOOT_DISK_GB),
                },
            }],
            "networkInterfaces": [{"network": f"global/networks/{self.network}"}],
            "metadata": {"items": [
                {"key": "startup-script", "value": self.startup_script},
                # The daemon on the VM registers with this label; the
                # autoscaler maps the instance back through it
                # (controller_node_id).
                {"key": "raytpu-node-labels", "value": f"{PROVIDER_ID_LABEL}={provider_id}"},
            ]},
            "labels": {"raytpu-provider-id": provider_id, "raytpu-node-type": node_type.name},
            # GPU instances cannot live-migrate: maintenance stops them.
            "scheduling": {"onHostMaintenance": "TERMINATE", "automaticRestart": True},
        }
        if mt.split("-", 1)[0] not in _GPU_FAMILIES:
            accel = node_type.labels.get("gce_accelerator")
            gpus = int(node_type.resources.get("GPU", 0))
            if not accel or gpus <= 0:
                raise ValueError(
                    f"node type {node_type.name}: machine type {mt} carries no GPUs; "
                    "give it a gce_accelerator label and a GPU count")
            body["guestAccelerators"] = [{
                "acceleratorType": f"zones/{self.zone}/acceleratorTypes/{accel}",
                "acceleratorCount": gpus,
            }]
        return body

    # -- NodeProvider ------------------------------------------------------
    def create_node(self, node_type: NodeType) -> str:
        if not node_type.labels.get("accelerator_type"):
            raise ValueError(f"node type {node_type.name} has no accelerator_type label")
        pid = f"raytpu-{node_type.name}-{uuid.uuid4().hex[:8]}".replace("_", "-").lower()
        self.api.create_instance(self.zone_path, self.instance_body(node_type, pid))
        self._created[pid] = (f"{self.zone_path}/instances/{pid}", node_type.name)
        return pid

    def terminate_node(self, provider_id: str) -> None:
        # Unknown to this process (e.g. provider restarted): the instance's
        # path follows from its name.
        path, _ = self._created.get(
            provider_id, (f"{self.zone_path}/instances/{provider_id}", None))
        self.api.delete_instance(path)
        self._created.pop(provider_id, None)

    def non_terminated_nodes(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for inst in self.api.list_instances(self.zone_path):
            if inst.get("status") in _TERMINAL:
                continue
            labels = inst.get("labels", {})
            pid = labels.get("raytpu-provider-id")
            if pid:
                out[pid] = labels.get("raytpu-node-type", "")
        return out

    def controller_node_id(self, provider_id: str, nodes: Optional[dict] = None) -> Optional[str]:
        """Map an instance to its registered controller node by the provider
        label its daemon carries. None until the VM boots + registers (the
        autoscaler then treats it as not-yet-downscalable)."""
        for nid, n in (nodes or {}).items():
            if n.get("labels", {}).get(PROVIDER_ID_LABEL) == provider_id:
                return nid
        return None


class FakeGCEAPI(GCEApi):
    """In-memory Compute Engine double for tests: instances go PROVISIONING
    -> STAGING -> RUNNING after ``provision_delay_s`` unless ``capacity``
    GPU instances are already live, in which case they stay PROVISIONING
    (a zone's stockout, which the autoscaler must tolerate)."""

    def __init__(self, provision_delay_s: float = 0.0, capacity: int = 1000):
        self.instances: dict[str, dict] = {}
        self.delay = provision_delay_s
        self.capacity = capacity
        self.calls: list[tuple] = []

    def _advance(self, rec: dict):
        age = time.time() - rec["_t0"]
        if rec["status"] == "PROVISIONING" and age >= self.delay / 2:
            rec["status"] = "STAGING"
        if rec["status"] == "STAGING" and age >= self.delay:
            rec["status"] = "RUNNING"

    def create_instance(self, zone_path, body):
        name = body["name"]
        self.calls.append(("create_instance", name))
        live = sum(1 for r in self.instances.values() if r["status"] not in _TERMINAL)
        rec = {**body, "selfLink": f"{zone_path}/instances/{name}",
               "status": "PROVISIONING", "_t0": time.time()}
        if live >= self.capacity:
            rec["_t0"] = float("inf")  # parked: never leaves PROVISIONING
        self.instances[name] = rec
        return {"name": f"op/{name}"}

    def delete_instance(self, instance_path):
        name = instance_path.rsplit("/", 1)[-1]
        self.calls.append(("delete_instance", name))
        if name not in self.instances:
            raise KeyError(instance_path)
        self.instances[name]["status"] = "STOPPING"
        return {"name": f"op/del-{name}"}

    def list_instances(self, zone_path):
        for rec in self.instances.values():
            self._advance(rec)
        return [{k: v for k, v in r.items() if not k.startswith("_")}
                for r in self.instances.values()]
