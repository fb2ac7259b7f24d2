"""Task/actor specs and options.

Role-equivalent to the reference's TaskSpecification
(src/ray/common/task/task_spec.h) and the .options() plumbing
in python/ray/remote_function.py / actor.py: a task spec is the unit handed
from a submitter to an executor; scheduling-relevant fields (resources,
placement group, label selector, scheduling strategy) are what the controller
sees; the payload (function id + pickled args) is opaque to it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.core.ids import ActorID, JobID, PlacementGroupID, TaskID


@dataclass
class SchedulingStrategy:
    """DEFAULT (hybrid pack-then-spread), SPREAD, NODE_AFFINITY, PLACEMENT_GROUP."""

    kind: str = "DEFAULT"
    node_id: Optional[str] = None  # NODE_AFFINITY
    soft: bool = False
    placement_group: Optional[PlacementGroupID] = None
    bundle_index: int = -1


@dataclass
class TaskOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: dict = field(default_factory=dict)
    num_returns: int = 1
    max_retries: int = -1  # -1 => config default
    retry_exceptions: bool = False
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    label_selector: dict = field(default_factory=dict)
    name: str = ""
    runtime_env: dict = field(default_factory=dict)
    # Streaming generators: max yielded-but-unconsumed items before the
    # producer pauses for consumer acks; -1 = unbounded (reference:
    # _generator_backpressure_num_objects, same default).
    generator_backpressure: int = -1

    def resource_demand(self) -> dict:
        d = dict(self.resources)
        if self.num_cpus:
            d["CPU"] = d.get("CPU", 0) + self.num_cpus
        if self.num_gpus:
            d["GPU"] = d.get("GPU", 0) + self.num_gpus
        return d


@dataclass
class ActorOptions(TaskOptions):
    num_cpus: float = 0.0  # actors hold no CPU while idle, like the reference default
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    lifetime: str = ""  # "" | "detached"
    get_if_exists: bool = False
    max_pending_calls: int = -1
    # Named concurrency groups: {"io": 2, "compute": 4} gives each group its
    # own executor lane with its own parallelism cap (reference:
    # ConcurrencyGroupManager, core_worker/task_execution). Methods pick a
    # group via @method(concurrency_group=...) or per-call .options().
    concurrency_groups: dict = field(default_factory=dict)


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    fn_id: str  # controller-KV key of the exported function
    args_blob: bytes  # serialized (args, kwargs)
    num_returns: int
    options: TaskOptions
    caller_addr: str = ""  # owner of returned objects
    # actor-task fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    concurrency_group: str = ""  # "" = method default, then the default lane
    # Distributed tracing: the caller's active (trace_id, span_id) at
    # submission, or None (the overwhelmingly common case). Rides the pickled
    # spec / lean-frame payload — no wire-version bump (util/tracing.py).
    trace_ctx: Optional[tuple] = None
    # QoS: the caller's active (rank, tenant, deadline, rid) at submission,
    # or None. Same propagation scheme as trace_ctx (pickled spec / the
    # lean-frame "qc" key) — see ray_tpu_torch/qos/context.py.
    qos_ctx: Optional[tuple] = None

    @property
    def is_actor_task(self) -> bool:
        return self.actor_id is not None and self.method_name != ""


@dataclass
class ActorSpec:
    actor_id: ActorID
    job_id: JobID
    cls_id: str  # controller-KV key of the exported class
    init_args_blob: bytes
    options: ActorOptions
    name: str = ""
    namespace: str = "default"
    owner_addr: str = ""


def scheduling_key(fn_id: str, opts: TaskOptions) -> str:
    """Tasks with the same function + demand + runtime env share worker
    leases (reference: SchedulingKey in normal_task_submitter.h; runtime-env
    hash keying as in worker_pool.h idle caching)."""
    ss = opts.scheduling_strategy
    renv = opts.runtime_env.get("hash", "") if opts.runtime_env else ""
    return f"{fn_id}|{sorted(opts.resource_demand().items())}|{ss.kind}|{ss.node_id}|{ss.placement_group}|{ss.bundle_index}|{sorted(opts.label_selector.items())}|{renv}"
