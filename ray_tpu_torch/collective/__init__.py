"""ray_tpu_torch.collective: named collective groups (host control plane).

Role-equivalent to the reference's ray.util.collective
(python/ray/util/collective/collective.py: init_collective_group
:171, create_collective_group:211, allreduce:328, barrier:368, reduce:381,
broadcast:443, allgather:493, reducescatter:542, send:601/recv:664). The
reference backs these with NCCL/Gloo process groups; this module is the HOST
plane, as in ``ray_tpu``: tensors (numpy arrays, or torch tensors on the CPU
or a GPU, which cross to the host) move rank to rank over the worker ring —
gradient sync, bootstrap, barriers and metric aggregation — rendezvoused
through a named coordinator actor exactly like the reference's named-actor +
KV rendezvous (collective.py:71 GroupManager).
"""
from ray_tpu_torch.collective.collective import (
    CollectiveActorMixin,
    CollectiveWork,
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reduce,
    reducescatter,
    reducescatter_async,
    send,
)
from ray_tpu_torch.collective.ring import CollectiveError

__all__ = [
    "CollectiveActorMixin",
    "CollectiveError",
    "CollectiveWork",
    "allgather",
    "allgather_async",
    "allreduce",
    "allreduce_async",
    "barrier",
    "broadcast",
    "create_collective_group",
    "destroy_collective_group",
    "get_rank",
    "get_collective_group_size",
    "init_collective_group",
    "recv",
    "reduce",
    "reducescatter",
    "reducescatter_async",
    "send",
]
