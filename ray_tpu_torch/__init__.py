"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference, which it never
imports). The core surface (tasks, actors, objects, placement groups) is the
reference's, on the port's own runtime: ``import ray_tpu_torch as rt;
rt.init(...)``, ``@rt.remote(num_gpus=1)``, ``rt.put``/``rt.get``, with
``torch.Tensor`` values moved out of band. Importing this package is light:
torch is imported by the ML subpackages, not here nor by the runtime.

- ``ray_tpu_torch.core``    the runtime: core worker, node daemon,
                            controller, shared-memory object store, RPC
- ``ray_tpu_torch.obs``     flight recorder, health, profiler, SLO, autopsy
- ``ray_tpu_torch.chaos``   seeded fault injection (the gate, its sites and
                            the invariant-checked scenario runner)
- ``ray_tpu_torch.analysis`` graftlint, the AST invariant checker
                            (``python -m ray_tpu_torch lint``)
- ``ray_tpu_torch.accel``   GPU detection and device isolation
- ``ray_tpu_torch.models``  the transformer's forward pieces and its params
- ``ray_tpu_torch.ops``     attention kernels (CUDA C++ for sm_90a, built at
                            first use) and their plain PyTorch versions
- ``ray_tpu_torch.llm``     the continuous-batching serving engine, and the
                            serving surface on it (tokenizer, LLMServer,
                            OpenAIServer, build_llm_app, build_openai_app)
- ``ray_tpu_torch.qos``     the request context, fair queue, admission
- ``ray_tpu_torch.serve``   serving on the runtime: controller, replicas,
                            handles, the HTTP proxy and binary RPC ingress
- ``ray_tpu_torch.scale``   serve's demand estimator, scale policy and
                            affinity routing
- ``ray_tpu_torch.util``    metrics, tracing, background-task helpers
- ``ray_tpu_torch.convert`` a ``ray_tpu`` parameter tree -> the port's
"""
from ray_tpu_torch._version import version as __version__
from ray_tpu_torch.core.api import (
    Cluster,
    available_resources,
    cluster_resources,
    get,
    get_actor,
    get_async,
    get_runtime_context,
    init,
    init_cluster,
    is_initialized,
    kill,
    list_named_actors,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch import state
from ray_tpu_torch.core.actor import method
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator, ObjectLostError, GetTimeoutError
from ray_tpu_torch.core.placement_group import PlacementGroup, placement_group, remove_placement_group
from ray_tpu_torch.core.serialization import DeviceUnavailableError, RemoteError
from ray_tpu_torch.core.task_spec import SchedulingStrategy
from ray_tpu_torch.core.worker import ActorDiedError

__all__ = [
    "ActorDiedError",
    "Cluster",
    "DeviceUnavailableError",
    "GetTimeoutError",
    "ObjectLostError",
    "ObjectRef",
    "ObjectRefGenerator",
    "PlacementGroup",
    "RemoteError",
    "SchedulingStrategy",
    "available_resources",
    "cluster_resources",
    "get",
    "get_actor",
    "get_async",
    "get_runtime_context",
    "init",
    "init_cluster",
    "is_initialized",
    "kill",
    "list_named_actors",
    "method",
    "nodes",
    "placement_group",
    "put",
    "remote",
    "remove_placement_group",
    "shutdown",
    "state",
    "timeline",
    "wait",
]
