"""ray_tpu_torch.serve: model/app serving on the port's runtime.

Counterpart of ``ray_tpu.serve`` (controller, replicas, HTTP proxy, pow-2
router, autoscaling, batching, multiplexing, the binary RPC ingress); see
each submodule's docstring for the reference mapping. The only device seam
is the replica's GPU share: ``ray_actor_options={"num_gpus": f}`` becomes
the replica actor's ``GPU`` demand. The LLM apps on it are
``ray_tpu_torch.llm.build_llm_app`` / ``build_openai_app``.
"""
from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_port,
    register_slo,
    rpc_port,
    run,
    shutdown,
    slo_status,
    start,
    status,
    unregister_slo,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.proto_client import ProtoServeClient, ProtoServeError
from ray_tpu_torch.serve.proxy import HTTPResponse, Request

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "HTTPResponse",
    "ProtoServeClient",
    "ProtoServeError",
    "Request",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "http_port",
    "multiplexed",
    "register_slo",
    "rpc_port",
    "run",
    "shutdown",
    "slo_status",
    "start",
    "status",
    "unregister_slo",
]
