"""serve public API: start/run/delete/status/shutdown + handles.

Role-equivalent to python/ray/serve/api.py (serve.start,
serve.run, serve.delete, serve.status) and context.py (handle lookup).
"""
from __future__ import annotations

import time
from typing import Optional

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, SERVE_NAMESPACE, ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, _reset_registry


def _get_controller(create: bool = True):
    if not rt.is_initialized():
        rt.init()
    try:
        return rt.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        if not create:
            raise
    # max_restarts: the controller is the serve control plane; it must come
    # back after a crash and restore from its KV checkpoint (reference:
    # controller.py:106 recovers the same way).
    return (
        rt.remote(ServeController)
        .options(
            name=CONTROLLER_NAME,
            namespace=SERVE_NAMESPACE,
            lifetime="detached",
            max_restarts=-1,
            max_concurrency=16,
        )
        .remote()
    )


def start(http_port: Optional[int] = None, proxy: bool = True):
    """Ensure the serve control plane (and optionally the HTTP proxy) is up."""
    ctl = _get_controller()
    rt.get(ctl.ping.remote(), timeout=30)
    if proxy:
        _ensure_proxy(ctl, http_port)
    return ctl


def _ensure_proxy(ctl, http_port: Optional[int]):
    from ray_tpu_torch.serve.proxy import ProxyActor

    try:
        proxy = rt.get_actor("__serve_proxy__", namespace=SERVE_NAMESPACE)
        rt.get(proxy.check_health.remote(), timeout=10)
        return proxy
    except Exception:
        pass
    proxy = (
        rt.remote(ProxyActor)
        .options(
            name="__serve_proxy__",
            namespace=SERVE_NAMESPACE,
            lifetime="detached",
            max_concurrency=64,
        )
        .remote(http_port or 0)
    )
    port = rt.get(proxy.get_port.remote(), timeout=30)
    rt.get(ctl.set_http_port.remote(port), timeout=10)
    return proxy


def run(
    app: Application | Deployment,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
    http: bool = True,
    timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application and block until it is HEALTHY; returns a handle
    to the ingress deployment (reference: serve.run)."""
    if isinstance(app, Deployment):
        app = app.bind()
    nodes = app.flatten()
    specs = []
    for node in nodes:
        # Child Application args become DeploymentHandles in the destination.
        args = tuple(
            DeploymentHandle(a.deployment.name, name) if isinstance(a, Application) else a
            for a in node.args
        )
        kwargs = {
            k: DeploymentHandle(v.deployment.name, name) if isinstance(v, Application) else v
            for k, v in node.kwargs.items()
        }
        cfg = node.deployment.config
        blob, _ = serialization.serialize(
            (node.deployment.func_or_class, args, kwargs, cfg.user_config)
        )
        auto = cfg.autoscaling_config
        specs.append(
            {
                "name": node.deployment.name,
                "blob": blob,
                "config": {
                    "initial_replicas": cfg.initial_replicas(),
                    "max_ongoing_requests": cfg.max_ongoing_requests,
                    "startup_timeout_s": cfg.startup_timeout_s,
                    "autoscaling_config": (
                        {
                            "min_replicas": auto.min_replicas,
                            "max_replicas": auto.max_replicas,
                            "target_ongoing_requests": auto.target_ongoing_requests,
                            "upscale_delay_s": auto.upscale_delay_s,
                            "downscale_delay_s": auto.downscale_delay_s,
                            "metrics_interval_s": auto.metrics_interval_s,
                            "cooldown_s": auto.cooldown_s,
                        }
                        if auto
                        else None
                    ),
                    "ray_actor_options": cfg.ray_actor_options,
                    "request_router": (
                        serialization.dumps_function(cfg.request_router)
                        if cfg.request_router is not None else None
                    ),
                },
            }
        )
    ctl = _get_controller()
    if http and route_prefix is not None:
        _ensure_proxy(ctl, None)
    rt.get(ctl.deploy_app.remote(name, specs, route_prefix if http else None), timeout=timeout_s)
    _wait_healthy(ctl, name, timeout_s)
    _reset_registry()  # topology changed: drop stale cached membership
    return DeploymentHandle(nodes[-1].deployment.name, name)


def _wait_healthy(ctl, app_name: str, timeout_s: float):
    # ONE blocking call: the controller notifies its waiters on every state
    # change (no client-side polling; reference: long-poll updates).
    ok = rt.get(
        ctl.wait_app_healthy.remote(app_name, timeout_s), timeout=timeout_s + 30
    )
    if not ok:
        status = rt.get(ctl.get_status.remote(), timeout=30)
        raise TimeoutError(f"app {app_name!r} not HEALTHY within {timeout_s}s: {status}")


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    ctl = _get_controller(create=False)
    table = rt.get(ctl.get_route_table.remote(), timeout=10)
    for _, t in table.items():
        if t["app"] == app_name:
            return DeploymentHandle(t["deployment"], app_name)
    raise ValueError(f"no routed app {app_name!r}")


def status() -> dict:
    ctl = _get_controller(create=False)
    return rt.get(ctl.get_status.remote(), timeout=30)


def register_slo(spec: dict) -> dict:
    """Register (or replace) one SLO objective for a serve deployment —
    latency p99 / availability / TTFT per deployment x priority class x
    tenant. Spec format: obs/slo.py. Evaluated continuously on the cluster
    controller; state shows up on /api/slo and `raytpu slo`."""
    from ray_tpu_torch import obs as _obs

    res = _obs.slo_register(spec)
    if not res.get("ok", False):
        raise ValueError(res.get("error", "slo objective rejected"))
    return res["objective"]


def unregister_slo(name: str) -> bool:
    from ray_tpu_torch import obs as _obs

    return _obs.slo_unregister(name)


def slo_status() -> list:
    """Status rows (state, burn rates) for every registered objective."""
    from ray_tpu_torch import obs as _obs

    return _obs.slo_status()


def http_port() -> int:
    ctl = _get_controller(create=False)
    port = rt.get(ctl.get_http_port.remote(), timeout=10)
    if port is None:
        raise RuntimeError("HTTP proxy not started")
    return port


def rpc_port() -> int:
    """Binary RPC ingress port (the gRPC-proxy equivalent)."""
    proxy = rt.get_actor("__serve_proxy__", namespace=SERVE_NAMESPACE)
    return rt.get(proxy.get_rpc_port.remote(), timeout=10)


def delete(app_name: str = "default"):
    ctl = _get_controller(create=False)
    rt.get(ctl.delete_app.remote(app_name), timeout=60)
    _reset_registry()


def shutdown():
    """Tear down all apps, the proxy, and the controller."""
    try:
        ctl = _get_controller(create=False)
    except Exception:
        _reset_registry()
        return
    try:
        rt.get(ctl.shutdown.remote(), timeout=60)
    except Exception:
        pass
    for actor_name in ("__serve_proxy__", CONTROLLER_NAME):
        try:
            rt.kill(rt.get_actor(actor_name, namespace=SERVE_NAMESPACE))
        except Exception:
            pass
    _reset_registry()
