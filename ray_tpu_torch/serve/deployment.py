"""@serve.deployment decorator + bind() application graphs.

Role-equivalent to the reference's Deployment / Application surface
(python/ray/serve/deployment.py — Deployment.bind,
python/ray/serve/_private/build_app.py — graph flattening). A bound node
carries its constructor args; `serve.run` flattens the graph bottom-up,
replacing child nodes with DeploymentHandles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclasses.dataclass
class Deployment:
    """An un-bound deployment: user callable + config."""

    func_or_class: Callable
    name: str
    config: DeploymentConfig
    route_prefix: Optional[str] = None  # set at run() time for the ingress

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        route_prefix = kwargs.pop("route_prefix", self.route_prefix)
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self.func_or_class, name, cfg, route_prefix)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise RuntimeError(
            f"deployment {self.name} cannot be called directly; use .bind() + serve.run()"
        )


class Application:
    """A bound deployment node; may reference other Applications in its args
    (composition). The root node is the app's ingress."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _children(self) -> list["Application"]:
        out = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                out.append(a)
        return out

    def flatten(self) -> list["Application"]:
        """Dependency-first (children before parents), deduped by identity."""
        seen: dict[int, Application] = {}
        order: list[Application] = []

        def visit(node: "Application"):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        names = [n.deployment.name for n in order]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate deployment names in app graph: {names}")
        return order


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: int | str = 1,
    max_ongoing_requests: int = 8,
    autoscaling_config: AutoscalingConfig | dict | None = None,
    user_config: Any = None,
    ray_actor_options: dict | None = None,
    health_check_period_s: float = 2.0,
):
    """Decorator turning a class or function into a Deployment
    (reference: python/ray/serve/api.py:deployment)."""

    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)
    if num_replicas == "auto" and autoscaling_config is None:
        autoscaling_config = AutoscalingConfig()

    def wrap(obj):
        cfg = DeploymentConfig(
            num_replicas=1 if num_replicas == "auto" else int(num_replicas),
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            ray_actor_options=dict(ray_actor_options or {}),
            health_check_period_s=health_check_period_s,
        )
        return Deployment(obj, name or obj.__name__, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
