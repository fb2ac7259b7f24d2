"""Serve configuration types.

Role-equivalent to the reference's deployment/autoscaling configs
(python/ray/serve/config.py — AutoscalingConfig,
python/ray/serve/_private/config.py — DeploymentConfig). Redesigned as plain
dataclasses; the autoscaling model is the reference's v2 one: handles report
queued+ongoing demand, the controller targets `target_ongoing_requests` per
replica (autoscaling_state.py:_get_total_num_requests).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    target_ongoing_requests: float = 2.0
    # Decisions must hold for these windows before they are applied
    # (reference: upscale_delay_s / downscale_delay_s).
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.25
    # Flip cooldown (scale/policy.py): after an applied change the opposite
    # direction is suppressed for this window — a replica slow to arrive
    # (startup compile, node provisioning) must not read as
    # satisfied-demand and flap the target back down (chaos scenario
    # autoscale_flap pins no-oscillation).
    cooldown_s: float = 5.0

    def desired(self, total_demand: float) -> int:
        import math

        want = math.ceil(total_demand / max(self.target_ongoing_requests, 1e-9))
        return max(self.min_replicas, min(self.max_replicas, want))

    def to_policy(self):
        """The scale-plane decision object this config parameterizes."""
        from ray_tpu_torch.scale.policy import ScalePolicy

        return ScalePolicy(
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            target_ongoing_requests=self.target_ongoing_requests,
            upscale_delay_s=self.upscale_delay_s,
            downscale_delay_s=self.downscale_delay_s,
            cooldown_s=self.cooldown_s,
        )


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Any = None
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 2.0
    # Replica construction budget: model replicas that compile during init
    # (an LLM's warmup) legitimately take minutes (reference:
    # DEFAULT_HEALTH_CHECK_TIMEOUT plus its initial-deadline handling).
    startup_timeout_s: float = 600.0
    graceful_shutdown_timeout_s: float = 5.0
    # Custom request-router policy (reference: pluggable routing policies,
    # e.g. PrefixCacheAffinityRouter, prefix_aware_router.py:39): a
    # picklable fn(Request) -> str executed in the PROXY; requests mapping
    # to the same non-empty key stick to one replica (LRU-bounded, same
    # machinery as model multiplexing). Clients without a router can pass an
    # `x-affinity-key` header for the same effect.
    request_router: Optional[Callable] = None

    def initial_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return self.autoscaling_config.min_replicas
        return self.num_replicas
