"""Serve scale plane: capacity control that closes the loop from overload
signal to capacity action.

The QoS plane (ray_tpu_torch/qos/) can only *shed* load: its AIMD admission
controller converges the proxy's concurrency limit down onto whatever the
current replica set can absorb and 429s the rest. This package makes the
same signals *request capacity* instead:

* :mod:`ray_tpu_torch.scale.signals` — a per-deployment demand estimator folding
  the QoS admission controller's own telemetry (per-class queue-delay
  window minima, the AIMD limit trajectory, shed/expired counters), handle
  demand reports, and replica queue depths from heartbeats into one
  :class:`DemandEstimate`;
* :mod:`ray_tpu_torch.scale.policy` — the upscale/downscale decision over that
  estimate, with hysteresis (a desire must hold for its delay window) and
  a cooldown that forbids direction flips (no upscale->downscale
  oscillation while a replica is slow to arrive — chaos scenario
  ``autoscale_flap`` pins this);
* :mod:`ray_tpu_torch.scale.router` — KV-cache-aware routing structures for the
  serve handle: ONE counted-eviction affinity map unifying the old
  model-affinity LRU with prefix-affinity pins (routing order
  prefix -> affinity -> power-of-two-choices), plus the prompt-head
  prefix digest the proxy computes per request.

The ServeController drives its replica targets through the policy, and
when the cluster itself cannot place a wanted replica the unmet footprint
is reported to the core controller's external-demand table, which the node
autoscaler treats exactly like pending task/actor demand — the overload
controller requests machines, not just fewer requests.
"""
from ray_tpu_torch.scale.policy import ScaleDecision, ScalePolicy
from ray_tpu_torch.scale.router import AffinityMap, prefix_digest, prefix_key_for_body
from ray_tpu_torch.scale.signals import DemandEstimate, DemandEstimator

__all__ = [
    "AffinityMap",
    "DemandEstimate",
    "DemandEstimator",
    "ScaleDecision",
    "ScalePolicy",
    "prefix_digest",
    "prefix_key_for_body",
]
