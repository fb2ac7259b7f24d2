"""Upscale/downscale decisions with hysteresis and a flip cooldown.

The serve controller used to inline this logic (demand / target_ongoing,
apply after a delay window). It moves here and grows the two properties the
scale plane needs:

* overload escalation: when the :class:`~ray_tpu_torch.scale.signals.DemandEstimate`
  says the QoS plane is shedding (or sees a standing queue / a falling AIMD
  limit), the desired replica count is at least ``current + 1`` — shed
  demand appears in no queue, so the demand arithmetic alone would sit
  still exactly when capacity is most needed;
* flip cooldown: after an applied decision, the opposite direction is
  suppressed for ``cooldown_s``. A replica can take long to arrive
  (startup compiles, a node being provisioned); without the cooldown the
  window between "target raised" and "replica serving" reads as
  satisfied-demand-at-higher-target and the policy flaps
  upscale->downscale->upscale (chaos scenario ``autoscale_flap`` pins that
  it does not).

Hysteresis is the reference-shaped delay window: a desire must hold
continuously for ``upscale_delay_s`` / ``downscale_delay_s`` before it is
applied. Every evaluation produces a :class:`ScaleDecision` (applied,
pending, suppressed, or hold) so the decision log explains inaction too.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from ray_tpu_torch.scale.signals import DemandEstimate


@dataclasses.dataclass
class ScaleDecision:
    """One policy evaluation. ``applied`` decisions change the target;
    the rest exist for the decision log / trace events."""

    action: str            # "upscale" | "downscale" | "hold"
    applied: bool
    target: int            # the (possibly unchanged) target after this eval
    desired: int           # what the signals asked for, pre-hysteresis
    reason: str            # "demand" | "overload" | "idle" | "pending" |
    #                        "cooldown" | "steady"
    signals: dict = dataclasses.field(default_factory=dict)
    ts: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ScalePolicy:
    """Per-deployment; the serve controller holds one per autoscaling
    deployment and calls :meth:`decide` every control-loop tick."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 target_ongoing_requests: float = 2.0,
                 upscale_delay_s: float = 0.5, downscale_delay_s: float = 2.0,
                 cooldown_s: float = 5.0):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.target_ongoing = float(target_ongoing_requests)
        self.upscale_delay_s = float(upscale_delay_s)
        self.downscale_delay_s = float(downscale_delay_s)
        self.cooldown_s = float(cooldown_s)
        self._want_since: Optional[float] = None  # hysteresis window start
        self._want_dir: int = 0                   # direction being timed
        self._last_change_ts: Optional[float] = None
        self._last_change_dir: int = 0

    def desired(self, est: DemandEstimate, current: int) -> int:
        """The pre-hysteresis ask: demand arithmetic, escalated under
        overload, clamped to [min, max]."""
        want = math.ceil(est.effective_demand / max(self.target_ongoing, 1e-9))
        if est.overloaded:
            # The QoS plane is turning work away: the shed demand appears in
            # no queue, so ask for at least one more replica than we have.
            want = max(want, current + 1)
        return max(self.min_replicas, min(self.max_replicas, want))

    def decide(self, est: DemandEstimate, current: int,
               now: Optional[float] = None) -> ScaleDecision:
        now = time.time() if now is None else now
        desired = self.desired(est, current)
        direction = (desired > current) - (desired < current)
        base = dict(action="hold", applied=False, target=current,
                    desired=desired, signals=est.to_dict(), ts=now)
        if direction == 0:
            self._want_since, self._want_dir = None, 0
            return ScaleDecision(**{**base, "reason": "steady"})
        action = "upscale" if direction > 0 else "downscale"
        # Flip cooldown: never reverse an applied change inside the window.
        if (self._last_change_ts is not None
                and direction == -self._last_change_dir
                and now - self._last_change_ts < self.cooldown_s):
            self._want_since, self._want_dir = None, 0
            return ScaleDecision(**{**base, "action": action,
                                    "reason": "cooldown"})
        # Hysteresis: the desire must hold for its whole delay window.
        if self._want_dir != direction:
            self._want_since, self._want_dir = now, direction
        delay = self.upscale_delay_s if direction > 0 else self.downscale_delay_s
        if now - self._want_since < delay:
            return ScaleDecision(**{**base, "action": action,
                                    "reason": "pending"})
        self._want_since, self._want_dir = None, 0
        self._last_change_ts, self._last_change_dir = now, direction
        reason = "overload" if (direction > 0 and est.overloaded) else (
            "demand" if direction > 0 else "idle")
        return ScaleDecision(action=action, applied=True, target=desired,
                             desired=desired, reason=reason,
                             signals=est.to_dict(), ts=now)
