"""Adaptive admission control for the serve proxy: an AIMD concurrency
limit driven by observed queue delay (CoDel-style), shedding excess load
class-by-class so interactive goodput holds under sustained overload.

Why not a static limit: the right concurrency bound depends on replica
count, per-request service time, and what else shares the host — all of
which drift at runtime. Instead the proxy measures each admitted request's
QUEUE DELAY (time spent waiting for a replica slot in the handle's fair
queue — pure waste, the signal CoDel keys on) and adapts:

* the window MINIMUM is kept PER CLASS: with strict priority the
  interactive class's delays are near-zero even when best_effort has a
  standing queue, so a single global minimum would mask exactly the
  overload this controller exists to shed. If ANY class's best-case delay
  exceeded the target for a whole interval, that class has a standing
  queue -> multiplicative decrease (limit *= beta);
* otherwise, with traffic flowing -> additive increase (limit += 1),
  probing for capacity.

Shedding order under pressure is class-tiered: ``best_effort`` sheds when
TOTAL admitted concurrency reaches 60% of the limit, ``batch`` at 85% —
but ``interactive`` is capped against its OWN in-flight count (with
headroom), so converging the limit down onto a background flood can never
start rejecting the protected class. Every rejection carries
``Retry-After`` (derived from the current delay picture) and is counted by
the caller (``serve.request.shed_total{reason,class}``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ray_tpu_torch.qos.context import PRIORITIES

# Per-class admission caps as a fraction of the adaptive limit. Background
# classes check TOTAL inflight against their cap (they shed first);
# interactive checks only its OWN inflight against the headroom cap, so a
# limit that converged down onto background load never sheds it.
_CLASS_CAPS = (1.5, 0.85, 0.6)  # interactive, batch, best_effort
_BETA = 0.7  # multiplicative decrease factor


class AdmissionController:
    """Thread-safe; all methods are cheap enough for the per-request path.
    ``now`` is injectable for deterministic tests."""

    def __init__(self, target_delay_s: float = 0.1, min_limit: int = 4,
                 max_limit: int = 1024, initial_limit: int = 64,
                 interval_s: float = 0.5,
                 now: Callable[[], float] = time.monotonic,
                 on_adapt: Optional[Callable[[float, int], None]] = None):
        self.target_delay_s = float(target_delay_s)
        self.min_limit = int(min_limit)
        self.max_limit = int(max_limit)
        self.limit = float(min(max(initial_limit, min_limit), max_limit))
        self.interval_s = float(interval_s)
        self._now = now
        self._on_adapt = on_adapt
        self._lock = threading.Lock()
        self.inflight = 0
        self.class_inflight = [0] * len(PRIORITIES)
        self._window_start = now()
        # rank -> the window's minimum observed queue delay for that class.
        self._window_min: dict[int, float] = {}
        self._window_max_delay = 0.0
        self._saw_traffic = False
        # -- scale-plane telemetry (ray_tpu_torch/scale/signals.py): the LAST
        # completed window's per-class minima, the limit's trajectory, and
        # a cumulative shed tally — the signals that let the autoscaler
        # REQUEST capacity instead of only shedding.
        self.sheds_total = 0
        self._last_window_min: dict[int, float] = {}
        self._prev_limit = self.limit

    # -- the per-request surface ----------------------------------------
    def try_admit(self, rank: int) -> tuple[bool, float]:
        """(admitted, retry_after_s). rank is the priority class index
        (0 = interactive). Admission increments inflight; the caller MUST
        pair every True with exactly one release(rank)."""
        rank = min(max(rank, 0), len(PRIORITIES) - 1)
        with self._lock:
            self._maybe_adapt_locked()
            self._saw_traffic = True
            cap = self.limit * _CLASS_CAPS[rank]
            occupancy = self.class_inflight[0] if rank == 0 else self.inflight
            if occupancy >= cap:
                self.sheds_total += 1
                return False, self._retry_after_locked()
            self.inflight += 1
            self.class_inflight[rank] += 1
            return True, 0.0

    def record_delay(self, delay_s: float, rank: int = 0) -> None:
        """Feed one admitted request's observed queue delay (seconds spent
        waiting for a replica slot), tagged with its class."""
        rank = min(max(rank, 0), len(PRIORITIES) - 1)
        with self._lock:
            m = self._window_min.get(rank)
            if m is None or delay_s < m:
                self._window_min[rank] = delay_s
            if delay_s > self._window_max_delay:
                self._window_max_delay = delay_s
            self._maybe_adapt_locked()

    def release(self, rank: int = 0) -> None:
        rank = min(max(rank, 0), len(PRIORITIES) - 1)
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            self.class_inflight[rank] = max(0, self.class_inflight[rank] - 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {"limit": self.limit, "inflight": self.inflight,
                    "class_inflight": list(self.class_inflight),
                    "target_delay_s": self.target_delay_s}

    def telemetry(self) -> dict:
        """The scale-plane feed (proxy -> ServeController ->
        scale/signals.py): limit + its last-adaptation slope, the last
        completed window's per-class delay minima (class NAMES as keys so
        the fold never re-derives rank order), and the cumulative shed
        tally (the estimator differentiates it into a rate)."""
        with self._lock:
            return {
                "limit": self.limit,
                "limit_trend": self.limit - self._prev_limit,
                "inflight": self.inflight,
                "target_delay_s": self.target_delay_s,
                "delay_min_by_class": {
                    PRIORITIES[r]: v for r, v in self._last_window_min.items()
                },
                "sheds_total": float(self.sheds_total),
            }

    # -- adaptation ------------------------------------------------------
    def _retry_after_locked(self) -> float:
        """Hint for the 429: roughly how long until the standing queue
        drains at the current delay picture — never less than 0.2s so
        clients don't hammer, never a silly large number."""
        est = max(self._window_max_delay * 2.0, self.target_delay_s * 2.0, 0.2)
        return min(round(est, 1), 30.0)

    def _maybe_adapt_locked(self) -> None:
        now = self._now()
        if now - self._window_start < self.interval_s:
            return
        # The worst class's BEST delay: if even the luckiest request of some
        # class queued past target all window, that class has a standing
        # queue (not a burst) -> back off hard.
        worst_min = max(self._window_min.values(), default=None)
        self._prev_limit = self.limit
        if worst_min is not None and worst_min > self.target_delay_s:
            self.limit = max(float(self.min_limit), self.limit * _BETA)
        elif worst_min is not None or self._saw_traffic:
            self.limit = min(float(self.max_limit), self.limit + 1.0)
        self._window_start = now
        self._last_window_min = dict(self._window_min)
        self._window_min.clear()
        self._window_max_delay = 0.0
        self._saw_traffic = False
        if self._on_adapt is not None:
            self._on_adapt(self.limit, self.inflight)
