"""Per-deployment demand estimation from QoS + serve telemetry.

The reference's autoscaling model (autoscaling_state.py) scales replicas
from ONE signal: queued+ongoing demand reported by handles, divided by
``target_ongoing_requests``. That misses the overload the QoS plane was
built to see: when the AIMD admission controller is shedding, handles never
even queue the rejected requests, so handle demand UNDERSTATES true offered
load exactly when capacity is most needed. This estimator folds the richer
signal set:

* handle demand reports (queued + ongoing per handle; stale ones expire) —
  the baseline capacity ask;
* replica queue depths from controller heartbeats — the server-side view,
  immune to a handle process dying with its reports;
* the proxy's QoS telemetry: per-class queue-delay window MINIMA (a class
  whose best-case delay exceeded target has a standing queue), the AIMD
  limit trajectory (a falling limit means the controller is actively
  backing off), and shed/expired counter deltas (demand that was turned
  away and therefore appears in no queue).

The output is a :class:`DemandEstimate`: the folded demand number plus an
``overloaded`` verdict and the signal breakdown (kept for the decision log
and ``/api/serve`` — a scale decision whose inputs are invisible is
undebuggable).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

# A telemetry/demand report older than this is dropped from the fold — a
# dead proxy or handle must not pin its last (possibly overloaded) view.
REPORT_TTL_S = 5.0


@dataclasses.dataclass
class DemandEstimate:
    """One folded view of a deployment's capacity need."""

    demand: float = 0.0          # queued+ongoing across live handle reports
    replica_depth: float = 0.0   # sum of replica ongoing from heartbeats
    shed_rate: float = 0.0       # QoS sheds/sec attributed to this deployment
    expired_rate: float = 0.0    # deadline expiries/sec
    worst_delay_min: float = 0.0  # worst per-class window-min queue delay (s)
    target_delay_s: float = 0.0  # the AIMD target those minima compare against
    limit_trend: float = 0.0     # AIMD limit slope (negative = backing off)
    overloaded: bool = False     # any overload signal active this fold
    reasons: tuple = ()          # which signals fired ("standing_queue", ...)

    @property
    def effective_demand(self) -> float:
        """The number the policy divides by target_ongoing_requests: the
        larger of the client-side and server-side views (either side can
        understate — handles when their process dies, replicas when work
        queues client-side)."""
        return max(self.demand, self.replica_depth)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["effective_demand"] = self.effective_demand
        d["reasons"] = list(self.reasons)
        return d


class DemandEstimator:
    """Folds raw reports into a :class:`DemandEstimate`.

    Stateless across folds except for the shed/expired rate baselines —
    reporters ship cumulative counters (robust to a lost message, unlike
    deltas), and the estimator differentiates them here.
    """

    def __init__(self, report_ttl_s: float = REPORT_TTL_S):
        self.report_ttl_s = float(report_ttl_s)
        # reporter_id -> (sheds, expired, requests, ts) for rate derivation.
        self._counter_base: dict = {}

    def fold(
        self,
        handle_demand: Iterable[tuple],
        replica_depths: Iterable[tuple],
        qos_reports: Iterable[tuple],
        now: Optional[float] = None,
    ) -> DemandEstimate:
        """handle_demand: (demand, ts) per handle; replica_depths:
        (ongoing, ts) per replica; qos_reports: (reporter_id, report, ts)
        where report is the proxy's telemetry dict (see
        AdmissionController.telemetry + ProxyActor's per-deployment
        shed/expired totals)."""
        now = time.time() if now is None else now
        est = DemandEstimate()
        est.demand = sum(
            d for d, ts in handle_demand if now - ts < self.report_ttl_s
        )
        est.replica_depth = sum(
            d for d, ts in replica_depths if now - ts < self.report_ttl_s
        )
        reasons = []
        live_reporters = set()
        for reporter_id, report, ts in qos_reports:
            if now - ts >= self.report_ttl_s:
                continue
            live_reporters.add(reporter_id)
            sheds = float(report.get("sheds_total", 0.0))
            expired = float(report.get("expired_total", 0.0))
            requests = float(report.get("requests_total", 0.0))
            base = self._counter_base.get(reporter_id)
            if base is None:
                rates = (0.0, 0.0, 0.0)
                self._counter_base[reporter_id] = (sheds, expired, requests, ts, rates)
            elif ts > base[3]:
                dt = max(ts - base[3], 1e-3)
                # max(0, ...): a restarted reporter's counters reset to zero.
                rates = (max(0.0, sheds - base[0]) / dt,
                         max(0.0, expired - base[1]) / dt,
                         max(0.0, requests - base[2]) / dt)
                self._counter_base[reporter_id] = (sheds, expired, requests, ts, rates)
            else:
                # Same report re-folded (the control loop ticks faster than
                # the proxy pushes): HOLD the last derived rates — zeroing
                # them here made the overload verdict flicker off between
                # pushes, resetting the policy's hysteresis window so a
                # purely-shed overload could never sustain its upscale ask.
                rates = base[4]
            shed_rate, expired_rate, request_rate = rates
            est.shed_rate += shed_rate
            est.expired_rate += expired_rate
            # The delay minima and AIMD slope are PROXY-GLOBAL: attribute
            # them to this deployment only while it is actively sharing the
            # proxy (recent requests or its own sheds/expiries) — otherwise
            # an idle deployment that was routed once would ride another
            # deployment's overload all the way to max_replicas.
            if request_rate > 0 or shed_rate > 0 or expired_rate > 0:
                est.worst_delay_min = max(
                    est.worst_delay_min,
                    max(report.get("delay_min_by_class", {}).values(), default=0.0),
                )
                est.target_delay_s = max(
                    est.target_delay_s, float(report.get("target_delay_s", 0.0))
                )
                est.limit_trend += float(report.get("limit_trend", 0.0))
        # Drop baselines for reporters that stopped reporting, so a proxy
        # restart cannot later produce a bogus negative-then-huge rate (and
        # held rates die with the baseline).
        for gone in [r for r in self._counter_base if r not in live_reporters]:
            if now - self._counter_base[gone][3] >= 4 * self.report_ttl_s:
                del self._counter_base[gone]
        # -- the overload verdict -----------------------------------------
        if est.target_delay_s > 0 and est.worst_delay_min > est.target_delay_s:
            # Some class's BEST request queued past target a whole window:
            # a standing queue, not a burst (the CoDel insight).
            reasons.append("standing_queue")
        if est.shed_rate > 0:
            reasons.append("shedding")
        if est.expired_rate > 0:
            reasons.append("expiring")
        if est.limit_trend < 0:
            reasons.append("aimd_backoff")
        est.reasons = tuple(reasons)
        est.overloaded = bool(reasons)
        return est
