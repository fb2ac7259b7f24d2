"""SLO engine: declarative objectives + Google-SRE multi-window burn rates.

The QoS plane already *emits* everything an SLO needs — per-
deployment latency histograms, per-class shed counters, per-hop expiry
counters, TTFT — but nothing *evaluates* them (a goodput/SLO report is
what an operator reads). This module closes
the loop: operators declare objectives (per deployment x priority class x
tenant), the controller samples the merged reporter series on a short
timer, and each objective is judged with the SRE-workbook multi-window
multi-burn-rate method: alert only when BOTH a slow window (sustained) and
a fast window (still happening) burn error budget faster than threshold.
burn rate = (bad fraction over window) / (error budget); budget 1e-3 at
burn 10 means "at this rate, a 30-day budget is gone in 3 days".

Pure math (``burn_rate``, ``SloTracker``) is separated from series
extraction (``SloEngine.ingest``) so the window arithmetic is testable on
synthetic series without a cluster (tests/test_obs_plane.py).

Objective spec (JSON/dict — Config.slo_spec, serve API, or `raytpu slo`):

    {"name": "chat-p99",               # unique handle (gauge label)
     "metric": "latency",              # latency | availability | ttft
     "target": 0.5,                    # latency/ttft: seconds bound
     "quantile": 0.99,                 # compliance quantile => budget 1-q
     "budget": 0.001,                  # availability: allowed bad fraction
     "app": "", "deployment": "",      # scope filters (empty = any)
     "cls": "", "tenant": "",
     "fast_window_s": 60.0, "slow_window_s": 300.0,
     "burn_threshold": 10.0}
"""
from __future__ import annotations

import collections
from dataclasses import asdict, dataclass
from typing import Optional

METRICS = ("latency", "availability", "ttft")

# Objective states, in escalation order.
OK, BURNING, ALERT = "ok", "burning", "alert"


@dataclass
class Objective:
    name: str
    metric: str = "latency"
    target: float = 0.5          # latency/ttft: seconds threshold
    quantile: float = 0.99       # latency/ttft: compliance quantile
    budget: float = 0.0          # availability: allowed bad fraction (0 -> default)
    app: str = ""                # scope filters; empty matches any
    deployment: str = ""
    cls: str = ""                # priority class (availability scope)
    tenant: str = ""
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 10.0

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"objective {self.name!r}: metric must be one of {METRICS}")
        if not self.name:
            raise ValueError("objective needs a name")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(f"objective {self.name!r}: fast window must be "
                             f"shorter than slow window")

    @property
    def budget_fraction(self) -> float:
        """Error budget as a fraction of requests: latency/ttft objectives
        derive it from the compliance quantile (p99 => 1% may exceed the
        target), availability uses the explicit budget (default 0.1%)."""
        if self.metric == "availability":
            return self.budget or 0.001
        return self.budget or max(1e-6, 1.0 - self.quantile)

    def to_dict(self) -> dict:
        return asdict(self)


def burn_rate(samples, now: float, window_s: float, budget: float) -> Optional[float]:
    """Burn rate over [now - window_s, now] from cumulative (ts, good, total)
    samples: bad fraction across the window divided by the error budget.
    None when the window holds no traffic (no alerting on silence — an idle
    deployment is not violating its SLO)."""
    if not samples:
        return None
    start = now - window_s
    # Baseline: the last sample AT/BEFORE the window start (cumulative
    # counters: deltas against it cover exactly the window), else the
    # window's first sample.
    base = None
    for s in samples:
        if s[0] <= start:
            base = s
        else:
            break
    if base is None:
        base = samples[0]
    end = samples[-1]
    d_total = end[2] - base[2]
    if d_total <= 0:
        return None
    d_good = end[1] - base[1]
    bad_frac = min(1.0, max(0.0, 1.0 - d_good / d_total))
    return bad_frac / max(budget, 1e-9)


class SloTracker:
    """Per-objective state: a bounded window of cumulative (ts, good, total)
    samples plus the multi-window alert FSM."""

    # Sample retention: enough for the slow window at 1 Hz ingest plus slack.
    def __init__(self, objective: Objective, max_samples: int = 720,
                 max_history: int = 720):
        self.objective = objective
        self.samples: collections.deque = collections.deque(maxlen=max_samples)
        self.samples_dropped = 0  # counted trim: ring overflow drops oldest
        # Burn trajectory: one (ts, burn_fast, burn_slow, state) point per
        # evaluate() tick, so the run ledger plots the whole arc instead of
        # sampling whatever the final state happens to be.
        self.history: collections.deque = collections.deque(maxlen=max_history)
        self.history_dropped = 0  # counted trim, same ethos as samples
        self.state = OK
        self.burn_fast: Optional[float] = None
        self.burn_slow: Optional[float] = None
        self.alerts_fired = 0

    def observe(self, ts: float, good: float, total: float):
        if len(self.samples) == self.samples.maxlen:
            self.samples_dropped += 1
        self.samples.append((ts, good, total))

    def evaluate(self, now: float) -> dict:
        """Re-judge the objective; returns the status row with ``changed``
        set when the state moved (the engine turns changes into events).
        alert  = fast AND slow windows both over threshold (SRE workbook:
                 the slow window proves it is sustained, the fast window
                 proves it is still happening)
        burning = fast window over threshold only (budget burning but not
                 yet sustained — the ticket tier)."""
        o = self.objective
        b = o.budget_fraction
        self.burn_fast = burn_rate(self.samples, now, o.fast_window_s, b)
        self.burn_slow = burn_rate(self.samples, now, o.slow_window_s, b)
        fast_hot = self.burn_fast is not None and self.burn_fast >= o.burn_threshold
        slow_hot = self.burn_slow is not None and self.burn_slow >= o.burn_threshold
        new = ALERT if (fast_hot and slow_hot) else (BURNING if fast_hot else OK)
        changed = new != self.state
        if changed and new == ALERT:
            self.alerts_fired += 1
        self.state = new
        if len(self.history) == self.history.maxlen:
            self.history_dropped += 1
        self.history.append((now, self.burn_fast, self.burn_slow, new))
        return self.status(changed=changed)

    def status(self, changed: bool = False) -> dict:
        return {
            "objective": self.objective.to_dict(),
            "state": self.state,
            "burn_fast": self.burn_fast,
            "burn_slow": self.burn_slow,
            "alerts_fired": self.alerts_fired,
            "samples": len(self.samples),
            "changed": changed,
        }

    def history_rows(self) -> dict:
        """The burn trajectory in wire shape: parallel-free row dicts plus
        the drop counter (so a truncated trajectory is visible as such)."""
        return {
            "points": [{"ts": ts, "burn_fast": bf, "burn_slow": bs,
                        "state": st}
                       for ts, bf, bs, st in self.history],
            "dropped": self.history_dropped,
        }


def _hist_good_total(rec: dict, target: float) -> tuple[float, float]:
    """(observations <= target, all observations) from one histogram series
    record — counts[i] buckets observations <= buckets[i] (bisect_left), so
    compliance is the cumulative count through the last boundary <= target."""
    buckets = rec.get("buckets") or []
    counts = rec.get("counts") or []
    good = 0.0
    for b, c in zip(buckets, counts):
        if b <= target:
            good += c
        else:
            break
    return good, float(rec.get("n", 0))


def _tags_match(tags: dict, **want) -> bool:
    return all(not v or tags.get(k, "") == v for k, v in want.items())


class SloEngine:
    """Controller-side registry + evaluator. ``ingest`` extracts each
    objective's (good, total) from one merged metrics snapshot and
    re-evaluates; callers turn the returned state changes into events."""

    MAX_OBJECTIVES = 64

    def __init__(self):
        self.trackers: dict[str, SloTracker] = {}

    def register(self, spec: dict) -> dict:
        o = Objective(**{k: v for k, v in spec.items()
                         if k in Objective.__dataclass_fields__})
        if o.name not in self.trackers and len(self.trackers) >= self.MAX_OBJECTIVES:
            raise ValueError(f"too many SLO objectives (max {self.MAX_OBJECTIVES})")
        self.trackers[o.name] = SloTracker(o)
        return o.to_dict()

    def unregister(self, name: str) -> bool:
        return self.trackers.pop(name, None) is not None

    def _extract(self, o: Objective, series: list[dict]) -> tuple[float, float]:
        """Cumulative (good, total) for one objective from a merged snapshot.
        latency/ttft: compliance from the scoped histogram. availability:
        good = completed requests, bad = sheds + expiries in scope."""
        good = total = 0.0
        if o.metric in ("latency", "ttft"):
            name = "serve.request.latency_s" if o.metric == "latency" else "serve.ttft_s"
            for rec in series:
                if rec.get("name") != name:
                    continue
                t = rec.get("tags", {})
                if not _tags_match(t, app=o.app, deployment=o.deployment,
                                   **({"cls": o.cls} if o.cls else {}),
                                   **({"tenant": o.tenant} if o.tenant else {})):
                    continue
                g, n = _hist_good_total(rec, o.target)
                good += g
                total += n
            return good, total
        # availability
        bad = 0.0
        for rec in series:
            name, t = rec.get("name"), rec.get("tags", {})
            if name == "serve.request.latency_s":
                if _tags_match(t, app=o.app, deployment=o.deployment):
                    good += float(rec.get("n", 0))
            elif name == "serve.request.shed_total":
                if not o.cls or t.get("class", "") == o.cls:
                    bad += float(rec.get("value", 0.0))
            elif name == "serve.request.expired_total":
                if not o.cls or t.get("class", "") == o.cls:
                    bad += float(rec.get("value", 0.0))
        return good, good + bad

    def ingest(self, now: float, series: list[dict]) -> list[dict]:
        """Feed one merged metrics snapshot; returns the status rows whose
        state CHANGED (the controller appends those to its event log and
        stamps them onto recently-active traces)."""
        changes = []
        for tr in self.trackers.values():
            good, total = self._extract(tr.objective, series)
            tr.observe(now, good, total)
            row = tr.evaluate(now)
            if row["changed"]:
                changes.append(row)
        return changes

    def status(self) -> list[dict]:
        return [tr.status() for tr in self.trackers.values()]

    def history(self) -> dict:
        """objective name -> burn-rate trajectory (/api/slo?history=1 and
        the run ledger's ``slo`` section both read this shape)."""
        return {name: tr.history_rows() for name, tr in self.trackers.items()}

    def summary(self) -> dict:
        """The one-line rollup `raytpu status` prints."""
        by = {OK: [], BURNING: [], ALERT: []}
        for tr in self.trackers.values():
            by[tr.state].append(tr.objective.name)
        return {"total": len(self.trackers),
                "ok": len(by[OK]), "burning": by[BURNING], "alert": by[ALERT]}

    def gauges(self, ts: float) -> list[dict]:
        """slo.burn_rate{objective,window} + slo.state{objective} series in
        reporter-record shape, merged into the controller's own series."""
        out = []
        for tr in self.trackers.values():
            name = tr.objective.name
            for window, val in (("fast", tr.burn_fast), ("slow", tr.burn_slow)):
                if val is None:
                    continue
                out.append({"name": "slo.burn_rate", "kind": "gauge",
                            "description": "SLO error-budget burn rate per objective window",
                            "tags": {"objective": name, "window": window},
                            "value": val, "ts": ts})
            out.append({"name": "slo.state", "kind": "gauge",
                        "description": "SLO objective state (0 ok, 1 burning, 2 alert)",
                        "tags": {"objective": name},
                        "value": float((OK, BURNING, ALERT).index(tr.state)),
                        "ts": ts})
        return out
