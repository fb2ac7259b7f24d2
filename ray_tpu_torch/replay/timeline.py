"""Declarative chaos timeline: phase-anchored actions for a replay run.

A timeline names actions against the trace's phases ("slow replicas during
the storm", "TPU preemption notice early in recovery", "weight publication
mid-recovery") and compiles them into two artifacts:

* **Seeded fault rules** for the existing :class:`FaultSchedule`. Chaos
  rules fire on deterministic *hit counters*, not wall clocks — so the
  compiler projects time anchors into hit space: a slow-replica window
  [a, b) becomes ``skip = requests arriving before a`` and ``max_faults =
  requests inside the window`` (counted off the trace itself), and a
  preemption notice at wall offset *t* becomes ``nth = t / heartbeat``
  on the victim's ``tpu.preempt`` gate. The projection is approximate in
  wall time (shedding shifts hits, and sites that fire in replica
  processes count hits per process), but EXACT in replay space: two
  same-seed runs fire the same rules at the same hit numbers, which is
  the determinism the acceptance diff asserts.

* **Control-plane actions** the driver executes on the (warped) wall
  clock during the run — things that are cluster *operations* rather than
  injected faults, e.g. a mid-run checkpoint publication. Their wall
  timing does not participate in the injection-log identity; their
  effects flow through the normal seeded gates (``ckpt.publish.swap``).

One seed therefore replays the whole day: trace bytes, fault sequence,
and action order.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch import chaos as _chaos

ACTIONS = ("slow_replica_window", "client_flap", "tpu_preempt",
           "publish_weights", "chaos_rule")


@dataclass
class CompiledTimeline:
    """What ``Timeline.compile`` hands the scenario: an installable chaos
    spec, the wall-clock action list, and the phase spans (trace seconds)
    the ledger's per-phase stats reuse."""

    spec: dict
    control: list = field(default_factory=list)  # [(t_trace_s, action), ...]
    spans: dict = field(default_factory=dict)


class Timeline:
    """``spans``: phase name -> (t0, t1) in trace seconds (usually
    ``trace.phase_spans(params)``). ``actions``: a list of dicts, each with
    an ``action`` from :data:`ACTIONS` plus a ``phase`` / ``offset_s``
    anchor; see the compiler for per-action fields."""

    def __init__(self, spans: dict, actions: list):
        self.spans = dict(spans)
        self.actions = list(actions)
        for a in self.actions:
            if a.get("action") not in ACTIONS:
                raise ValueError(f"unknown timeline action {a.get('action')!r} "
                                 f"(known: {ACTIONS})")
            if "phase" in a and a["phase"] not in self.spans:
                raise ValueError(f"action {a['action']!r} anchors to unknown "
                                 f"phase {a['phase']!r} (have: {sorted(self.spans)})")

    def _anchor(self, a: dict) -> float:
        lo, _hi = self.spans[a["phase"]] if "phase" in a else (0.0, 0.0)
        return lo + float(a.get("offset_s", 0.0))

    def _window(self, a: dict) -> tuple[float, float]:
        t0 = self._anchor(a)
        if a.get("duration_s") is not None:
            return t0, t0 + float(a["duration_s"])
        _lo, hi = self.spans[a["phase"]] if "phase" in a else (0.0, t0)
        return t0, hi  # default: to the end of the anchoring phase

    def compile(self, seed: int, records: list, *, time_warp: float = 1.0,
                heartbeat_s: float = 0.2,
                lead_s: float = 3.0) -> CompiledTimeline:
        """Project every action into rules/control entries. ``records`` is
        the synthesized trace (hit-space projection source); ``lead_s``
        estimates the wall time between schedule install and replay start
        (cluster + app bring-up) for gates whose hits accrue from process
        start, e.g. heartbeat-driven ``tpu.preempt``."""
        arrivals = [r["t"] for r in records]

        def hits_before(t: float) -> int:
            return bisect.bisect_left(arrivals, t)

        rules: list = []
        control: list = []
        for a in self.actions:
            kind = a["action"]
            if kind == "slow_replica_window":
                t0, t1 = self._window(a)
                rule = {"site": "serve.replica.slow", "kind": "delay",
                        "delay_s": float(a.get("delay_s", 0.03)),
                        "skip": hits_before(t0),
                        "max_faults": max(1, hits_before(t1) - hits_before(t0))}
                if a.get("deployment"):
                    rule["ctx"] = {"deployment": a["deployment"]}
                rules.append(rule)
            elif kind == "client_flap":
                t0, t1 = self._window(a)
                rules.append({
                    "site": "replay.request.send",
                    "kind": a.get("kind", "delay"),
                    "delay_s": float(a.get("delay_s", 0.05)),
                    "every": int(a.get("every", 7)),
                    "skip": hits_before(t0),
                    "max_faults": max(1, (hits_before(t1) - hits_before(t0))
                                      // max(1, int(a.get("every", 7)))),
                })
            elif kind == "tpu_preempt":
                t_wall = lead_s + self._anchor(a) / time_warp
                rule = {"site": "tpu.preempt", "kind": "preempt",
                        "nth": max(1, int(t_wall / max(heartbeat_s, 1e-3))),
                        "delay_s": float(a.get("grace_s", 0.4))}
                ctx = {k: a[k] for k in ("worker_id", "slice") if k in a}
                if ctx:
                    rule["ctx"] = ctx
                rules.append(rule)
            elif kind == "chaos_rule":
                rules.append(dict(a["rule"]))
            else:  # control-plane: executed on the wall clock by the driver
                control.append((self._anchor(a), dict(a)))
        spec = {"seed": int(seed), "rules": rules}
        _chaos.FaultSchedule.from_spec(spec)  # fail loud on a bad site/kind now
        control.sort(key=lambda x: x[0])
        return CompiledTimeline(spec=spec, control=control, spans=self.spans)


class TimelineDriver:
    """Executes a compiled timeline's control-plane actions at their warped
    wall offsets while the replayer runs. ``handlers`` maps action name ->
    callable(action_dict) -> detail; outcomes land in ``log`` (the ledger
    embeds it, so a run report shows what the timeline actually did and
    how late each action fired)."""

    def __init__(self, control: list, handlers: dict, *,
                 time_warp: float = 1.0):
        self.control = list(control)
        self.handlers = dict(handlers)
        self.time_warp = float(time_warp)
        self.log: list = []
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TimelineDriver":
        self._thread = threading.Thread(
            target=self._run, name="raytpu-timeline", daemon=True)
        self._t0 = time.perf_counter()
        self._thread.start()
        return self

    def _run(self):
        for t_trace, action in self.control:
            delay = self._t0 + t_trace / self.time_warp - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            entry = {"t": t_trace, "action": action["action"],
                     "late_s": round(time.perf_counter()
                                     - (self._t0 + t_trace / self.time_warp), 3)}
            fn: Optional[Callable] = self.handlers.get(action["action"])
            try:
                if fn is None:
                    raise KeyError(f"no handler for {action['action']!r}")
                entry["detail"] = fn(action)
                entry["ok"] = True
            except Exception as e:  # noqa: BLE001 - recorded, never raised mid-run
                entry["ok"] = False
                entry["detail"] = f"{type(e).__name__}: {e}"
            self.log.append(entry)

    def join(self, timeout: float = 60.0) -> list:
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        return list(self.log)
