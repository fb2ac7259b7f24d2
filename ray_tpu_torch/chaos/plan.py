"""Seeded, deterministic fault-injection plan: the chaos plane's core.

Reference analogue: Ray's nightly ``chaos_test`` suites kill raylets and
workers on a wall-clock schedule (release/nightly_tests/chaos_test/*,
ray._private.test_utils get_and_run_resource_killer) — effective at scale,
but irreproducible: a failure seen once cannot be replayed. This module
makes every fault a pure function of ``(seed, rule, hit-counter)`` instead
of wall time:

* every fault site in the tree calls ONE gate, :func:`maybe_inject`, whose
  disabled path is a single module-attribute load + ``None`` check (bench
  A/B in ``bench_core.py`` ``detail.chaos_overhead``);
* an installed :class:`FaultSchedule` compiles a declarative spec
  (site pattern x ctx filter x nth/every/probability x kind) into per-rule
  hit counters; the fire/no-fire decision for hit *n* of rule *r* is
  ``blake2b(key=seed)(r, n)`` — no shared RNG stream, so concurrent sites
  cannot perturb each other's sequences and the same seed replays the same
  per-rule injection sequence byte-for-byte;
* every injection is recorded (process-local :func:`injection_log`),
  counted (``chaos.injected_total{site,kind}`` via :func:`metrics_series`,
  shipped by the CoreWorker reporter), and traced
  (``tracing.event("chaos.injected")`` inside the active span) — no silent
  injection, per the counted-trims ethos.

The schedule propagates cluster-wide exactly like every other config flag:
``Config.chaos_spec`` (a JSON string) rides the head-config push to daemons
and workers, plus the ``RAYTPU_CHAOS_SPEC`` env var for spawned worker
processes so faults arm before the first task executes.
"""
from __future__ import annotations

import fnmatch
import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.util import tracing as _tracing


class ChaosError(RuntimeError):
    """Raised (by sites that map kind="error") for an injected fault; the
    message always carries the site name so failures are attributable."""


@dataclass
class Fault:
    """What maybe_inject tells a firing site to do. The SITE maps the kind
    onto its own failure mechanism (drop the frame, raise into the existing
    retry path, evict the object, ...) — the plan never reaches into layers."""

    site: str
    kind: str
    rule_index: int
    hit: int
    delay_s: float = 0.0
    args: dict = field(default_factory=dict)

    def error(self, detail: str = "") -> ChaosError:
        """The canonical exception for kind="error" sites (sites that need a
        specific exception type raise their own, tagging the site name)."""
        return ChaosError(f"chaos[{self.site}#{self.hit}] injected failure{': ' + detail if detail else ''}")


@dataclass
class FaultRule:
    """One line of a schedule spec.

    pattern: fnmatch over site names ("rpc.frame.send", "node.*").
    ctx: subset match against the gate's keyword context — {"worker_id": "1"}
         only counts hits whose ctx carries that exact value (str-compared).
    kind: what the site should do; validated against the site catalog when
          the pattern names a concrete site.
    nth / every / p: fire on exactly the nth matching hit (1-based), on every
          Nth hit, or with probability p per hit (seed-hashed, deterministic).
    skip: ignore the first N matching hits before nth/every/p apply — with
          max_faults this projects a *window* in hit space, which is how the
          replay timeline anchors "slow replicas during the storm phase" onto
          a deterministic counter instead of a wall clock.
    max_faults: stop firing after this many injections (0 = unlimited).
    delay_s: parameter for delay/stall/kill-after kinds.
    """

    pattern: str
    kind: str
    nth: int = 0
    every: int = 0
    p: float = 1.0
    skip: int = 0
    max_faults: int = 0
    delay_s: float = 0.05
    ctx: dict = field(default_factory=dict)
    args: dict = field(default_factory=dict)
    # runtime state (NOT part of the spec): per-rule hit + fault counters.
    hits: int = 0
    faults: int = 0

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultRule":
        known = {"site", "kind", "nth", "every", "p", "skip", "max_faults", "delay_s", "ctx", "args"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown fault-rule keys {sorted(unknown)} (known: {sorted(known)})")
        if not spec.get("site") or not spec.get("kind"):
            raise ValueError(f"fault rule needs 'site' and 'kind': {spec}")
        return cls(
            pattern=spec["site"],
            kind=spec["kind"],
            nth=int(spec.get("nth", 0)),
            every=int(spec.get("every", 0)),
            p=float(spec.get("p", 1.0)),
            skip=int(spec.get("skip", 0)),
            max_faults=int(spec.get("max_faults", 0)),
            delay_s=float(spec.get("delay_s", 0.05)),
            ctx=dict(spec.get("ctx", {})),
            args=dict(spec.get("args", {})),
        )

    def to_spec(self) -> dict:
        out: dict = {"site": self.pattern, "kind": self.kind}
        if self.nth:
            out["nth"] = self.nth
        if self.every:
            out["every"] = self.every
        if self.p != 1.0:
            out["p"] = self.p
        if self.skip:
            out["skip"] = self.skip
        if self.max_faults:
            out["max_faults"] = self.max_faults
        if self.delay_s != 0.05:
            out["delay_s"] = self.delay_s
        if self.ctx:
            out["ctx"] = self.ctx
        if self.args:
            out["args"] = self.args
        return out


class FaultSchedule:
    """A compiled, seeded schedule. Decisions are pure functions of
    (seed, rule index, per-rule hit counter): hit interleaving across sites
    or event-loop scheduling cannot change any rule's firing sequence."""

    def __init__(self, rules: list, seed: int = 0):
        self.seed = int(seed)
        self.rules: list[FaultRule] = list(rules)
        # Keyed hash: one key derivation per schedule, one small hash per
        # probabilistic decision.
        self._key = hashlib.blake2b(
            str(self.seed).encode(), digest_size=16, person=b"raytpu-chaos"
        ).digest()
        self.validate()

    # -- construction ---------------------------------------------------
    @classmethod
    def from_spec(cls, spec: dict | str) -> "FaultSchedule":
        """Compile {"seed": N, "rules": [{...}, ...]} (dict or JSON text)."""
        if isinstance(spec, str):
            spec = json.loads(spec)
        return cls([FaultRule.from_spec(r) for r in spec.get("rules", [])],
                   seed=int(spec.get("seed", 0)))

    def to_spec(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_spec() for r in self.rules]}

    def to_json(self) -> str:
        return json.dumps(self.to_spec(), sort_keys=True)

    def validate(self) -> None:
        """Concrete (non-wildcard) patterns must name a cataloged site, and
        the kind must be one that site supports — a typo'd site name would
        otherwise arm a schedule that injects nothing, silently."""
        from ray_tpu_torch.chaos.sites import SITES

        for r in self.rules:
            if any(c in r.pattern for c in "*?["):
                continue  # wildcard: matched at runtime
            site = SITES.get(r.pattern)
            if site is None:
                raise ValueError(
                    f"unknown chaos site {r.pattern!r} (catalog: {sorted(SITES)})"
                )
            if r.kind not in site["kinds"]:
                raise ValueError(
                    f"site {r.pattern!r} does not support kind {r.kind!r} "
                    f"(supported: {sorted(site['kinds'])})"
                )

    # -- the decision ----------------------------------------------------
    def _chance(self, rule_index: int, hit: int, p: float) -> bool:
        if p >= 1.0:
            return True
        if p <= 0.0:
            return False
        h = hashlib.blake2b(
            b"%d:%d" % (rule_index, hit), key=self._key, digest_size=8
        ).digest()
        return int.from_bytes(h, "little") < int(p * 2**64)

    def evaluate(self, site: str, ctx: dict) -> Optional[Fault]:
        for i, r in enumerate(self.rules):
            if not fnmatch.fnmatchcase(site, r.pattern):
                continue
            if r.ctx and any(str(ctx.get(k)) != str(v) for k, v in r.ctx.items()):
                continue
            r.hits += 1
            if r.hits <= r.skip:
                continue  # still inside the skipped prefix of the window
            if r.max_faults and r.faults >= r.max_faults:
                continue
            eligible = r.hits - r.skip  # 1-based position past the skip
            if r.nth:
                fire = eligible == r.nth
            elif r.every:
                fire = eligible % r.every == 0
            else:
                fire = True
            if fire and self._chance(i, r.hits, r.p):
                r.faults += 1
                return Fault(
                    site=site, kind=r.kind, rule_index=i, hit=r.hits,
                    delay_s=r.delay_s, args=r.args,
                )
        return None


# ---------------------------------------------------------------------------
# Process-global plan + gate
# ---------------------------------------------------------------------------

# THE disabled-path check: maybe_inject loads this once and returns. None
# means chaos is off for this process.
_PLAN: Optional[FaultSchedule] = None
_PLAN_JSON: str = ""  # exact spec text installed (re-install dedup)
# Injection log: every fault this process actually injected, in firing order.
# Replay comparisons normalize by (rule, hit) — per-rule subsequences are
# deterministic even when cross-rule wall order interleaves differently.
_LOG: list = []
_LOG_LIMIT = 100_000
_LOG_DROPPED = 0  # counted trim: the log is bounded, loss is observable
# chaos.injected_total{site,kind} counters (plain dict on the injection path;
# promoted to metric records by metrics_series()).
_COUNTS: dict = {}
# Guards install/uninstall AND the armed evaluate/record path (multiple
# event-loop threads share one plan; see maybe_inject).
_LOCK = threading.Lock()


def install(schedule: FaultSchedule) -> None:
    """Arm ``schedule`` for this process. Resets counters and the log —
    installing is the start of a scenario, not a tweak to a live one."""
    global _PLAN, _PLAN_JSON, _LOG_DROPPED
    with _LOCK:
        _PLAN = schedule
        _PLAN_JSON = schedule.to_json()
        _LOG.clear()
        _COUNTS.clear()
        _LOG_DROPPED = 0


def install_from_json(spec_json: str) -> None:
    """Install from a spec JSON string (the config/env propagation path).
    Re-installing the byte-identical spec is a no-op so re-registration
    after a controller restart does not reset live hit counters."""
    if not spec_json:
        return
    with _LOCK:
        if _PLAN is not None and _PLAN_JSON == FaultSchedule.from_spec(spec_json).to_json():
            return
    install(FaultSchedule.from_spec(spec_json))


def uninstall() -> None:
    global _PLAN, _PLAN_JSON
    with _LOCK:
        _PLAN = None
        _PLAN_JSON = ""


def active() -> Optional[FaultSchedule]:
    return _PLAN


def maybe_inject(site: str, **ctx: Any) -> Optional[Fault]:
    """THE chaos gate. Returns None (the common, near-free path) or a
    :class:`Fault` the calling site must apply. Every fault site in the tree
    goes through here — machine-enforced by graftlint rule ``chaos-gate``.

    The armed path takes ``_LOCK``: one process can run several event-loop
    threads against the shared plan (a driver's raytpu-io thread plus an
    in-process cluster's raytpu-services thread both send rpc frames), and
    unsynchronized ``hits += 1`` read-modify-writes would lose/duplicate
    hit numbers — breaking the byte-for-byte replay guarantee the counters
    exist to provide. The disabled path never touches the lock."""
    plan = _PLAN
    if plan is None:
        return None
    with _LOCK:
        fault = plan.evaluate(site, ctx)
        if fault is None:
            return None
        _record(fault, ctx)
    return fault


def _record(fault: Fault, ctx: dict) -> None:
    # Caller (maybe_inject) already holds _LOCK.
    global _LOG_DROPPED
    _COUNTS[(fault.site, fault.kind)] = _COUNTS.get((fault.site, fault.kind), 0) + 1
    entry = {
        "site": fault.site, "kind": fault.kind, "rule": fault.rule_index,
        "hit": fault.hit, "ts": time.time(),
    }
    if ctx:
        entry["ctx"] = {k: str(v) for k, v in ctx.items()}
    _LOG.append(entry)
    if len(_LOG) > _LOG_LIMIT:
        trim = len(_LOG) // 2
        del _LOG[:trim]
        _LOG_DROPPED += trim
    # Inside the affected task/pull span when one is active; no-op otherwise.
    _tracing.event("chaos.injected", site=fault.site, kind=fault.kind, hit=fault.hit)
    # Flight recorder: a worker.death dump must show the kill that caused it
    # (the tracing.event above only lands when a trace is active). Chaos may
    # call out to obs; the chaos-gate lint forbids the reverse direction.
    from ray_tpu_torch.obs import flight as _flight

    _flight.record("chaos.injected", site=fault.site, fault_kind=fault.kind,
                   rule=fault.rule_index, hit=fault.hit)


def injection_log(normalize: bool = False) -> list:
    """The faults this process injected. ``normalize=True`` is the
    replay-comparison shape: wall-clock and ctx fields are stripped (ctx
    carries run-minted ids — node/worker ids differ across runs even for an
    identical injection sequence) and entries sort by (rule, hit), since
    per-rule subsequences are the deterministic unit."""
    entries = list(_LOG)
    if not normalize:
        return entries
    normed = [
        {k: e[k] for k in ("site", "kind", "rule", "hit")}
        for e in entries
    ]
    normed.sort(key=lambda e: (e["rule"], e["hit"]))
    return normed


def log_dropped() -> int:
    return _LOG_DROPPED


def metrics_series() -> list:
    """chaos.injected_total{site,kind} as snapshot()-shaped counter records
    (shipped by the CoreWorker reporter -> controller -> /metrics)."""
    if not _COUNTS and not _LOG_DROPPED:
        return []
    now = time.time()
    with _LOCK:  # snapshot: a concurrent injection must not resize mid-iteration
        counts = sorted(_COUNTS.items())
    out = [
        {
            "name": "chaos.injected_total", "kind": "counter",
            "description": "faults injected by the chaos plane",
            "tags": {"site": site, "kind": kind}, "value": float(n), "ts": now,
        }
        for (site, kind), n in counts
    ]
    if _LOG_DROPPED:
        out.append({
            "name": "events_dropped_total", "kind": "counter",
            "description": "chaos injection-log entries lost to the bounded log",
            "tags": {"where": "chaos_log"}, "value": float(_LOG_DROPPED), "ts": now,
        })
    return out
