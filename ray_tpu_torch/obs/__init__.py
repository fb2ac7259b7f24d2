"""Production observability plane: flight recorder, SLO engine, autopsy,
continuous profiler.

Four pillars on top of the raw signals the runtime already emits — traces =
structure, metrics = rates, flight = evidence, profiles = cost:

  obs.flight    per-process black-box ring, dumped on death/invariant/
                storm/preempt/manual triggers (closed TRIGGERS catalog)
  obs.slo       declarative objectives + SRE multi-window burn-rate alerts,
                evaluated on the controller from the merged reporter series
  obs.autopsy   per-request critical-path hop decomposition + per-deployment
                "where does p99 go" aggregation
  obs.health    event-loop lag probe per process, thread dump on spikes
  obs.profiler  always-on wall-clock sampler per process with per-plane cost
                attribution; on-demand / alert-triggered / per-trace capture,
                merged into one cluster flamegraph (obs.stacks is the shared
                frame walker/renderer underneath)

Driver-facing helpers (`slo_register`, `profile_cluster` et al) live here;
the pillars are woven through worker/controller/serve/qos/chaos — see
README "Production observability" and "Continuous profiling"."""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch.obs import autopsy, flight, health, profiler, slo, stacks  # noqa: F401


def slo_register(spec: dict) -> dict:
    """Register (or replace) one SLO objective on the controller. Spec
    format: see obs/slo.py module docstring."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("slo_register", {"spec": spec}))


def slo_unregister(name: str) -> bool:
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("slo_unregister", {"name": name}))


def slo_status() -> list[dict]:
    """Status rows for every registered objective (state, burn rates)."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("slo_status", {}))


def slo_history() -> dict:
    """Burn-rate trajectory per objective: {name: {points: [{ts, burn_fast,
    burn_slow, state}], dropped}} — the arc, not just the final state."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("slo_history", {}))


def trace_autopsy(trace_id: str) -> dict:
    """Critical-path hop decomposition of one indexed trace."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    return core._run(core.controller.call("trace_autopsy", {"trace_id": trace_id}))


def autopsy_summary() -> dict:
    """Per-deployment aggregated hop breakdown across indexed traces."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    return core._run(core.controller.call("autopsy_summary", {}))


def collect_flight_trace(trace_id: str) -> dict:
    """Reassemble a FULL trace from every live per-process flight recorder
    (plus whatever the controller index still holds) — works even after the
    bounded trace index evicted it. Returns {events, sources, evicted}."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    core._run(core._flush_task_events())
    res = core._run(core.controller.call(
        "collect_flight_trace", {"trace_id": trace_id}))
    # The driver's own recorder is not behind any daemon: merge it here.
    local = flight.recorder().events_for_trace(trace_id)
    if local:
        res["events"] = _merge_events(res.get("events", []), local)
        res["sources"] = res.get("sources", 0) + 1
    return res


def profile_cluster(window_s: float = 60.0, seconds: Optional[float] = None,
                    trace_id: str = "", node_id: str = "",
                    max_stacks: int = 0) -> dict:
    """One merged cluster flamegraph fold: the controller fans out to every
    live daemon (which fans out to ITS workers, memory_summary-style), and
    the driver's own sampler joins here when its process isn't already
    behind the head (merge_folds dedups by proc id, so in-process heads
    never double count). Modes: default = recent window; ``seconds`` = live
    capture of that length on every process; ``trace_id`` = that trace's
    per-process accumulators only."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    req: dict = {}
    if trace_id:
        req["trace_id"] = trace_id
    elif seconds:
        req["seconds"] = float(seconds)
    else:
        req["window_s"] = float(window_s)
    if node_id:
        req["node_id"] = node_id
    if max_stacks:
        req["max_stacks"] = int(max_stacks)
    timeout = (float(seconds) if seconds else 0.0) + 30.0
    merged = core._run(core.controller.call("profile_collect", req, timeout=timeout))
    local = profiler.sampler()
    if (not node_id) and local.proc not in (merged.get("procs") or []):
        # Driver not behind any daemon (and not the head process): its own
        # fold joins the merge here, same as collect_flight_trace does for
        # the driver's flight ring.
        mine = profiler.local_fold(req)
        out = profiler.merge_folds(
            [merged, mine],
            max_stacks=int(max_stacks) or profiler.DEFAULT_MAX_STACKS)
        for k in ("window_s", "duration_s", "trace_id", "errors"):
            if k in merged:
                out[k] = merged[k]
        out["procs"] = (merged.get("procs") or []) + [local.proc]
        return out
    return merged


def profile_status() -> dict:
    """Cluster profiler rollup: per-process sampler status rows + the
    aggregate that backs `raytpu status` and /api/profile?summary=1."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    out = core._run(core.controller.call("profile_collect", {"status": 1}))
    rows = out.get("statuses") or []
    local = profiler.sampler()
    if all(r.get("proc") != local.proc for r in rows if isinstance(r, dict)):
        rows = rows + [profiler.status()]
        out["statuses"] = rows
        out["aggregate"] = profiler.aggregate_status(rows)
    return out


def profile_incidents() -> dict:
    """Alert-triggered capture registry: the merged cluster flamegraphs the
    controller snapshotted on SLO burn alerts (bounded, counted)."""
    from ray_tpu_torch.core import api

    core = api._require_worker()
    return core._run(core.controller.call("profile_incidents", {}))


def _merge_events(a: list[dict], b: list[dict]) -> list[dict]:
    """Merge + dedup two event lists (same event can sit in the controller
    index AND a recorder ring); identity is the stamped tuple every emitter
    fills."""
    seen = set()
    out = []
    for ev in list(a) + list(b):
        key = (ev.get("ts"), ev.get("kind"), ev.get("worker", ""),
               ev.get("span_id", ""), ev.get("task_id", ""), ev.get("name", ""))
        if key in seen:
            continue
        seen.add(key)
        out.append(ev)
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out
