"""Versioned workload-trace format + seeded synthesizer.

A trace is the replay plane's unit of record: one JSONL file whose first
line is a header and whose remaining lines are per-request records sorted
by arrival offset. The serialization is CANONICAL (sorted keys, no
whitespace, fixed float rounding), so the same header + records always
produce the same bytes — and the synthesizer below is a pure function of
its seed + params, so ``synthesize(seed) -> write_trace`` is byte-identical
across runs and platforms. That byte identity is the replay contract's
first half (the chaos plane's seeded FaultSchedule is the second): a
day-in-the-life run is reproducible from ONE integer.

Header (line 1)::

    {"format": "raytpu-trace", "version": 1, "seed": 0,
     "duration_s": 16.0, "requests": 412,
     "classes": {"interactive": 91, ...}, "tenants": {"t0": 202, ...},
     "params": {...synthesizer params...}}

Record (one per line, sorted by ``t``)::

    {"i": 0, "t": 0.013, "cls": "interactive", "tenant": "t0",
     "route": "/day", "size": 186, "stream": 1, "timeout_s": 2.0}

``t`` is the arrival offset in seconds from replay start, ``size`` the
request payload in bytes (a prompt-size proxy), ``stream`` whether the
client expects a chunked token stream (TTFT is recorded for these), and
``timeout_s`` the client deadline the replayer maps onto the
``x-request-timeout-s`` ingress header.

The synthesizer shapes the mix after a production day compressed into the
trace window: a diurnal envelope (calm -> spike -> recovery), Zipf tenant
skew (a few tenants dominate), and a streaming/batch blend per QoS class.
"""
from __future__ import annotations

import hashlib
import json
import random
from typing import Optional

FORMAT = "raytpu-trace"
VERSION = 1

# Class mix: (weight, timeout_s, stream probability, payload lognormal mu).
# interactive = the protected foreground; batch = throughput lane;
# best_effort = the floodable background that the storm multiplies.
_CLASSES = {
    "interactive": {"weight": 0.25, "timeout_s": 2.0, "p_stream": 0.4, "size_mu": 5.0},
    "batch": {"weight": 0.25, "timeout_s": 1.5, "p_stream": 0.0, "size_mu": 7.0},
    "best_effort": {"weight": 0.5, "timeout_s": 1.0, "p_stream": 0.0, "size_mu": 5.5},
}


def default_params(quick: bool = False) -> dict:
    """The day_in_the_life scenario's synthesizer params (shared with the
    canonical committed artifact so tests can assert the generator never
    drifts). Trace time is pre-warp: quick mode replays at time_warp 2."""
    if quick:
        return {"duration_s": 16.0, "base_rps": 26.0, "spike_mult": 3.0,
                "spike_start": 0.35, "spike_end": 0.7, "tenants": 4,
                "zipf_alpha": 1.2, "route": "/day"}
    return {"duration_s": 45.0, "base_rps": 40.0, "spike_mult": 3.0,
            "spike_start": 0.35, "spike_end": 0.7, "tenants": 6,
            "zipf_alpha": 1.2, "route": "/day"}


def envelope(frac: float, spike_start: float, spike_end: float,
             spike_mult: float) -> float:
    """Diurnal rate multiplier at ``frac`` of the trace (0..1): 1.0 on the
    calm shoulders, ``spike_mult`` across the spike window, with short
    linear ramps (10% of the window each side) so the storm has an onset
    the autoscaler/SLO trajectory can be read against."""
    ramp = max(1e-6, 0.1 * (spike_end - spike_start))
    if frac < spike_start or frac >= spike_end:
        return 1.0
    up = min(1.0, (frac - spike_start) / ramp)
    down = min(1.0, (spike_end - frac) / ramp)
    return 1.0 + (spike_mult - 1.0) * min(up, down)


def phase_spans(params: dict) -> dict:
    """The three named phases in TRACE seconds — the anchor space the chaos
    timeline and the ledger's per-phase stats both use."""
    d = float(params["duration_s"])
    s0, s1 = params["spike_start"] * d, params["spike_end"] * d
    return {"calm": (0.0, s0), "storm": (s0, s1), "recovery": (s1, d)}


def synthesize(seed: int, *, duration_s: float, base_rps: float,
               spike_mult: float = 3.0, spike_start: float = 0.35,
               spike_end: float = 0.7, tenants: int = 4,
               zipf_alpha: float = 1.2, route: str = "/day") -> tuple[dict, list]:
    """Pure function of (seed, params) -> (header, records). Arrivals are an
    inhomogeneous Poisson process via thinning (exponential inter-arrivals
    at the peak rate, accepted with probability rate(t)/peak); tenant draws
    are Zipf-weighted; class/stream/size/jitter all come from the same
    seeded generator, so the whole trace replays from one integer."""
    rng = random.Random(seed)
    peak = base_rps * spike_mult
    tenant_names = [f"t{i}" for i in range(tenants)]
    tenant_w = [1.0 / (i + 1) ** zipf_alpha for i in range(tenants)]
    classes = sorted(_CLASSES)
    class_w = [_CLASSES[c]["weight"] for c in classes]
    records = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() >= envelope(t / duration_s, spike_start, spike_end,
                                    spike_mult) / spike_mult:
            continue  # thinned: instantaneous rate below peak
        cls = rng.choices(classes, weights=class_w)[0]
        spec = _CLASSES[cls]
        records.append({
            "i": len(records),
            "t": round(t, 6),
            "cls": cls,
            "tenant": rng.choices(tenant_names, weights=tenant_w)[0],
            "route": route,
            "size": max(16, int(rng.lognormvariate(spec["size_mu"], 0.6))),
            "stream": 1 if rng.random() < spec["p_stream"] else 0,
            "timeout_s": round(spec["timeout_s"] * rng.uniform(0.9, 1.1), 3),
        })
    by_cls: dict = {}
    by_tenant: dict = {}
    for r in records:
        by_cls[r["cls"]] = by_cls.get(r["cls"], 0) + 1
        by_tenant[r["tenant"]] = by_tenant.get(r["tenant"], 0) + 1
    header = {
        "format": FORMAT, "version": VERSION, "seed": int(seed),
        "duration_s": round(float(duration_s), 6), "requests": len(records),
        "classes": by_cls, "tenants": by_tenant,
        "params": {"base_rps": base_rps, "spike_mult": spike_mult,
                   "spike_start": spike_start, "spike_end": spike_end,
                   "tenants": tenants, "zipf_alpha": zipf_alpha,
                   "route": route},
    }
    return header, records


def _canon(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def dumps_trace(header: dict, records: list) -> bytes:
    """Canonical bytes for a trace: the byte-identity surface."""
    lines = [_canon(header)] + [_canon(r) for r in records]
    return ("\n".join(lines) + "\n").encode()


def write_trace(path: str, header: dict, records: list) -> str:
    """Write the canonical JSONL file; returns its sha256 hex digest (the
    ledger embeds it so a report names exactly the trace that produced it)."""
    blob = dumps_trace(header, records)
    with open(path, "wb") as f:
        f.write(blob)
    return hashlib.sha256(blob).hexdigest()


def trace_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def read_trace(path: str) -> tuple[dict, list]:
    """Parse + validate one trace file -> (header, records)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"trace {path!r} is empty")
    header = json.loads(lines[0])
    if header.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} file: {header.get('format')!r}")
    if int(header.get("version", -1)) > VERSION:
        raise ValueError(
            f"trace version {header.get('version')} is newer than this "
            f"reader (max {VERSION})")
    records = [json.loads(ln) for ln in lines[1:]]
    if len(records) != int(header.get("requests", len(records))):
        raise ValueError(
            f"trace header promises {header.get('requests')} requests, "
            f"file holds {len(records)}")
    last = -1.0
    for r in records:
        if r["t"] < last:
            raise ValueError(f"record {r['i']} out of arrival order")
        last = r["t"]
    return header, records
