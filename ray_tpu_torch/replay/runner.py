"""Open-loop trace replayer against the serve HTTP ingress.

Open loop means arrival-faithful: request *i* fires at ``t0 + t_i /
time_warp`` whether or not earlier requests completed — a saturated server
sees the full offered load and must shed, exactly like production (a
closed-loop client would politely back off and hide the overload). Each
record maps onto the QoS ingress the proxy already speaks::

    x-priority          <- record cls
    x-tenant            <- record tenant
    x-request-timeout-s <- record timeout_s (scaled by the warp)
    x-stream: 1         <- record stream (the deployment answers chunked)

Per-request outcomes (status, latency, TTFT for streams, scheduling error)
feed the run ledger (obs/ledger.py). A chaos gate ``replay.request.send``
sits on the send path so a timeline can inject client-side network flap
(drops/delays) with the same seeded determinism as every other site — the
replayer is part of the system under replay, not an outside observer.
"""
from __future__ import annotations

import concurrent.futures
import http.client
import time
from typing import Optional

from ray_tpu_torch import chaos as _chaos


def percentile(values: list, q: float) -> Optional[float]:
    """Nearest-rank percentile of an unsorted list (None when empty)."""
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(len(vals) * q))]


class Replayer:
    """Fire one trace at a live proxy port. ``time_warp`` > 1 compresses
    trace time (quick mode: a 16 s trace replays in 8 s at warp 2); client
    timeouts are scaled down by the same factor so deadline behaviour is
    warp-invariant."""

    def __init__(self, port: int, *, host: str = "127.0.0.1",
                 time_warp: float = 1.0, max_workers: int = 24,
                 connect_timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.time_warp = float(time_warp)
        self.max_workers = int(max_workers)
        self.connect_timeout_s = float(connect_timeout_s)

    # -- one request ------------------------------------------------------
    def _fire(self, rec: dict, t0: float) -> dict:
        sched = t0 + rec["t"] / self.time_warp
        out = {"i": rec["i"], "cls": rec["cls"], "tenant": rec["tenant"],
               "t": rec["t"], "stream": rec.get("stream", 0),
               "code": -1, "latency_s": 0.0, "ttft_s": None, "late_s": 0.0}
        fault = _chaos.maybe_inject("replay.request.send",
                                    cls=rec["cls"], tenant=rec["tenant"])
        if fault is not None:
            if fault.kind == "drop":
                out["code"] = 0  # client-side loss: never reached the wire
                return out
            time.sleep(fault.delay_s)
        send = time.perf_counter()
        out["late_s"] = round(send - sched, 6)
        timeout = max(0.2, rec["timeout_s"] / self.time_warp)
        headers = {
            "x-priority": rec["cls"],
            "x-tenant": rec["tenant"],
            "x-request-timeout-s": f"{timeout:g}",
            "content-type": "application/json",
        }
        if rec.get("stream"):
            headers["x-stream"] = "1"
        body = b"x" * int(rec.get("size", 0))
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.connect_timeout_s)
        try:
            conn.request("POST", rec.get("route", "/"), body=body,
                         headers=headers)
            resp = conn.getresponse()
            out["code"] = resp.status
            first = resp.read(1)  # returns with the first body chunk
            if rec.get("stream") and resp.status == 200 and first:
                out["ttft_s"] = round(time.perf_counter() - send, 6)
            resp.read()
        except Exception:
            out["code"] = -1  # transport-level failure (counted, never raised)
        finally:
            conn.close()
        out["latency_s"] = round(time.perf_counter() - send, 6)
        return out

    # -- the open loop ----------------------------------------------------
    def run(self, header: dict, records: list) -> list:
        """Replay every record at its scheduled arrival; returns the outcome
        list in record order. The dispatcher thread only sleeps + submits;
        sends run on a bounded pool (a slow server delays *responses*, not
        later *arrivals* — until the client itself runs out of senders,
        which is the open-loop client-capacity limit and is visible in the
        recorded ``late_s``)."""
        outcomes: list = [None] * len(records)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="raytpu-replay") as pool:
            futs = []
            for rec in records:
                delay = t0 + rec["t"] / self.time_warp - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futs.append((rec["i"], pool.submit(self._fire, rec, t0)))
            for i, fut in futs:
                outcomes[i] = fut.result()
        return outcomes


def summarize(outcomes: list, phases: Optional[dict] = None) -> dict:
    """Fold raw outcomes into per-class (x tenant, x phase) stat buckets —
    the shape the ledger embeds. ``phases`` maps name -> (t0, t1) in trace
    seconds; a record belongs to the phase its *arrival* falls in."""
    def bucket(rows: list) -> dict:
        ok = [r for r in rows if r["code"] == 200]
        lat = [r["latency_s"] for r in ok]
        ttft = [r["ttft_s"] for r in ok if r["ttft_s"] is not None]
        n = len(rows)
        return {
            "n": n,
            "ok": len(ok),
            "goodput": round(len(ok) / n, 4) if n else None,
            "shed": sum(1 for r in rows if r["code"] == 429),
            "expired": sum(1 for r in rows if r["code"] == 504),
            "errors": sum(1 for r in rows if r["code"] in (-1, 500)),
            "client_dropped": sum(1 for r in rows if r["code"] == 0),
            "p50_s": percentile(lat, 0.50),
            "p95_s": percentile(lat, 0.95),
            "p99_s": percentile(lat, 0.99),
            "ttft_p95_s": percentile(ttft, 0.95),
            "late_p99_s": percentile([r["late_s"] for r in rows], 0.99),
        }

    rows = [r for r in outcomes if r is not None]
    out: dict = {"total": bucket(rows), "classes": {}}
    for cls in sorted({r["cls"] for r in rows}):
        crows = [r for r in rows if r["cls"] == cls]
        entry: dict = {"_total": bucket(crows), "tenants": {}, "phases": {}}
        for tenant in sorted({r["tenant"] for r in crows}):
            entry["tenants"][tenant] = bucket(
                [r for r in crows if r["tenant"] == tenant])
        for name, (lo, hi) in (phases or {}).items():
            entry["phases"][name] = bucket(
                [r for r in crows if lo <= r["t"] < hi])
        out["classes"][cls] = entry
    return out
