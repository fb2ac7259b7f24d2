"""A profiled slice of the window and its reduction.

``TraceSlice`` runs ``torch.profiler`` (CPU and CUDA activities) over a
slice of the measured window, after a synchronize so that no kernel queued
before it runs unrecorded inside it, between two marks (``bench.trace_open``
and ``bench.trace_close``, the latter after a synchronize). The profile is
exported as a Chrome trace under TMPDIR, reduced, and deleted: device
intervals (kernels, copies, sets) clipped to the marks give the busy time
(their union), the kernels' time by name, and the idle gaps, each named
after the innermost host operation that was running at its midpoint.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
OPEN, CLOSE = "bench.trace_open", "bench.trace_close"
NO_HOST_OP = "(no host op)"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [count, seconds]
    device_ops: list  # top 10 [name, seconds]
    idle_gaps: list  # top 10 [host op, seconds]
    diag: dict = dataclasses.field(default_factory=dict)  # what the slice held, for the run's log

    def kernel_time(self, symbol: str):
        """(launches, seconds) of the kernels whose name contains ``symbol``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if symbol in name:
                n += count
                s += secs
        return n, s


def _union(intervals):
    """Merged, sorted list of [start, end] from possibly overlapping ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _attribute(gaps, host):
    """For each gap (start, end), the innermost host event (start, end,
    name) that contains its midpoint, by a sweep over both sorted lists."""
    host = sorted(host)
    names = []
    active = []  # heap of (duration, end, name)
    j = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            s, e, n = host[j]
            heapq.heappush(active, (e - s, e, n))
            j += 1
        # Innermost = shortest among those still running at mid; events
        # that ended are dropped lazily as they surface.
        while active and active[0][1] < mid:
            heapq.heappop(active)
        names.append(active[0][2] if active else NO_HOST_OP)
    return names


def summarize_events(events, top: int = 10) -> TraceSummary:
    """Reduces Chrome-trace events (dicts with ph, cat, name, ts, dur in
    microseconds) to a TraceSummary."""
    dev, host, marks = [], [], {}
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((ts, end, name))
        elif cat in HOST_CATS:
            if name in (OPEN, CLOSE):
                marks[name] = ts
                continue
            host.append((ts, end, name))
        else:
            continue
        lo, hi = min(lo, ts), max(hi, end)
    t0, t1 = marks.get(OPEN, lo), marks.get(CLOSE, hi)
    if not t1 > t0:
        return TraceSummary(0.0, 0.0, {}, [], [])
    clipped = [(max(a, t0), min(b, t1), n) for a, b, n in dev if b > t0 and a < t1]
    kernels: dict = {}
    for a, b, n in clipped:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in clipped])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    by_name: dict = {}
    for (a, b), n in zip(gaps, _attribute(gaps, host)):
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    device_ops = sorted(([n, s] for n, (_, s) in kernels.items()), key=lambda x: -x[1])[:top]
    idle = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top]
    return TraceSummary((t1 - t0) * 1e-6, busy_s, kernels, device_ops, idle)


class TraceSlice:
    """Profiles from ``start()`` to ``stop()``; ``reduce()`` (after the
    window, on any thread) exports and summarizes the profile. ``active`` is
    true in between start and stop, for hooks that record what the slice's
    launches need (their bounds). The profiler records the host operations
    of every thread where the installed PyTorch offers it, and of the thread
    that starts it otherwise: start it from the thread that launches the
    work."""

    def __init__(self):
        self.active = False
        self.summary = None
        self.diag = {}
        self._prof = None

    def start(self):
        import torch

        torch.cuda.synchronize()
        kw = {}
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self.diag["all_threads"] = True
        except (AttributeError, TypeError):
            self.diag["all_threads"] = False
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA], **kw)
        self._prof.start()
        with torch.profiler.record_function(OPEN):
            pass
        self.active = True
        self._t = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        with torch.profiler.record_function(CLOSE):
            pass
        self.diag["host_slice_s"] = time.perf_counter() - self._t
        self.active = False
        self._prof.stop()

    def reduce(self):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            self.diag["trace_bytes"] = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        cats: dict = {}
        for e in events:
            if e.get("ph") == "X":
                c = cats.setdefault(str(e.get("cat", "")), [0, float("inf"), float("-inf")])
                c[0] += 1
                c[1] = min(c[1], float(e["ts"]))
                c[2] = max(c[2], float(e["ts"]) + float(e.get("dur", 0.0)))
        self.diag["categories"] = {k: [v[0], round((v[2] - v[1]) * 1e-6, 6)] for k, v in cats.items()}
        self.diag["marks"] = [e["name"] for e in events if e.get("name") in (OPEN, CLOSE)]
        self.summary = summarize_events(events)
        self.diag["reduce_s"] = time.perf_counter() - t0
        self.summary.diag = self.diag
        return self.summary


def warm_up():
    """One profiled no-op, so the profiler's first start (CUPTI's set-up,
    seconds long) falls in the set-up of a traced run and not in its window."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Schedule:
    """When, within a window of ``seconds`` that opens at ``t0``, the traced
    slice runs: from ``start_frac`` of the window, for ``seconds`` of the
    spec (at most a third of the window) counted from when the profiler is
    running. ``overhead_s`` is the host time spent starting and stopping
    it, which the entries take out of their windows."""

    def __init__(self, t0: float, seconds: float, spec: dict, enabled: bool):
        self.enabled = enabled
        self.length = min(spec.get("seconds", 4.0), seconds / 3.0)
        self.begin = t0 + spec.get("start_frac", 0.4) * seconds
        self.last_start = t0 + seconds - self.length
        self.end = float("inf")
        self.overhead_s = 0.0
        self.held = None  # [from, to]: host time from the profiler's start to its stop's return
        self.slice = TraceSlice() if enabled else None

    def poll(self, now: float) -> None:
        """Starts or stops the slice when its time has come."""
        if not self.enabled:
            return
        if self.slice._prof is None and self.begin <= now <= self.last_start:
            self.held = [now, float("inf")]
            self.slice.start()
            t = time.perf_counter()
            self.overhead_s += t - now
            self.end = t + self.length
        elif self.slice.active and now >= self.end:
            self.slice.stop()
            self.held[1] = time.perf_counter()
            self.overhead_s += self.held[1] - now

    def overlaps(self, a: float, b: float) -> bool:
        """Whether host time [a, b] meets the profiled slice or its start and
        stop (which hold the thread that runs them)."""
        return self.held is not None and a <= self.held[1] and b >= self.held[0]

    def finish(self):
        """After the window: stops a slice still running, then reduces it."""
        if not self.enabled or self.slice._prof is None:
            return None
        if self.slice.active:
            self.slice.stop()
        return self.slice.reduce()

    @property
    def active(self) -> bool:
        return bool(self.enabled and self.slice.active)
