"""Continuous profiling & cost attribution: the fourth leg of the obs plane.

Traces say what a request did, metrics say how often, the flight recorder
holds the evidence — this module says WHERE THE CYCLES WENT. Every core
process runs an always-on wall-clock sampler: a daemon thread walks
``sys._current_frames()`` at ``Config.profile_hz`` (default ~19 Hz — a
prime-ish rate so the sampler never phase-locks onto 10/20/50 ms periodic
work) and folds each thread's stack into a bounded, counted collapsed-stack
accumulator. Each sample is also bucketed into ONE cost plane
(obs/stacks.plane_of): serve / collective / data / rpc / exec / core /
idle / app — so the cost split that bubble-fraction and stall-ratio
metrics need falls out of the same stream.

Three capture surfaces sit on the sampler:

  window    the last N seconds, assembled from a bounded epoch ring — what
            alert-triggered capture snapshots (SLO burn alerts on the
            controller, ``qos.deadline_storm`` flight dumps in-process) so
            an incident artifact carries its own flamegraph
  session   on-demand bounded captures (``raytpu profile --seconds N``,
            the worker's ``profile_cpu`` RPC) and device captures
            (``tracing.profile_tpu`` routes through ``device_capture`` so
            there is ONE entry point for device profiling, typed-and-loud
            on hosts with no TPU/GPU backend)
  per-trace the tracing hook (``tracing.set_profile_hook``) maps executor
            threads to their active trace id while a traced exec span runs,
            so one slow request's exec hop gets its own profile — untraced
            work pays nothing (the hook only fires on ``activate`` with a
            real context)

Folds are plain dicts ``{proc, samples, samples_dropped, stacks{stack:n},
planes{plane:n}, stacks_evicted}`` that merge associatively
(``merge_folds`` dedups by proc id), so worker -> daemon -> controller ->
driver aggregation reuses one shape end to end; ``to_collapsed`` /
``to_tree`` render any fold as flamegraph.pl text or a JSON flame tree
(/api/profile, ``raytpu profile render``).

Cost contract: disarmed, nothing runs and ``tracing.activate`` pays one
module-global read on traced paths only. Armed but idle, the entire cost
is the sampler thread's own tick (bench_core ``detail.profiler_overhead``
holds this within noise).
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from typing import Optional

from ray_tpu_torch.obs import stacks as _stacks
from ray_tpu_torch.util import tracing as _tracing

# Default sampling rate: deliberately NOT a divisor of common timer periods
# (100ms heartbeats, 250ms probes) so periodic work can't hide between ticks.
DEFAULT_HZ = 19.0
DEFAULT_MAX_STACKS = 2048
DEFAULT_EPOCH_S = 5.0
DEFAULT_WINDOW_EPOCHS = 24  # ~2 minutes of window at the default epoch
DEFAULT_MAX_TRACES = 64
MAX_TRACE_STACKS = 256  # per-trace accumulators are smaller: one request
MAX_SESSIONS = 4  # concurrent capture sessions per process
MAX_CAPTURE_S = 30.0
MAX_FRAMES = 64


class ProfilerBusy(RuntimeError):
    """Too many concurrent capture sessions in this process (bound:
    MAX_SESSIONS) — captures are cheap but not free; queue, don't pile."""


class DeviceProfilerUnavailable(RuntimeError):
    """Device (GPU) profiling requested on a host without that backend —
    raised loudly at session start, never an AttributeError mid-capture."""


# ---------------------------------------------------------------------------
# fold accumulator
# ---------------------------------------------------------------------------
class Profile:
    """Bounded counted collapsed-stack accumulator (NOT thread-safe; the
    owner locks). Invariant: ``samples - samples_dropped == sum(stacks)``
    and ``samples == sum(planes)`` — totals stay truthful even when the
    distinct-stack table hits its bound (counted, never silent)."""

    __slots__ = ("max_stacks", "stacks", "planes", "samples",
                 "samples_dropped", "stacks_evicted")

    def __init__(self, max_stacks: int = DEFAULT_MAX_STACKS):
        self.max_stacks = max(1, int(max_stacks))
        self.stacks: dict[str, int] = {}
        self.planes: dict[str, int] = {}
        self.samples = 0
        self.samples_dropped = 0  # counted trim: samples whose stack was full-table-rejected
        self.stacks_evicted = 0   # distinct stacks rejected by the bound

    def add(self, stack: str, plane: str, n: int = 1):
        self.samples += n
        self.planes[plane] = self.planes.get(plane, 0) + n
        cur = self.stacks.get(stack)
        if cur is not None:
            self.stacks[stack] = cur + n
        elif len(self.stacks) < self.max_stacks:
            self.stacks[stack] = n
        else:
            self.stacks_evicted += 1
            self.samples_dropped += n

    def merge(self, fold: dict):
        """Fold another accumulator's fold in (biggest stacks first, so the
        bound keeps the hot path when the union overflows)."""
        if not fold:
            return
        self.samples += int(fold.get("samples", 0))
        self.samples_dropped += int(fold.get("samples_dropped", 0))
        self.stacks_evicted += int(fold.get("stacks_evicted", 0))
        for plane, n in (fold.get("planes") or {}).items():
            self.planes[plane] = self.planes.get(plane, 0) + int(n)
        items = sorted((fold.get("stacks") or {}).items(), key=lambda kv: -kv[1])
        for stack, n in items:
            n = int(n)
            cur = self.stacks.get(stack)
            if cur is not None:
                self.stacks[stack] = cur + n
            elif len(self.stacks) < self.max_stacks:
                self.stacks[stack] = n
            else:
                self.stacks_evicted += 1
                self.samples_dropped += n

    def fold(self) -> dict:
        return {
            "samples": self.samples,
            "samples_dropped": self.samples_dropped,
            "stacks_evicted": self.stacks_evicted,
            "stacks": dict(self.stacks),
            "planes": dict(self.planes),
        }


def merge_folds(folds: list, max_stacks: int = DEFAULT_MAX_STACKS) -> dict:
    """Merge per-process folds into one (the cluster flamegraph), deduping
    by proc id — in-process topologies (head==driver, co-resident daemons)
    share one sampler and must not double count."""
    out = Profile(max_stacks)
    procs: list[str] = []
    seen: set[str] = set()
    for f in folds:
        if not isinstance(f, dict) or "stacks" not in f:
            continue
        proc = str(f.get("proc") or "")
        if proc:
            if proc in seen:
                continue
            seen.add(proc)
            procs.append(proc)
        out.merge(f)
    merged = out.fold()
    merged["procs"] = procs
    return merged


# ---------------------------------------------------------------------------
# renderers (shared by /api/profile, the CLI, and `raytpu profile render`)
# ---------------------------------------------------------------------------
def to_collapsed(fold: dict) -> str:
    """Flamegraph.pl collapsed-stack text: ``frame;frame;frame count``,
    hottest first — pipe straight into flamegraph.pl / speedscope."""
    items = sorted((fold.get("stacks") or {}).items(), key=lambda kv: (-kv[1], kv[0]))
    return "".join(f"{stack} {n}\n" for stack, n in items)


def to_tree(fold: dict) -> dict:
    """Nested flame tree ``{name, value, children: [...]}`` (d3-flame-graph
    shape) — the JSON twin of the collapsed text."""
    root: dict = {"name": "all", "value": 0, "children": {}}
    for stack, n in (fold.get("stacks") or {}).items():
        n = int(n)
        root["value"] += n
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = node["children"][frame] = {"name": frame, "value": 0, "children": {}}
            child["value"] += n
            node = child

    def _listify(node: dict):
        kids = sorted(node["children"].values(), key=lambda c: -c["value"])
        node["children"] = kids
        for c in kids:
            _listify(c)

    _listify(root)
    return root


def top_frames(fold: dict, k: int = 10) -> list[tuple[str, int]]:
    """Hottest LEAF frames (self time) — the CLI's one-glance answer."""
    leaves: dict[str, int] = {}
    for stack, n in (fold.get("stacks") or {}).items():
        leaf = stack.rsplit(";", 1)[-1]
        leaves[leaf] = leaves.get(leaf, 0) + int(n)
    return sorted(leaves.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def plane_split(fold: dict) -> list[tuple[str, float]]:
    """(plane, fraction) rows, largest first — the cost-attribution answer."""
    planes = fold.get("planes") or {}
    total = sum(planes.values()) or 1
    return sorted(((p, n / total) for p, n in planes.items()),
                  key=lambda kv: -kv[1])


# ---------------------------------------------------------------------------
# capture rate limiter (alert-triggered captures)
# ---------------------------------------------------------------------------
class CaptureLimiter:
    """One capture per trigger key per window — an alert storm must not turn
    the profiler into the incident. Mirrors the flight recorder's
    ``_DUMP_MIN_INTERVAL_S`` discipline; suppressions are counted."""

    def __init__(self, min_interval_s: float = 2.0):
        self.min_interval_s = float(min_interval_s)
        self.suppressed = 0
        self.keys_evicted = 0
        self._last: dict[str, float] = {}

    def allow(self, key: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        last = self._last.get(key)
        if last is not None and now - last < self.min_interval_s:
            self.suppressed += 1
            return False
        self._last.pop(key, None)
        self._last[key] = now
        while len(self._last) > 256:
            self._last.pop(next(iter(self._last)))
            self.keys_evicted += 1
        return True


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
class Sampler:
    """One per-process continuous wall-clock sampler. All mutable state is
    guarded by one lock; the sampler thread, executor threads (per-trace
    hooks), and RPC handlers all cross here."""

    def __init__(self, hz: float = 0.0, max_stacks: int = DEFAULT_MAX_STACKS,
                 epoch_s: float = DEFAULT_EPOCH_S,
                 window_epochs: int = DEFAULT_WINDOW_EPOCHS,
                 max_traces: int = DEFAULT_MAX_TRACES, proc: str = ""):
        self._lock = threading.Lock()
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.epoch_s = float(epoch_s)
        self.max_traces = int(max_traces)
        self.proc = proc or f"pid{os.getpid()}"
        self.total = Profile(self.max_stacks)
        self._epoch = Profile(self.max_stacks)
        self._epoch_start = time.time()
        # Bounded epoch ring: (start_ts, end_ts, fold). Overflow drops the
        # oldest epoch — counted in _rotate (epochs_dropped), never silent.
        self._epochs: collections.deque = collections.deque(
            maxlen=max(1, int(window_epochs)))
        self.epochs_dropped = 0
        self.ticks = 0
        self.errors = 0
        # Per-trace accumulators + the thread->trace map the sampler consults.
        self._traces: dict[str, Profile] = {}
        self.traces_evicted = 0
        self._trace_threads: dict[int, str] = {}
        # Capture sessions (cpu + device), bounded.
        self._sessions: dict[int, dict] = {}
        self._next_session = 0
        self.sessions_started = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def configure(self, hz=None, max_stacks=None, epoch_s=None,
                  window_epochs=None, max_traces=None, proc=None):
        with self._lock:
            if hz is not None:
                self.hz = float(hz)
            if max_stacks is not None and int(max_stacks) != self.max_stacks:
                self.max_stacks = int(max_stacks)
                self.total.max_stacks = self.max_stacks
                self._epoch.max_stacks = self.max_stacks
            if epoch_s is not None:
                self.epoch_s = max(0.25, float(epoch_s))
            if window_epochs is not None and (
                    int(window_epochs) != self._epochs.maxlen):
                keep = collections.deque(self._epochs,
                                         maxlen=max(1, int(window_epochs)))
                self.epochs_dropped += max(0, len(self._epochs) - len(keep))
                self._epochs = keep
            if max_traces is not None:
                self.max_traces = int(max_traces)
            if proc:
                self.proc = proc

    def start(self):
        """Start (or restart) the sampler thread; idempotent. hz <= 0 means
        disarmed: any running thread is stopped instead."""
        if self.hz <= 0:
            self.stop()
            return
        t = self._thread
        if t is not None and t.is_alive():
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="raytpu-profiler", daemon=True)
        self._thread.start()

    def stop(self):
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self):
        me = threading.get_ident()
        interval = 1.0 / max(0.5, self.hz)
        while not self._stop.wait(interval):
            try:
                self._sample_once(me)
            except Exception:
                self.errors += 1  # never let one bad tick kill the sampler
            interval = 1.0 / max(0.5, self.hz)

    # -- sampling ----------------------------------------------------------
    def _sample_once(self, me: int):
        frames = sys._current_frames()
        now = time.time()
        with self._lock:
            if now - self._epoch_start >= self.epoch_s:
                self._rotate(now)
            self.ticks += 1
            for ident, frame in frames.items():
                if ident == me:
                    continue  # never profile the profiler
                recs = _stacks.frame_records(frame, MAX_FRAMES)
                stack = _stacks.collapse(recs)
                plane = _stacks.plane_of(recs)
                self.total.add(stack, plane)
                self._epoch.add(stack, plane)
                tid = self._trace_threads.get(ident)
                if tid is not None:
                    prof = self._traces.get(tid)
                    if prof is not None:
                        prof.add(stack, plane)
                for sess in self._sessions.values():
                    acc = sess.get("acc")
                    if acc is not None:
                        acc.add(stack, plane)

    def _rotate(self, now: float):
        # Caller holds the lock. Ring overflow displaces the oldest epoch:
        # counted here because deque(maxlen) drops silently on append.
        if self._epoch.samples:
            if len(self._epochs) == self._epochs.maxlen:
                self.epochs_dropped += 1
            self._epochs.append((self._epoch_start, now, self._epoch.fold()))
        self._epoch = Profile(self.max_stacks)
        self._epoch_start = now

    # -- folds -------------------------------------------------------------
    def _stamp(self, fold: dict) -> dict:
        fold["proc"] = self.proc
        fold["hz"] = self.hz
        return fold

    def total_fold(self) -> dict:
        with self._lock:
            return self._stamp(self.total.fold())

    def window_fold(self, window_s: float = 60.0) -> dict:
        """The last `window_s` seconds (epoch ring + live epoch) — what an
        incident capture snapshots."""
        cutoff = time.time() - float(window_s)
        out = Profile(self.max_stacks)
        with self._lock:
            for start, end, fold in self._epochs:
                if end >= cutoff:
                    out.merge(fold)
            out.merge(self._epoch.fold())
        fold = self._stamp(out.fold())
        fold["window_s"] = float(window_s)
        return fold

    def trace_fold(self, trace_id: str) -> dict:
        with self._lock:
            prof = self._traces.get(trace_id)
            fold = prof.fold() if prof is not None else Profile(1).fold()
        fold = self._stamp(fold)
        fold["trace_id"] = trace_id
        return fold

    # -- per-trace scoping (tracing.set_profile_hook target) ---------------
    def thread_trace_begin(self, trace_id: str):
        """Map THIS thread to `trace_id` for the sampler; returns a token
        for thread_trace_end. Called by tracing.activate on traced exec
        paths only — untraced work never reaches here."""
        ident = threading.get_ident()
        with self._lock:
            prev = self._trace_threads.get(ident)
            self._trace_threads[ident] = trace_id
            if trace_id not in self._traces:
                while len(self._traces) >= self.max_traces:
                    self._traces.pop(next(iter(self._traces)))
                    self.traces_evicted += 1
                self._traces[trace_id] = Profile(MAX_TRACE_STACKS)
        return (ident, prev)

    def thread_trace_end(self, token):
        if token is None:
            return
        ident, prev = token
        with self._lock:
            if prev is None:
                self._trace_threads.pop(ident, None)
            else:
                self._trace_threads[ident] = prev

    # -- capture sessions --------------------------------------------------
    def session_begin(self, kind: str, note: str = "", acc: Optional[Profile] = None) -> int:
        with self._lock:
            if len(self._sessions) >= MAX_SESSIONS:
                raise ProfilerBusy(
                    f"{len(self._sessions)} capture sessions already active in "
                    f"this process (bound {MAX_SESSIONS}); retry when one ends")
            sid = self._next_session
            self._next_session += 1
            self.sessions_started += 1
            self._sessions[sid] = {"kind": kind, "note": note,
                                   "start": time.time(), "acc": acc}
            return sid

    def session_end(self, sid: int):
        with self._lock:
            self._sessions.pop(sid, None)

    def capture(self, seconds: float, hz: Optional[float] = None) -> dict:
        """Blocking windowed capture in the CALLING thread (run it on an
        executor): its own sampling loop, so it works armed or disarmed and
        its duration is exact. Session-bounded; typed ProfilerBusy beyond."""
        seconds = min(max(0.05, float(seconds)), MAX_CAPTURE_S)
        rate = float(hz) if hz else (self.hz if self.hz > 0 else DEFAULT_HZ)
        interval = 1.0 / max(0.5, min(rate, 200.0))
        acc = Profile(self.max_stacks)
        sid = self.session_begin("cpu", note=f"{seconds:g}s", acc=acc)
        me = threading.get_ident()
        skip = {me}
        t = self._thread
        if t is not None and t.ident is not None:
            skip.add(t.ident)  # the bg sampler feeds the session via _sample_once
        try:
            end = time.monotonic() + seconds
            while time.monotonic() < end:
                if not self.running:
                    # Disarmed process: sample here (armed, the bg thread
                    # already feeds every session accumulator each tick).
                    for ident, frame in sys._current_frames().items():
                        if ident in skip:
                            continue
                        recs = _stacks.frame_records(frame, MAX_FRAMES)
                        acc.add(_stacks.collapse(recs), _stacks.plane_of(recs))
                time.sleep(interval)
        finally:
            self.session_end(sid)
        fold = self._stamp(acc.fold())
        fold["duration_s"] = seconds
        return fold

    # -- status ------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "proc": self.proc,
                "armed": self.running,
                "hz": self.hz,
                "ticks": self.ticks,
                "errors": self.errors,
                "samples": self.total.samples,
                "samples_dropped": self.total.samples_dropped,
                "stacks": len(self.total.stacks),
                "max_stacks": self.max_stacks,
                "occupancy": len(self.total.stacks) / max(1, self.max_stacks),
                "epochs": len(self._epochs),
                "epochs_dropped": self.epochs_dropped,
                "traces": len(self._traces),
                "traces_evicted": self.traces_evicted,
                "sessions": [
                    {"kind": s["kind"], "note": s["note"], "start": s["start"]}
                    for s in self._sessions.values()
                ],
                "sessions_started": self.sessions_started,
            }


# ---------------------------------------------------------------------------
# process-global singleton (armed by CoreWorker._setup_observability and the
# node daemon; every surface below talks to THIS sampler)
# ---------------------------------------------------------------------------
_sampler = Sampler()


def sampler() -> Sampler:
    return _sampler


def arm(hz: float = DEFAULT_HZ, proc: str = "", **cfg) -> Sampler:
    """(Re)configure and start the process sampler — idempotent, called from
    every core process's observability setup. Installs the tracing profile
    hook so traced exec spans get per-trace accumulators; hz <= 0 disarms."""
    _sampler.configure(hz=hz, proc=proc or None, **cfg)
    _sampler.start()
    if _sampler.running:
        _tracing.set_profile_hook(_sampler.thread_trace_begin,
                                  _sampler.thread_trace_end)
    else:
        _tracing.set_profile_hook(None, None)
    return _sampler


def disarm():
    _tracing.set_profile_hook(None, None)
    _sampler.stop()


def armed() -> bool:
    return _sampler.running


def status() -> dict:
    return _sampler.status()


def total_fold() -> dict:
    return _sampler.total_fold()


def window_fold(window_s: float = 60.0) -> dict:
    return _sampler.window_fold(window_s)


def window_fold_or_none(window_s: float = 60.0) -> Optional[dict]:
    """The flight recorder's incident hook: a dump carries its process's
    recent flamegraph when the sampler is armed, nothing otherwise."""
    if not _sampler.running:
        return None
    try:
        return _sampler.window_fold(window_s)
    except Exception:
        return None  # a dump must never fail because profiling hiccuped


def trace_fold(trace_id: str) -> dict:
    return _sampler.trace_fold(trace_id)


def capture(seconds: float, hz: Optional[float] = None) -> dict:
    return _sampler.capture(seconds, hz=hz)


def local_fold(p: dict) -> dict:
    """One process's reply to a ``profile_fold`` request — the shared leg
    of the worker RPC handler, the node daemon's own contribution, and the
    driver-side merge. Mode keys, first match wins: status / trace_id /
    seconds (BLOCKING live capture — run on an executor) / window_s /
    (default) total since arm."""
    if p.get("status"):
        return status()
    trace_id = p.get("trace_id") or ""
    if trace_id:
        return trace_fold(trace_id)
    seconds = p.get("seconds")
    if seconds:
        return capture(float(seconds))
    window_s = p.get("window_s")
    if window_s:
        return window_fold(float(window_s))
    return total_fold()


def aggregate_status(rows: list) -> dict:
    """Cluster rollup of per-process status dicts (`raytpu status` line,
    /api/profile?summary=1): worst occupancy, summed counters."""
    rows = [r for r in rows if isinstance(r, dict) and "samples" in r]
    agg = {
        "procs": len(rows),
        "armed": sum(1 for r in rows if r.get("armed")),
        "hz": max((float(r.get("hz", 0.0)) for r in rows), default=0.0),
        "samples": sum(int(r.get("samples", 0)) for r in rows),
        "samples_dropped": sum(int(r.get("samples_dropped", 0)) for r in rows),
        "stacks": sum(int(r.get("stacks", 0)) for r in rows),
        "max_stacks": sum(int(r.get("max_stacks", 0)) for r in rows),
        "occupancy": max((float(r.get("occupancy", 0.0)) for r in rows),
                         default=0.0),
        "traces": sum(int(r.get("traces", 0)) for r in rows),
        "sessions": sum(len(r.get("sessions") or []) for r in rows),
    }
    return agg


# ---------------------------------------------------------------------------
# device-side (GPU) profiling — ONE entry point, typed-and-loud on CPU
# ---------------------------------------------------------------------------
# Chrome-trace categories torch.profiler gives the card's own work (CUPTI
# activity records), as opposed to host ops, runtime calls and annotations.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _require_device_torch(what: str):
    """Import torch and demand a visible CUDA device, or raise the typed
    error naming exactly what is missing (the reference's
    ``_require_device_jax``)."""
    try:
        import torch
    except Exception as e:
        raise DeviceProfilerUnavailable(
            f"{what}: torch is not importable on this host "
            f"({type(e).__name__}: {e}); device profiling needs torch with "
            "CUDA — for host CPU profiles use obs.profiler.capture instead"
        ) from e
    if not torch.cuda.is_available():
        raise DeviceProfilerUnavailable(
            f"{what}: no CUDA device on this host "
            "(torch.cuda.is_available() is False) — device traces need device "
            "work; for host CPU profiles use obs.profiler.capture instead")
    return torch


class DeviceTrace:
    """What one ``device_capture`` window wrote: ``path`` (a Chrome trace
    JSON) and ``wall_s`` (the window's wall time, entry to exit), both set
    when the window closes."""

    __slots__ = ("logdir", "path", "wall_s")

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self.wall_s: Optional[float] = None

    def summary(self) -> dict:
        """``trace_summary`` of this window's trace over its wall time."""
        if self.path is None:
            raise RuntimeError("device trace window is still open")
        return trace_summary(self.path, self.wall_s)


def trace_summary(path: str, wall_s: Optional[float] = None) -> dict:
    """Device time of a Chrome trace written by ``device_capture``: the
    union of its device events' intervals (kernels, memcpys, memsets — the
    CUPTI records, which cover every thread of the process, where the
    profiler's host ops cover only the thread that entered it), launches
    per kernel name, and with ``wall_s`` the busy share device / wall."""
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = []
    kernels: dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_EVENT_CATS:
            continue
        t0 = float(ev["ts"])
        spans.append((t0, t0 + float(ev.get("dur", 0.0))))
        if ev["cat"] == "kernel":
            kernels[ev["name"]] = kernels.get(ev["name"], 0) + 1
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"device_events": len(spans), "device_ms": busy_us / 1e3,
           "kernels": kernels}
    if wall_s is not None:
        out["wall_ms"] = wall_s * 1e3
        out["busy"] = busy_us / 1e6 / wall_s if wall_s > 0 else None
    return out


@contextlib.contextmanager
def device_capture(logdir: str):
    """Capture a device trace (``torch.profiler``, CPU and CUDA activities;
    a Chrome trace viewable in Perfetto) around a block of device work, as a
    bounded profiler session — the single entry point
    ``tracing.profile_tpu`` routes through. Yields a ``DeviceTrace`` whose
    ``path`` and ``wall_s`` are set at exit; the card is synchronised before
    the profiler stops, so work queued in the window is in its trace.

    Raises ``DeviceProfilerUnavailable`` at entry on a host without a CUDA
    device. A profiler error propagates, and a trace that holds no device
    event raises at exit: never an empty trace in silence."""
    torch = _require_device_torch("device_capture")
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    out = DeviceTrace(logdir)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The session opens once the profiler records (its first start in a
        # process can take seconds), so an open "device" session in
        # status() means work from now on is in the trace.
        sid = _sampler.session_begin("device", note=logdir)
        try:
            t0 = time.perf_counter()
            yield out
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            _sampler.session_end(sid)
    path = os.path.join(logdir, f"device-{os.getpid()}-{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    if trace_summary(path)["device_events"] == 0:
        raise RuntimeError(
            f"device_capture: the trace {path} holds no device event (no "
            "kernel, memcpy or memset ran in the window, or the profiler "
            "recorded none)")
    out.path, out.wall_s = path, wall_s


class DeviceServer:
    """A listener on ``port`` in the calling process (``device_server``).
    One HTTP request ``GET /capture?seconds=S&logdir=DIR`` runs one bounded
    ``device_capture`` here for S seconds (at most ``MAX_CAPTURE_S``) and
    answers JSON ``{"path", "wall_ms", "device_ms", "busy", "kernels",
    "device_events"}``; an error answers 500 with ``{"error": ...}``.
    ``close()`` stops it."""

    def __init__(self, port: int):
        import http.server
        import json
        import urllib.parse

        lock = threading.Lock()

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server's name
                url = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(url.query)
                if url.path != "/capture" or "logdir" not in q:
                    self._reply(404, {"error": "GET /capture?seconds=S&logdir=DIR"})
                    return
                seconds = min(max(0.0, float(q.get("seconds", ["1"])[0])), MAX_CAPTURE_S)
                try:
                    with lock:  # one torch.profiler session at a time
                        with device_capture(q["logdir"][0]) as tr:
                            time.sleep(seconds)
                    self._reply(200, {"path": tr.path, **tr.summary()})
                except Exception as e:  # noqa: BLE001 - answered, not swallowed
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _reply(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="device-profiler-server", daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


def device_server(port: int = 9012) -> DeviceServer:
    """Start a device-profiler listener for remote capture (the reference
    starts the JAX profiler server here; torch has no counterpart, so the
    port serves its own one-request protocol, ``DeviceServer``; port 0
    picks a free one). Typed-and-loud without a CUDA device."""
    _require_device_torch("device_server")
    return DeviceServer(port)


def device_memory_records(ts: Optional[float] = None) -> list[dict]:
    """``gpu.device.bytes_in_use`` gauge records from
    ``torch.cuda.memory_allocated`` per visible device, reporter-record
    shaped. Gated hard: never IMPORTS torch (only reads it if the process
    already did) and never initializes CUDA (a process that has not touched
    the card reports nothing) — so CPU-only workers pay a sys.modules
    lookup."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        n = torch.cuda.device_count()
    except Exception:
        return []
    now = time.time() if ts is None else ts
    out = []
    for i in range(n):
        try:
            val = torch.cuda.memory_allocated(i)
        except Exception:
            continue
        out.append({
            "name": "gpu.device.bytes_in_use", "kind": "gauge",
            "description": "live device allocation (torch.cuda.memory_allocated)",
            "tags": {"device": str(i), "platform": "gpu"},
            "value": float(val), "ts": now,
        })
    return out
