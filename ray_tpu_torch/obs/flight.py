"""Flight recorder: always-on per-process black box for post-mortems.

Role-equivalent to the reference's per-worker TaskEventBuffer *retention*
gap: the reference (and this repo's PR-2/PR-4 pipeline) ships events to a
central bounded index and then forgets them locally — a dead worker takes
its unflushed buffers with it, and the controller's trace index (256x512)
evicts anything old. The flight recorder closes both holes with an
airliner-style black box: a bounded ring of FULL-FIDELITY events kept in
every process (spans, tracing point events, task-FSM transitions, chaos
injections, rpc connection metadata, qos shed/expiry), with counted
evictions, dumped as a self-contained JSONL file when something goes wrong.

Dump triggers are a CLOSED catalog (``TRIGGERS``), cross-checked by a
tree-wide AST test exactly like the chaos site catalog — a new trigger
woven into the runtime without a catalog entry (or vice versa) fails
tests/test_obs_plane.py, so every trigger path stays enumerable and tested:

  worker.death        last-gasp dump before a worker process dies (chaos
                      worker.exec kill, fatal executor crash); the node
                      daemon harvests it alongside the worker log and
                      reports the path to the controller event log
  chaos.invariant     a chaos scenario's invariant battery failed
  qos.deadline_storm  >= storm_expiries deadline expiries within
                      storm_window_s in one process
  tpu.preempt         the TPU preemption notice fired on a node
  manual              `raytpu debug dump <worker>` / handle_flight_dump

Cost contract: the recorder only *absorbs* events other subsystems already
produce (worker._event, chaos._record, qos.raise_expired, rpc conn
lifecycle) — one deque append under a lock per event, no new per-request
work on the quiet path (bench_core ``detail.obs_overhead`` holds this).
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

from ray_tpu_torch.util import tracing as _tracing

# The closed dump-trigger catalog. Key -> description; every `dump(<literal>)`
# call site in the tree must use one of these keys, and every key must have at
# least one call site (tests/test_obs_plane.py::test_dump_trigger_catalog).
TRIGGERS = {
    "worker.death": "last-gasp dump before the worker process exits fatally",
    "chaos.invariant": "chaos scenario invariant battery failure",
    "qos.deadline_storm": "deadline-expiry burst within the storm window",
    "tpu.preempt": "TPU preemption notice observed on this node",
    "manual": "operator-requested dump (raytpu debug dump / RPC)",
}

DUMP_MAGIC = "raytpu-flight"
DUMP_VERSION = 1

# Minimum seconds between dumps of the SAME trigger per process ("manual" is
# exempt: an operator asking twice means it twice).
_DUMP_MIN_INTERVAL_S = 2.0


class FlightRecorder:
    """One per-process bounded ring of observability events.

    Thread-safe; used from the worker IO loop, executor threads, the chaos
    gate, and qos hops. Events are plain dicts already stamped with the
    shared ``tracing.now()`` clock (``absorb``) or stamped here (``record``).
    """

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=max(16, int(capacity)))
        self.events_evicted = 0  # counted trim: ring overflow drops oldest
        self.dumps_written = 0
        self.enabled = True
        self.proc_id = f"pid{os.getpid()}"
        self.dump_dir = ""
        # Deadline-storm detector: monotonic stamps of recent expiries. Sized
        # to the threshold so "full deque inside the window" == storm.
        self.storm_expiries = 50
        self.storm_window_s = 5.0
        self._storm: collections.deque = collections.deque(maxlen=50)
        self._last_dump: dict[str, float] = {}  # trigger -> monotonic ts
        # Optional post-dump hook (CoreWorker installs one that reports the
        # dump path to the controller event log). Must never raise.
        self._on_dump: Optional[Callable[[str, str], None]] = None

    # -- configuration -----------------------------------------------------
    def configure(self, proc_id: str = "", dump_dir: str = "",
                  capacity: int = 0, storm_expiries: int = 0,
                  storm_window_s: float = 0.0):
        with self._lock:
            if proc_id:
                self.proc_id = proc_id
            if dump_dir:
                self.dump_dir = dump_dir
            if capacity and capacity != self._ring.maxlen:
                keep = list(self._ring)[-capacity:]
                self.events_evicted += max(0, len(self._ring) - len(keep))
                self._ring = collections.deque(keep, maxlen=max(16, int(capacity)))
            if storm_expiries and storm_expiries != self.storm_expiries:
                self.storm_expiries = int(storm_expiries)
                self._storm = collections.deque(self._storm, maxlen=self.storm_expiries)
            if storm_window_s:
                self.storm_window_s = float(storm_window_s)

    def set_dump_hook(self, fn: Optional[Callable[[str, str], None]]):
        self._on_dump = fn

    # -- recording ---------------------------------------------------------
    def absorb(self, ev: dict):
        """Tee an ALREADY-STAMPED event dict into the ring (the worker's
        `_event`, the chaos gate's injection record). The dict is shared,
        not copied — emitters never mutate events after append."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.events_evicted += 1
            self._ring.append(ev)

    def record(self, kind: str, **fields):
        """Record an event minted here (qos expiry, conn lifecycle, lag
        spike): stamped with the shared tracing clock like every other
        producer on the observability plane."""
        if not self.enabled:
            return
        ev = {"ts": _tracing.now(), "kind": kind, **fields}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.events_evicted += 1
            self._ring.append(ev)

    # -- queries -----------------------------------------------------------
    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def events_for_trace(self, trace_id: str) -> list[dict]:
        """Events this process still holds for one trace — the raw material
        `raytpu trace export` reassembles after the controller index evicted
        the trace."""
        with self._lock:
            return [ev for ev in self._ring if ev.get("trace_id") == trace_id]

    def stats(self) -> dict:
        with self._lock:
            return {
                "proc_id": self.proc_id,
                "len": len(self._ring),
                "capacity": self._ring.maxlen,
                "events_evicted": self.events_evicted,
                "dumps_written": self.dumps_written,
                "dump_dir": self.dump_dir,
            }

    # -- deadline-storm detector -------------------------------------------
    def note_expiry(self):
        """Called by qos.raise_expired on EVERY deadline expiry: when the
        last `storm_expiries` expiries all landed within `storm_window_s`,
        dump — a storm means deadlines are being missed wholesale and the
        ring currently holds the story of why."""
        if not self.enabled:
            return
        now = time.monotonic()
        storming = False
        with self._lock:
            self._storm.append(now)
            if (len(self._storm) == self._storm.maxlen
                    and now - self._storm[0] <= self.storm_window_s):
                storming = True
        if storming:
            self.dump("qos.deadline_storm",
                      reason=f"{self.storm_expiries} expiries in "
                             f"{self.storm_window_s:g}s")

    # -- dumping -----------------------------------------------------------
    def _dump_path(self, trigger: str) -> str:
        base = self.dump_dir or os.path.join(tempfile.gettempdir(), "raytpu_flight")
        os.makedirs(base, exist_ok=True)
        safe = trigger.replace(".", "_")
        return os.path.join(
            base, f"flight-{self.proc_id}-{safe}-{os.getpid()}-{self.dumps_written}.jsonl")

    def dump(self, trigger: str, reason: str = "", path: str = "") -> Optional[str]:
        """Write the ring as a self-contained JSONL dump: one header line
        (proc identity, trigger, counters) then one event per line. Returns
        the path, or None when rate-limited / recorder disabled. Synchronous
        by design — the worker.death caller is about to os._exit."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown flight dump trigger {trigger!r}; "
                             f"register it in obs.flight.TRIGGERS first")
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if trigger != "manual":
                last = self._last_dump.get(trigger)
                if last is not None and now - last < _DUMP_MIN_INTERVAL_S:
                    return None
            self._last_dump[trigger] = now
            events = list(self._ring)
            evicted = self.events_evicted
            self.dumps_written += 1
            out = path or self._dump_path(trigger)
        header = {
            "magic": DUMP_MAGIC,
            "version": DUMP_VERSION,
            "proc_id": self.proc_id,
            "pid": os.getpid(),
            "trigger": trigger,
            "reason": reason,
            "ts": _tracing.now(),
            "events": len(events),
            "events_evicted": evicted,
        }
        # Incident dumps carry their own flamegraph: when the continuous
        # sampler is armed, snapshot this process's recent profile window
        # into the header (the qos.deadline_storm / worker.death post-mortem
        # then says WHERE the cycles went, not just what happened). Lazy
        # import: the profiler is optional context, never a dump dependency.
        try:
            from ray_tpu_torch.obs import profiler as _profiler

            prof = _profiler.window_fold_or_none()
        except Exception:
            prof = None
        if prof is not None:
            header["profile"] = prof
        try:
            with open(out, "w") as f:
                f.write(json.dumps(header, default=str) + "\n")
                for ev in events:
                    f.write(json.dumps(ev, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            return None  # dump dir unwritable: never take the process down
        hook = self._on_dump
        if hook is not None:
            try:
                hook(out, trigger)
            except Exception:
                pass  # reporting is best-effort; the file on disk is the artifact
        return out


# -- process-global singleton ----------------------------------------------
_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def configure(**kw):
    _recorder.configure(**kw)


def set_enabled(on: bool):
    """A/B switch for the overhead bench (detail.obs_overhead): disabled,
    absorb/record return on one attribute load."""
    _recorder.enabled = bool(on)


def enabled() -> bool:
    return _recorder.enabled


def absorb(ev: dict):
    _recorder.absorb(ev)


def record(kind: str, **fields):
    _recorder.record(kind, **fields)


def note_expiry():
    _recorder.note_expiry()


def dump(trigger: str, reason: str = "", path: str = "") -> Optional[str]:
    return _recorder.dump(trigger, reason=reason, path=path)


def set_dump_hook(fn):
    _recorder.set_dump_hook(fn)


# -- dump files ------------------------------------------------------------
def load_dump(path: str) -> tuple[dict, list[dict]]:
    """Parse a flight dump back into (header, events); validates the magic
    header so the chaos invariant 'a dump exists AND parses' means something."""
    with open(path) as f:
        first = f.readline()
        header = json.loads(first)
        if header.get("magic") != DUMP_MAGIC:
            raise ValueError(f"{path} is not a flight dump (bad magic)")
        if header.get("trigger") not in TRIGGERS:
            raise ValueError(f"{path}: unknown trigger {header.get('trigger')!r}")
        events = [json.loads(line) for line in f if line.strip()]
    if len(events) != header.get("events"):
        raise ValueError(
            f"{path}: truncated dump ({len(events)} events, header says "
            f"{header.get('events')})")
    return header, events


def dump_autopsy(events: list[dict]) -> dict:
    """Attribute the final state of every task the dump saw: fold the FSM
    events per (task_id, attempt) with the SAME fold the controller's state
    index uses, and split in-flight (non-terminal at dump time — the tasks
    this process took down with it) from terminal. The worker_kill chaos
    invariant asserts the killed task shows up in_flight as RUNNING."""
    from ray_tpu_torch.core import task_state as _ts

    records: dict[tuple, dict] = {}
    counts: dict[str, int] = {}
    for ev in events:
        kind = ev.get("kind", "")
        counts[kind] = counts.get(kind, 0) + 1
        tid = ev.get("task_id")
        if not tid or kind not in _ts.EVENT_STATE:
            continue
        rec = records.setdefault((tid, ev.get("attempt", 0)),
                                 {"task_id": tid, "attempt": ev.get("attempt", 0)})
        _ts.fold(rec, ev)
    in_flight = [r for r in records.values()
                 if r.get("state") not in _ts.TERMINAL]
    done = [r for r in records.values() if r.get("state") in _ts.TERMINAL]
    return {
        "tasks": len(records),
        "in_flight": sorted(in_flight, key=lambda r: r.get("times", {}).get("RUNNING", 0.0)),
        "terminal": len(done),
        "event_counts": counts,
    }


def normalize_dump(events: list[dict]) -> list[tuple]:
    """Replay-diff form of a dump: the (kind, name-or-fn) sequence with
    timestamps/ids stripped — two same-seed chaos runs must produce byte-
    identical normalized sequences (determinism acceptance)."""
    out = []
    for ev in events:
        out.append((ev.get("kind", ""), ev.get("name") or ev.get("fn") or ev.get("site") or ""))
    return out


def export_dump_timeline(dump_path: str, out_path: str) -> int:
    """Render a flight dump through the SAME chrome-trace renderer as
    `export_timeline` — one rendering path for live clusters and black
    boxes (dumps render through the existing export_timeline path)."""
    _header, events = load_dump(dump_path)
    return _tracing.render_timeline(events, out_path)
