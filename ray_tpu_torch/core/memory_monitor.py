"""Node memory monitor + OOM worker-killing policy.

Role-equivalent to the reference's raylet memory monitor and
worker-killing policies (src/ray/raylet/worker_killing_policy*:
group-by-owner / retriable-first victim selection when node memory crosses the
usage threshold). The daemon polls system memory at a fixed cadence; above the
threshold it kills ONE worker per cooldown window, ordered to destroy the
least work while actually relieving pressure:

1. an IDLE pooled worker (no work lost — just cached process state),
2. a LEASED task worker (tasks retry by default),
3. an ACTOR worker, restartable (max_restarts != 0) strictly first;

within each class the largest-RSS worker is chosen (killing a tiny worker
cannot relieve pressure), newest-first on ties. A cooldown between kills
lets reclamation and retries settle, bounding the kill rate when the
pressure source is external to the workers.

The kill surfaces as a normal worker death: callers retry per
``max_retries`` / actor FSMs restart per ``max_restarts``, with the OOM
reason attached.
"""
from __future__ import annotations

import asyncio
import logging
import os
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def system_memory_usage() -> float:
    """Fraction of physical memory in use, from /proc/meminfo (MemAvailable
    accounts for reclaimable cache, matching the kernel's OOM view)."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def worker_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


def pick_oom_victim(workers, restartable: Callable[[object], bool] = lambda w: False):
    """Victim selection over WorkerRecord-likes (state, state_ts fields).

    Order: IDLE (any) -> LEASED -> ACTOR (restartable strictly first).
    Within a class, the worker actually holding the most memory (RSS) is
    preferred — killing the newest-but-tiny worker cannot relieve pressure;
    state_ts breaks RSS ties newest-first (least sunk work). Returns None
    when there is nothing killable.
    """
    def key(w):
        rss = worker_rss_bytes(w.proc.pid) if getattr(w, "proc", None) else 0
        return (rss, w.state_ts)

    idle = [w for w in workers if w.state == "IDLE"]
    if idle:
        return max(idle, key=key)
    leased = [w for w in workers if w.state == "LEASED"]
    if leased:
        return max(leased, key=key)
    actors = [w for w in workers if w.state == "ACTOR"]
    if actors:
        return max(actors, key=lambda w: (restartable(w),) + key(w))
    return None


class MemoryMonitor:
    """Async polling loop owned by the node daemon."""

    def __init__(
        self,
        threshold: float,
        interval_s: float,
        get_workers: Callable[[], list],
        kill: Callable[[object, str], None],
        restartable: Callable[[object], bool] = lambda w: False,
        usage_fn: Callable[[], float] = system_memory_usage,
    ):
        self.threshold = threshold
        self.interval_s = interval_s
        self.get_workers = get_workers
        self.kill = kill
        self.restartable = restartable
        self.usage_fn = usage_fn
        self.kills = 0  # observability: total OOM kills by this daemon
        # Kill-rate limiter: after a kill, let the freed memory actually get
        # reclaimed (and the retry machinery settle) before judging again —
        # without this, sustained external pressure (another process eating
        # RAM) would serially execute every worker at poll cadence.
        self.cooldown_s = max(2.0, 8 * interval_s)
        self._last_kill_ts = 0.0

    async def run(self):
        if self.threshold <= 0:
            return
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("memory monitor poll failed")

    def poll_once(self) -> Optional[object]:
        usage = self.usage_fn()
        if usage < self.threshold:
            return None
        import time as _time

        now = _time.monotonic()
        if now - self._last_kill_ts < self.cooldown_s:
            return None
        victim = pick_oom_victim(self.get_workers(), self.restartable)
        if victim is None:
            return None
        self._last_kill_ts = now
        rss = worker_rss_bytes(victim.proc.pid) if victim.proc else 0
        self.kills += 1
        logger.warning(
            "memory usage %.1f%% over threshold %.1f%%: OOM-killing worker %s "
            "(state=%s, rss=%.0fMB)",
            usage * 100, self.threshold * 100, victim.worker_id[:8],
            victim.state, rss / 1e6,
        )
        self.kill(
            victim,
            f"worker OOM-killed: node memory usage {usage:.2f} exceeded "
            f"threshold {self.threshold:.2f} (rss {rss / 1e6:.0f}MB)",
        )
        return victim
