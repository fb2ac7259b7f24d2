"""Runtime health sampler: event-loop lag probe + lag-spike thread dumps.

Every core process (driver, worker, node daemon) is an asyncio event loop;
when user code or a misbehaving handler blocks it, EVERY deadline timer,
heartbeat, and rpc reply on that process stalls at once — and nothing in
the metrics pipeline says why. The probe measures the loop's scheduling
lag directly (sleep(interval), compare the overshoot), publishes it as the
``runtime.loop.lag_s`` histogram through the existing reporter, and on a
spike past the threshold drops a stack dump of every thread into the
flight recorder — so the black box from a stalled process names the frame
that was holding the loop (graftlint no-blocking-in-async catches the
static cases; this catches the dynamic ones).
"""
from __future__ import annotations

import asyncio
import time

from ray_tpu_torch.obs import flight as _flight
from ray_tpu_torch.obs import stacks as _stacks
from ray_tpu_torch.util import metrics as _metrics

# One histogram per process; bucket edges tuned for "scheduling jitter"
# through "seconds-long stall".
_LAG_BOUNDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 5]

# Rate limit on spike thread-dumps: one stalled handler must not flood the
# recorder with near-identical stacks every probe tick.
_SPIKE_MIN_INTERVAL_S = 5.0


def thread_dump(max_frames: int = 12) -> list[dict]:
    """Compact stacks of every live thread (sys._current_frames), newest
    frame last — what the flight recorder stores on a lag spike. Walks and
    renders through obs/stacks (the ONE stack formatter), so a lag-spike
    dump and a profiler flamegraph name every frame identically."""
    return _stacks.thread_dump(max_frames)


class LoopLagProbe:
    """Measures THIS loop's scheduling lag on a fixed cadence. Run as a
    background task on the loop under observation; the await itself is the
    measurement (any blocking work delays the wakeup)."""

    def __init__(self, loop_name: str, interval_s: float = 0.25,
                 spike_s: float = 0.25):
        self.loop_name = loop_name
        self.interval_s = max(0.02, float(interval_s))
        self.spike_s = float(spike_s)
        self.spikes = 0
        self.last_lag_s = 0.0
        self._last_spike_mono = 0.0
        self._hist = _metrics.Histogram(
            "runtime.loop.lag_s",
            "event-loop scheduling lag per process (sleep overshoot)",
            boundaries=_LAG_BOUNDS,
            tag_keys=("loop",),
        ).bind({"loop": loop_name})

    async def run(self):
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval_s)
            lag = max(0.0, loop.time() - t0 - self.interval_s)
            self.last_lag_s = lag
            self._hist.observe(lag)
            if lag >= self.spike_s:
                self.spikes += 1
                now = time.monotonic()
                if now - self._last_spike_mono >= _SPIKE_MIN_INTERVAL_S:
                    self._last_spike_mono = now
                    # The stack that HELD the loop already returned by the
                    # time we run again, but sibling threads (executor pool,
                    # proxy threads) are often the culprit and still show;
                    # the event itself timestamps the stall on the timeline.
                    _flight.record("loop.lag_spike", loop=self.loop_name,
                                   lag_s=lag, threads=thread_dump())
