"""Weight publication: committed checkpoints → live serve replicas.

The controller keeps a checkpoint registry (every attempt's outcome,
committed or aborted — ``/api/checkpoints`` and ``raytpu list
checkpoints``) and a per-channel "latest committed" pointer. Committing a
manifest on a named channel publishes its summary over the controller's
pubsub (channel ``ckpt:<name>``); replicas that subscribed get pushed the
new version and a slow/disconnected replica converges anyway through the
poll fallback — publication is a pointer move, the bytes stay on the chunk
tier and each replica fetches + digest-verifies them itself before
swapping. The swap runs under whatever gate the replica chooses (the
LLMServer holds its engine-step lock), so in-flight requests finish on the
old weights and no request ever sees a half-swapped tree: no restart, no
torn read.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.ckpt.chunks import ChunkStore
from ray_tpu_torch.ckpt.manifest import Manifest, load_manifest
from ray_tpu_torch.ckpt.restore import restore_tree
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

CHANNEL_PREFIX = "ckpt:"

_publish_latency = _metrics.Histogram(
    "ckpt.publish.latency_s",
    "manifest commit -> replica weights live (per swap)",
    boundaries=[0.05, 0.1, 0.5, 1, 5, 15, 60, 300],
)
_swaps_total = _metrics.Counter(
    "ckpt.publish.swaps_total", "completed in-place weight hot-swaps",
    tag_keys=("channel",))
_swap_failures = _metrics.Counter(
    "ckpt.publish.failures_total",
    "weight-swap attempts that failed (fetch/verify/apply); replica kept old weights",
    tag_keys=("channel",))


def _core():
    from ray_tpu_torch.core import api

    w = api._global_worker
    if w is None or w.loop is None:
        return None
    return w


def register_manifest(summary: dict) -> bool:
    """Record one attempt's outcome in the controller registry (committed
    summaries on a channel also fan out to subscribers). Returns False when
    no session is live — shared storage remains the source of truth."""
    core = _core()
    if core is None:
        return False
    core._run(core.controller.call("ckpt_register", {"summary": dict(summary)}))
    return True


def publish_checkpoint(manifest: Manifest, channel: str) -> bool:
    """Point ``channel`` at an already-committed manifest (the explicit
    publication call for manifests saved without a channel binding)."""
    summary = Manifest(manifest).summary()
    summary["channel"] = channel
    summary["status"] = "committed"
    return register_manifest(summary)


def latest_on_channel(channel: str) -> Optional[dict]:
    core = _core()
    if core is None:
        return None
    return core._run(core.controller.call("ckpt_latest", {"channel": channel}))


class WeightSubscriber:
    """Replica-side subscription to a named checkpoint channel.

    ``swap_fn(tree, summary)`` is called with the fully fetched,
    digest-verified weight tree; the callee applies it under its own
    admission gate (hold the lock that excludes request execution, assign,
    release). Fetch and verify happen OUTSIDE that gate on this
    subscriber's thread, so the replica keeps serving old weights for the
    whole download — the gate is held only for the pointer flip."""

    def __init__(self, channel: str, swap_fn: Callable, *,
                 poll_interval_s: Optional[float] = None,
                 storage_root: Optional[str] = None, auto_start: bool = True):
        if poll_interval_s is None:
            from ray_tpu_torch.core import api as _api
            from ray_tpu_torch.core.config import get_config

            # Subscribers run inside replicas: the ADOPTED cluster config,
            # not get_config(), or a head-pushed ckpt_poll_interval_s would
            # be invisible here (the PR-8 lesson).
            core = getattr(_api, "_global_worker", None)
            cfg = getattr(core, "config", None) or get_config()
            poll_interval_s = cfg.ckpt_poll_interval_s
        self.channel = channel
        self.swap_fn = swap_fn
        self.poll_interval_s = float(poll_interval_s)
        self.storage_root = storage_root
        self.current_version: Optional[str] = None
        self.swaps = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._subscribed = False
        if auto_start:
            self.start()

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"raytpu-ckpt-sub-{self.channel}", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- the subscription loop ------------------------------------------
    def _ensure_subscribed(self, core):
        if self._subscribed:
            return
        # Push path: the controller's pubsub wakes the poll loop the moment
        # a commit lands; the poll interval is only the recovery cadence.
        core._run(core.subscribe_channel(
            CHANNEL_PREFIX + self.channel, lambda _key, _data: self._wake.set()))
        self._subscribed = True

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception as e:
                self.failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                _swap_failures.inc(tags={"channel": self.channel})
            self._wake.wait(timeout=self.poll_interval_s)
            self._wake.clear()

    def check_once(self) -> bool:
        """One poll: fetch + swap if the channel moved. Returns True when a
        swap happened (also the test/scenario surface — drive it directly
        for deterministic swaps)."""
        core = _core()
        if core is None:
            return False
        self._ensure_subscribed(core)
        summary = latest_on_channel(self.channel)
        if not summary or summary.get("ckpt_id") == self.current_version:
            return False
        self._apply(summary)
        return True

    def _apply(self, summary: dict):
        storage = self.storage_root or summary.get("storage")
        if not storage:
            raise ValueError(f"checkpoint {summary.get('ckpt_id')} carries no storage root")
        with _tracing.span("ckpt.publish.swap", channel=self.channel,
                           ckpt_id=summary["ckpt_id"]):
            manifest = load_manifest(storage, summary["ckpt_id"])
            # Full digest verification before anything goes live: wrong
            # weights served fast are worse than a failed swap.
            tree = restore_tree(manifest, ChunkStore(storage), verify=True)
            fault = _chaos.maybe_inject("ckpt.publish.swap",
                                        channel=self.channel,
                                        ckpt_id=summary["ckpt_id"][:16])
            if fault is not None:
                if fault.kind == "delay":
                    time.sleep(fault.delay_s)
                else:
                    raise fault.error(f"swap on {self.channel}")
            self.swap_fn(tree, summary)
        self.current_version = summary["ckpt_id"]
        self.swaps += 1
        self.last_error = None
        _swaps_total.inc(tags={"channel": self.channel})
        committed = summary.get("committed_ts")
        if committed:
            _publish_latency.observe(max(0.0, time.time() - committed))
