"""CoreWorker: per-process runtime — object ownership, task submission and
execution, actor runtime, get/put/wait.

Role-equivalent to the reference's CoreWorker
(src/ray/core_worker/core_worker.h:167) plus its Cython
binding (_raylet.pyx:2678). The same class runs inside drivers and spawned
workers (the reference does the same; drivers are CoreWorker processes,
SURVEY §1). Key flows mirrored:

* task submission with lease caching per scheduling key
  (normal_task_submitter.h:86) — dependencies are resolved *before* the lease
  is requested (dependency_resolver.h) so a waiting task never holds
  resources, which is what makes executor-side blocking deadlock-free;
* ownership: the creating worker owns its return objects and serves them to
  borrowers (reference_counter.h:44; borrowers register with the owner);
* small objects are inlined in replies / the owner's in-process memory store,
  large objects go to the node's shared-memory arena
  (store_provider/memory_store, plasma_store_provider.h);
* actor task queues with per-connection FIFO ordering and
  max_concurrency via thread pool or asyncio (task_execution/
  actor_scheduling_queue.h, concurrency groups + fiber.h).

All networking runs on one asyncio loop (a dedicated thread in drivers, the
main thread in workers); user code runs on executor threads.
"""
from __future__ import annotations

import asyncio
import bisect
import collections
import concurrent.futures
import functools
import hashlib
import inspect
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import (
    GetTimeoutError,
    ObjectLostError,
    ObjectRef,
    ObjectRefGenerator,
    set_ref_hooks,
)
from ray_tpu_torch.core.object_store import MemoryStore, ObjectExistsError, ObjectStoreFullError, SharedMemoryClient
from ray_tpu_torch.core.serialization import RemoteError
from ray_tpu_torch.core import task_state as _ts
from ray_tpu_torch.core.task_spec import ActorSpec, TaskOptions, TaskSpec, scheduling_key
from ray_tpu_torch.obs import flight as _flight
from ray_tpu_torch.obs import health as _obs_health
from ray_tpu_torch.obs import profiler as _profiler
from ray_tpu_torch.qos import context as _qos
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.bgtasks import spawn_bg as _spawn_bg_task

logger = logging.getLogger(__name__)

# Task execution latency (first-class runtime metric; ships via the
# reporter -> controller -> /metrics pipeline). Bound series: the observe
# hot path skips per-call tag-dict building.
_task_latency = _metrics.Histogram(
    "task.exec.latency_s",
    "wall-clock task execution latency (seconds)",
    boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
    tag_keys=("kind",),
)
_task_latency_task = _task_latency.bind({"kind": "task"})
_task_latency_actor = _task_latency.bind({"kind": "actor"})

# Owner-side streamed-batch histogram ({items-per-generator_items-frame:
# frames}) across every stream this process consumes — the streaming lane's
# analogue of rpc.batch_stats (bench_core reports it in the
# streaming_generator_items row's detail; _runtime_series promotes it to the
# stream.batch.items metric on /metrics).
_STREAM_BATCH_HIST: collections.Counter = collections.Counter()
_STREAM_BATCH_BUCKETS = [1, 2, 4, 8, 16, 32, 64]


def stream_batch_stats(reset: bool = False) -> dict:
    """{items-per-batch-frame: frames} absorbed by this process's streams."""
    out = {k: v for k, v in sorted(_STREAM_BATCH_HIST.items())}
    if reset:
        _STREAM_BATCH_HIST.clear()
    return out


_MISS = object()  # sentinel: value not locally resident


def _spec_fn_name(spec: "TaskSpec") -> str:
    """Human-readable callable name for state-index/event attribution:
    the explicit options name, the actor method, else the export key."""
    return spec.options.name or spec.method_name or spec.fn_id[:24]


def _error_type(err: BaseException) -> str:
    """The FAILED{error_type} discriminator: the USER exception's type when
    a RemoteError wraps one, else the infrastructure error's own type."""
    cause = getattr(err, "cause", None)
    return type(cause).__name__ if cause is not None else type(err).__name__


class ActorDiedError(Exception):
    pass


class TaskCancelledError(Exception):
    pass


class _StreamClosed(Exception):
    """Internal: the consumer closed a streaming generator early; the
    producer stops at its next yield."""


@dataclass
class OwnedObject:
    state: str = "PENDING"  # PENDING | READY | FAILED
    size: int = 0
    in_memory: bool = False
    in_shm: bool = False
    error: Optional[BaseException] = None
    local_refs: int = 0
    borrowers: int = 0
    ready_event: asyncio.Event | None = None


@dataclass
class LeasedWorker:
    address: str
    worker_id: str
    node_addr: str
    lease_id: str
    node_id: str = ""  # controller node id (state-index attribution)
    conn: Any = None
    busy: bool = False
    last_used: float = 0.0


class _KeySubmitter:
    """Per-scheduling-key task queue + lease pool (reference: per-SchedulingKey
    state in NormalTaskSubmitter)."""

    def __init__(self, core: "CoreWorker", key: str, opts: TaskOptions):
        self.core = core
        self.key = key
        self.opts = opts
        self.queue: list[tuple[TaskSpec, asyncio.Future]] = []
        self.workers: list[LeasedWorker] = []
        self.pending_lease_requests = 0

    def pump(self):
        # Batch dispatch: when the queue is deeper than the worker pool, ship
        # several specs per RPC (amortizes frame+serialization overhead; the
        # worker still executes them serially, preserving one-task-at-a-time
        # worker semantics). Shallow queues keep batch=1 for latency.
        while self.queue:
            free_workers = [w for w in self.workers if not w.busy and not (w.conn and w.conn.closed)]
            if not free_workers:
                break
            per = max(1, min(64, (len(self.queue) + len(free_workers) - 1) // len(free_workers)))
            for w in free_workers:
                if not self.queue:
                    break
                # Non-retryable (max_retries=0) tasks ship alone: a worker
                # crash mid-batch loses the whole reply, and tasks that DID
                # execute must not be retro-failed/retried in bulk — singleton
                # dispatch keeps their ambiguity window identical to unbatched.
                items = []
                while self.queue and len(items) < per:
                    spec, fut = self.queue[0]
                    retries = spec.options.max_retries
                    if retries == -1:
                        retries = self.core.config.max_task_retries_default
                    if retries == 0 and items:
                        break  # starts the next batch
                    items.append(self.queue.pop(0))
                    if retries == 0:
                        break
                w.busy = True
                self.core._spawn_bg(self._dispatch(w, items))
        want = len(self.queue)
        while want > 0 and self.pending_lease_requests < min(want, self.core.config.max_pending_lease_requests_per_key):
            self.pending_lease_requests += 1
            self.core._spawn_bg(self._request_lease())
            want -= 1

    async def _request_lease(self):
        try:
            lease_id = os.urandom(8).hex()
            reply = await self.core.controller.call(
                "request_lease",
                {
                    "lease_id": lease_id,
                    "demand": self.opts.resource_demand(),
                    "strategy": self.opts.scheduling_strategy,
                    "label_selector": self.opts.label_selector,
                },
            )
            if reply.get("infeasible"):
                err = RuntimeError(f"infeasible resource demand: {self.opts.resource_demand()} (no node can ever satisfy it)")
                for spec, fut in self.queue:
                    self.core._fail_task_returns(spec, err)
                    if not fut.done():
                        fut.set_result(False)
                self.queue.clear()
                return
            try:
                daemon = await self.core._daemon_conn(reply["address"])
                lease = await daemon.call(
                    "lease_worker",
                    {"lease_id": lease_id, "runtime_env": self.opts.runtime_env or None},
                )
                w = LeasedWorker(lease["address"], lease["worker_id"], reply["address"], lease_id,
                                 node_id=reply.get("node_id", ""))
                w.conn = await self.core._peer_conn(w.address)
            except Exception:
                # The controller already consumed resources for this lease;
                # give them back or the node leaks capacity forever.
                try:
                    await self.core.controller.call(
                        "release_lease", {"lease_id": lease_id, "strategy": self.opts.scheduling_strategy}
                    )
                except Exception:
                    pass
                raise
            self.workers.append(w)
        except Exception as e:
            # DETERMINISTIC runtime-env materialization failures are
            # PERMANENT for this task key (the env spec is part of the key):
            # a missing conda binary / container engine / failed env build
            # will fail identically on every retry — surface it to the
            # caller instead of retrying the lease forever (reference:
            # runtime-env agent setup errors fail the lease with a creation
            # error). The daemon raises RuntimeEnvSetupError for exactly
            # that class (the type survives the RPC hop); transient faults
            # (kv_get hiccup mid-download) take the retry branch.
            from ray_tpu_torch.core.runtime_env import RuntimeEnvSetupError

            if isinstance(e, RuntimeEnvSetupError):
                for spec, fut in self.queue:
                    self.core._fail_task_returns(spec, RuntimeError(str(e)))
                    if not fut.done():
                        fut.set_result(False)
                self.queue.clear()
            else:
                logger.warning("lease request failed for %s: %s", self.key[:40], e)
                await asyncio.sleep(self.core.config.rpc_retry_delay_s)
        finally:
            self.pending_lease_requests -= 1
            self.pump()

    async def _dispatch(self, w: LeasedWorker, items: list[tuple[TaskSpec, asyncio.Future]]):
        try:
            # Lean framing (same scheme as actor pushes): per-conn interning
            # of (options, fn) constants; repeat calls ship small tuples.
            interned = w.conn.meta.setdefault("opts_out", {})
            wire = []
            for spec, _ in items:
                if spec.num_returns == -1:
                    self.core._stream_conns[spec.task_id.binary()] = w.conn
                key = (id(spec.options), spec.fn_id)
                ent = interned.get(key)
                if ent is None:
                    if len(interned) >= 512:
                        # Unbounded distinct options: stop interning.
                        wire.append({"spec": spec})
                        continue
                    oid_small = len(interned)
                    interned[key] = (spec.options, oid_small)  # pin: id() stays valid
                    wire.append({"spec": spec, "oid": oid_small})
                else:
                    msg = {"lean": (
                        spec.task_id.binary(), spec.args_blob, spec.num_returns, ent[1],
                        getattr(spec, "_attempts", 0),
                    )}
                    if spec.trace_ctx is not None:
                        msg["tc"] = spec.trace_ctx
                    if spec.qos_ctx is not None:
                        msg["qc"] = spec.qos_ctx
                    wire.append(msg)
            for spec, _ in items:
                # FSM: the attempt left the submitter queue for a concrete
                # worker — node/worker attribution is known from here on.
                self.core._task_event("task_dispatched", spec,
                                      node=w.node_id, exec_worker=w.worker_id[:12])
            fault = _chaos.maybe_inject("worker.task.dispatch", worker=w.worker_id[:12])
            if fault is not None and fault.kind == "error":
                # Simulated worker loss at dispatch: RpcError lands in the
                # except arm below — the real retry/backoff path, with no
                # process actually harmed (deterministic retry exerciser).
                raise rpc.RpcError(f"chaos[worker.task.dispatch#{fault.hit}] injected dispatch failure")
            reply = await w.conn.call("push_tasks", {"specs": wire})
            for (spec, fut), r in zip(items, reply["results"]):
                self.core._absorb_task_reply(spec, r, fut)
        except (rpc.ConnectionLost, rpc.RpcError) as e:
            await self._drop_worker(w, failed=True)
            for spec, fut in items:
                retries = spec.options.max_retries
                if retries == -1:
                    retries = self.core.config.max_task_retries_default
                attempts = getattr(spec, "_attempts", 0)
                if attempts < retries:
                    # Close the superseded attempt's index record: without a
                    # terminal event it would sit SUBMITTED/RUNNING forever,
                    # and the terminal-first eviction policy would shed real
                    # live state around these immortal ghosts.
                    self.core._task_event("task_failed", spec, attempt=attempts,
                                          error_type=type(e).__name__, retrying=True)
                    spec._attempts = attempts + 1  # type: ignore[attr-defined]
                    logger.warning("task %s lost worker (%s); retry %d", spec.task_id.hex()[:8], e, attempts + 1)
                    self.queue.append((spec, fut))
                else:
                    self.core._fail_task_returns(spec, RemoteError(f"task {spec.task_id.hex()[:8]} failed after retries: {e}"))
                    if not fut.done():
                        fut.set_result(False)
        finally:
            w.busy = False
            w.last_used = time.monotonic()
            self.pump()

    async def _drop_worker(self, w: LeasedWorker, failed: bool = False):
        if w in self.workers:
            self.workers.remove(w)
        try:
            daemon = await self.core._daemon_conn(w.node_addr)
            await daemon.call("return_worker", {"worker_id": w.worker_id, "reusable": not failed})
        except Exception:
            pass
        try:
            await self.core.controller.call("release_lease", {"lease_id": w.lease_id, "strategy": self.opts.scheduling_strategy})
        except Exception:
            pass

    async def reap_idle(self, linger_s: float):
        now = time.monotonic()
        for w in list(self.workers):
            if not w.busy and now - w.last_used > linger_s and not self.queue:
                await self._drop_worker(w)


class _StreamShipper:
    """Executor-side fast lane for one streaming generator task: a bounded
    per-stream buffer the producer appends into (cross-thread ``put`` for
    thread-run generators, loop-side ``aput`` for async generators), drained
    by a single loop-side pump that ships every adjacent item as ONE
    ``generator_items`` batch frame — one pickle+MAC+write per burst instead
    of a full cross-thread round trip per yielded item (the PR-1 coalescing
    move applied to the token path of every streamed response). A lone item
    still flushes the tick it lands: the pump is armed by the buffer's
    empty->nonempty transition, never a timer, so first-item latency stays
    one thread handoff — exactly what the old per-item path paid.

    Backpressure: the producer blocks (or awaits) while the buffer is full,
    and — when ``TaskOptions.generator_backpressure`` is set — while it runs
    more than ``bp`` items ahead of the consumer's acked consumption. Acks
    arrive batch-granular (the owner coalesces per-item consumption into one
    generator_ack per burst; see CoreWorker._install_stream_ack).
    """

    def __init__(self, core: "CoreWorker", conn, spec: TaskSpec, loop):
        self.core = core
        self.conn = conn
        self.spec = spec
        self.loop = loop
        self.tid = spec.task_id.binary()
        bp = getattr(spec.options, "generator_backpressure", -1)
        self.bp = bp if bp and bp > 0 else 0
        self.limit = max(1, core.config.stream_buffer_items)
        self._cond = threading.Condition()
        self.buf: list = []  # [(index, value)] pending ship, index order
        self.consumed = 0  # consumer-acked high-water mark (IO loop writes)
        self.closed = False  # consumer abandoned the stream
        self.error: Optional[BaseException] = None  # ship failure -> producer
        self.items_dropped = 0  # buffered items discarded at close (tallied)
        self._pump_armed = False
        self._aev = asyncio.Event()  # wakes loop-side waiters (async gens)

    # -- producer side --------------------------------------------------
    def _ready_locked(self, index: int) -> bool:
        return len(self.buf) < self.limit and (
            not self.bp or index - self.consumed < self.bp
        )

    def put(self, index: int, value) -> None:
        """Producer-thread append; blocks only while the buffer is full or
        the consumption bound is exhausted (backpressure semantics of the
        old per-item path, preserved)."""
        with self._cond:
            while True:
                if self.closed or self.tid in self.core._cancelled_streams:
                    raise _StreamClosed()
                if self.error is not None:
                    raise self.error
                if self._ready_locked(index):
                    break
                self._cond.wait()
            self.buf.append((index, value))
            arm = not self._pump_armed
            if arm:
                self._pump_armed = True
        if arm:
            self.loop.call_soon_threadsafe(self._pump_start)

    async def aput(self, index: int, value) -> None:
        """Loop-side append for async generators (never blocks the loop;
        room/ack waits ride an asyncio.Event the IO-loop writers set)."""
        while True:
            with self._cond:
                if self.closed or self.tid in self.core._cancelled_streams:
                    raise _StreamClosed()
                if self.error is not None:
                    raise self.error
                if self._ready_locked(index):
                    self.buf.append((index, value))
                    arm = not self._pump_armed
                    if arm:
                        self._pump_armed = True
                    break
                self._aev.clear()
            await self._aev.wait()
        if arm:
            self._pump_start()

    def finish(self) -> None:
        """Producer exhausted: wait for the pump to drain, then surface any
        ship failure (the old per-item path raised it at the failing item;
        here it lands at the next put or at finish)."""
        with self._cond:
            while self._pump_armed and self.error is None:
                self._cond.wait()
            if self.error is not None and not self.closed:
                raise self.error

    async def afinish(self) -> None:
        while True:
            with self._cond:
                if not self._pump_armed or self.error is not None:
                    if self.error is not None and not self.closed:
                        raise self.error
                    return
                self._aev.clear()
            await self._aev.wait()

    # -- IO-loop side ---------------------------------------------------
    def on_ack(self, consumed: int) -> None:
        with self._cond:
            if consumed > self.consumed:
                self.consumed = consumed
                self._cond.notify_all()
        self._aev.set()

    def close_consumer(self) -> None:
        """Consumer abandoned the stream: discard what is buffered (tallied
        — no silent caps) and wake any blocked producer so it observes the
        close at its next yield."""
        with self._cond:
            self.closed = True
            n = len(self.buf)
            if n:
                self.items_dropped += n
                del self.buf[:n]
            self._cond.notify_all()
        self._aev.set()

    def _pump_start(self) -> None:
        self.core._spawn_bg(
            self._pump(), name=f"stream-pump-{self.spec.task_id.hex()[:8]}"
        )

    async def _pump(self) -> None:
        """Drain the buffer until empty: each swap ships as one batch frame.
        Single-instance per stream (the armed flag), so wire order == index
        order; re-armed by the producer's next empty->nonempty append."""
        while True:
            with self._cond:
                batch, self.buf = self.buf, []
                if not batch:
                    self._pump_armed = False
                    self._cond.notify_all()
                    self._aev.set()
                    return
                self._cond.notify_all()  # room freed: unblock the producer
            self._aev.set()
            try:
                items = []
                for index, value in batch:
                    items.append((index, await self.core._package_value(
                        ObjectID.for_return(self.spec.task_id, index), value
                    )))
                fault = _chaos.maybe_inject(
                    "rpc.stream.item", task=self.spec.task_id.hex()[:8],
                    attempt=getattr(self.spec, "_attempts", 0),
                )
                if fault is not None:
                    if fault.kind == "delay":
                        await asyncio.sleep(fault.delay_s)
                    elif fault.kind == "drop":
                        # A lost frame on a healthy-looking conn would strand
                        # the consumer waiting for the missing indices, so a
                        # real transport that eats a frame kills the
                        # connection — emulate exactly that: the caller's
                        # connection-loss retry resubmits on a fresh worker
                        # and the replay's duplicate indices dedup owner-side.
                        await self.conn.close()
                        raise rpc.ConnectionLost(
                            f"chaos[rpc.stream.item#{fault.hit}] dropped "
                            "generator batch frame"
                        )
                await self.conn.notify("generator_items", {
                    "task_id": self.tid,
                    "items": items,
                    "want_ack": bool(self.bp),
                })
            except BaseException as e:  # noqa: BLE001 - surfaced to the producer
                with self._cond:
                    self.error = e
                    self._pump_armed = False
                    self._cond.notify_all()
                self._aev.set()
                return


class CoreWorker:
    def __init__(self, mode: str, controller_addr: str, config: Config | None = None):
        self.mode = mode  # "driver" | "worker"
        self.controller_addr = controller_addr
        self.config = config or Config().apply_env()
        self.worker_id = os.environ.get("RAYTPU_WORKER_ID", WorkerID.from_random().hex())
        self.node_id = os.environ.get("RAYTPU_NODE_ID", "")
        self.job_id = JobID.nil()
        self.loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self.server = rpc.RpcServer(self, host=self.config.node_ip)
        self.address = ""
        self.controller: rpc.Connection | None = None
        self.daemon: rpc.Connection | None = None
        self.daemon_addr = os.environ.get("RAYTPU_DAEMON_ADDR", "")
        self.store: SharedMemoryClient | None = None
        self.memory_store = MemoryStore()
        self.owned: dict[ObjectID, OwnedObject] = {}
        self._peer_conns: dict[str, rpc.Connection] = {}
        self._daemon_conns: dict[str, rpc.Connection] = {}
        self._submitters: dict[str, _KeySubmitter] = {}
        self._exported: set[str] = set()
        self._fn_cache: dict[str, Any] = {}
        self._actor_runtime: Optional["ActorRuntime"] = None
        self._actor_send_queues: dict = {}
        self._actor_conns: dict[ActorID, dict] = {}  # actor_id -> {addr, conn, info}
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="raytpu-exec")
        self._shutdown = False
        # Strong refs to fire-and-forget tasks (asyncio tracks tasks only
        # weakly; a gc cycle landing mid-await kills an unreferenced task
        # with GeneratorExit — the init-task bug class). Everything spawned
        # fire-and-forget on this worker's loop goes through _spawn_bg.
        self._bg_tasks: set = set()
        # Submitted-task dependency pins: holding the ObjectRef objects keeps
        # their refcount registrations alive until the task completes
        # (reference: ReferenceCounter "submitted task references",
        # reference_counter.h:44).
        self._inflight_deps: dict[bytes, list] = {}
        # Lineage: specs (+ pinned dep refs) of finished normal tasks whose
        # shm-resident returns may need re-execution if every copy is lost
        # (reference: TaskManager lineage, task_manager.h:184-217; capped by
        # lineage_max_bytes with oldest-first eviction).
        self._lineage: dict[bytes, tuple[TaskSpec, list, int]] = {}
        self._lineage_bytes = 0
        # In-flight recoveries, one future per object so concurrent getters
        # coalesce (reference: ObjectRecoveryManager idempotent per-object ops,
        # object_recovery_manager.h:62-76).
        self._recovering: dict[bytes, asyncio.Future] = {}
        self._bg: list[asyncio.Task] = []
        # Pubsub subscriptions: channel -> callback(key, data). Re-subscribed
        # on every controller (re)connect (reference: subscribers re-establish
        # long-poll streams after GCS restart).
        self._pub_handlers: dict[str, Any] = {}
        # Live streaming-generator tasks this process submitted:
        # task_id bytes -> ObjectRefGenerator (reference: TaskManager's
        # streaming-generator return bookkeeping).
        self._streaming: dict[bytes, "ObjectRefGenerator"] = {}
        # Executor side: per-stream batch shipper (bounded buffer + pump).
        self._stream_shippers: dict[bytes, "_StreamShipper"] = {}
        # Early-close discards, folded in at stream cleanup (the per-shipper
        # tallies die with their streams; this survives for /metrics).
        self._stream_items_dropped = 0
        # Caller side: the conn each live stream was pushed over, so a
        # consumer close can reach the producing worker (reference:
        # CoreWorkerService.CancelTask applied to streaming generators).
        self._stream_conns: dict[bytes, Any] = {}
        # Executor side: streams whose consumer closed early; the producer
        # stops at its next yield.
        self._cancelled_streams: set[bytes] = set()
        self._live_streams: set[bytes] = set()  # streaming tasks currently executing
        # Transient shm objects (dag zero-copy edges) whose delete was
        # deferred because a consumer view still pins them; reaped later.
        self._shm_garbage: list[ObjectID] = []
        self.task_events: list[dict] = []  # per-task event buffer (task_event_buffer.h equiv)
        self._events_reported = 0  # high-water mark shipped to the controller
        self._events_dropped = 0  # events discarded by buffer trims (observable loss)
        self._events_flush_lock = asyncio.Lock()
        self._event_flush_armed = False  # debounced lifecycle-event flush timer
        # Borrowed-object table: oid bytes -> {"owner_addr", "refs"} — the
        # borrower half of the ownership picture memory_summary reports
        # (the owner half is `owned` with its borrowers counter).
        self._borrowed: dict[bytes, dict] = {}
        # Object-store access counters (plain ints: no lock on the get/put
        # hot paths; shipped as counter series by the metrics reporter).
        self._obj_hits = 0
        self._obj_misses = 0
        self._obj_bytes_read = 0
        self._obj_bytes_written = 0
        self._current_task: Optional[TaskSpec] = None
        # Buffered cross-thread submission lane: sync callers append
        # closures; the IO loop is woken ONCE per burst instead of per call
        # (call_soon_threadsafe writes the loop's self-pipe — a syscall per
        # submission otherwise). FIFO safety: the drain callback is armed
        # before any LATER call_soon_threadsafe / run_coroutine_threadsafe
        # from the same caller thread, so everything posted before a sync
        # get/free still lands first.
        self._post_buf: collections.deque = collections.deque()
        self._post_armed = False
        self._post_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------
    def start_driver_sync(self):
        """Spin up the IO loop thread and connect (driver mode)."""
        ready = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            # Strong reference: asyncio only weakly tracks tasks, and an
            # unreferenced init task can be GC'd mid-await (GeneratorExit) —
            # observed as a flaky "driver failed to connect" when import
            # pressure shifted a gc cycle into the dial window.
            self._init_task = self.loop.create_task(self._async_init(ready))
            self.loop.run_forever()

        self._loop_thread = threading.Thread(target=run, name="raytpu-io", daemon=True)
        self._loop_thread.start()
        # Generous margin over the dial timeout: on a loaded single-core host
        # (CI running a full cluster per test module) registration RPCs can
        # take several seconds of scheduler delay without anything being wrong.
        # Margin covers a single-core host where a concurrent XLA compile or
        # the PREVIOUS test cluster's teardown can starve this process for
        # tens of seconds (observed in full-suite runs; the same init passes
        # instantly in isolation).
        if not ready.wait(self.config.rpc_connect_timeout_s + 160):
            raise TimeoutError("driver failed to connect to controller")

    async def _async_init(self, ready: threading.Event | None = None):
        self.address = await self.server.start()
        # Persistent controller link: a controller restart redials and (for
        # drivers) re-registers the job, keeping the same job id (reference:
        # GCS FT — clients reconnect after GCS restart).
        self.controller = rpc.PersistentConnection(
            self.controller_addr, handler=self, on_reconnect=self._controller_handshake
        )
        await self.controller.ensure()
        if self.mode == "driver":
            reply = self._register_reply
            nodes = reply["nodes"]
            # Attach to a local daemon's store if one exists on this host.
            for nid, info in nodes.items():
                if info["state"] == "ALIVE" and info["store_path"] and os.path.exists(info["store_path"]):
                    self.daemon_addr = info["address"]
                    self.node_id = nid
                    break
        if self.daemon_addr:
            self.daemon = await rpc.connect(self.daemon_addr, handler=self, timeout=self.config.rpc_connect_timeout_s)
        store_path = os.environ.get("RAYTPU_STORE_PATH", "")
        if not store_path and self.daemon is not None:
            node_info = await self.controller.call("get_cluster_state", {})
            info = node_info["nodes"].get(self.node_id)
            store_path = info["store_path"] if info else ""
        if store_path and os.path.exists(store_path):
            self.store = SharedMemoryClient(store_path, spill_dir=self.config.object_spill_dir or None)
        if self.mode == "worker":
            reply = await self.daemon.call("register_worker", {"worker_id": self.worker_id, "address": self.address})
            self.node_id = reply["node_id"]
            self.config = self.config.adopt_cluster(reply["config"])
            rpc.apply_transport_config(self.config)
            if self.config.chaos_spec:
                _chaos.install_from_json(self.config.chaos_spec)
            if self.store is not None:
                # The store client predates the config push: re-apply
                # settings that change ITS behavior (a worker without the
                # pushed spill dir could never spill under pressure).
                self.store.spill_dir = self.config.object_spill_dir or None

            # Die with the parent daemon (reference:
            # CoreWorker::ExitIfParentRayletDies, core_worker.h:1427): an
            # orphan that outlives its node would otherwise idle forever,
            # redialing a dead controller and holding memory.
            def _daemon_lost(_conn):
                if not self._shutdown:
                    logger.warning("daemon connection lost; worker exiting")
                    self._shutdown = True
                    try:
                        self.loop.call_soon(self.loop.stop)
                    except Exception:
                        pass

            self.daemon.on_close = _daemon_lost
        set_ref_hooks(self._on_ref_created, self._on_ref_removed)
        self._bg.append(asyncio.create_task(self._reaper_loop()))
        # Observability plane: point the flight recorder at the ADOPTED
        # config (a spawned worker's env defaults differ from the head's)
        # and start the loop-lag probe on this process's IO loop.
        self._setup_observability()
        if ready is not None:
            ready.set()

    def _setup_observability(self):
        cfg = self.config
        _flight.configure(
            proc_id=self.worker_id[:12],
            dump_dir=os.environ.get("RAYTPU_FLIGHT_DIR", "") or cfg.obs_flight_dir,
            capacity=cfg.obs_flight_ring,
            storm_expiries=cfg.obs_storm_expiries,
            storm_window_s=cfg.obs_storm_window_s,
        )
        loop = self.loop

        def _report_dump(path: str, trigger: str):
            # Dumps fire from arbitrary threads (qos hops, chaos sites):
            # hop to the IO loop, then best-effort notify the controller so
            # the path surfaces on /api/events. worker.death dumps skip this
            # (the process exits immediately); the daemon harvest covers them.
            def _post():
                if not self._shutdown and self.controller is not None:
                    self._spawn_bg(self.controller.notify("report_flight_dump", {
                        "proc": self.worker_id[:12], "path": path,
                        "trigger": trigger, "node_id": self.node_id,
                    }), name="flight-dump-report")

            try:
                loop.call_soon_threadsafe(_post)
            except RuntimeError:
                pass  # loop already closed: the file on disk is the artifact

        _flight.set_dump_hook(_report_dump)
        if cfg.obs_loop_probe_interval_s > 0:
            self._loop_probe = _obs_health.LoopLagProbe(
                f"core-{self.mode}",
                interval_s=cfg.obs_loop_probe_interval_s,
                spike_s=cfg.obs_loop_spike_s,
            )
            self._bg.append(asyncio.create_task(self._loop_probe.run()))
        # Continuous profiler: arm (or disarm, hz<=0) THIS process's sampler
        # with the adopted config. Also installs the tracing profile hook so
        # traced exec spans get per-trace accumulators. Idempotent across
        # controller reconnects.
        _profiler.arm(
            hz=cfg.profile_hz,
            proc=self.worker_id[:12],
            max_stacks=cfg.profile_max_stacks,
            epoch_s=cfg.profile_epoch_s,
            window_epochs=cfg.profile_window_epochs,
            max_traces=cfg.profile_max_traces,
        )

    async def _controller_handshake(self, conn):
        for channel in self._pub_handlers:
            await conn.call("subscribe", {"channel": channel})
        if self.mode != "driver":
            return  # workers register with their daemon, not the controller
        payload = {"driver_addr": self.address}
        if not self.job_id.is_nil():
            payload["job_id"] = self.job_id.binary()  # reconnect: keep the job
        reply = await conn.call("register_job", payload)
        self.job_id = JobID(reply["job_id"])
        self.config = Config.from_dict(reply["config"])
        if self.config.chaos_spec:
            # Driver adopts the cluster chaos schedule with the rest of the
            # config (idempotent re-install across controller reconnects).
            _chaos.install_from_json(self.config.chaos_spec)
        if self.store is not None:
            self.store.spill_dir = self.config.object_spill_dir or None
        self._register_reply = reply

    async def subscribe_channel(self, channel: str, callback):
        """Subscribe to a controller pubsub channel; callback(key, data) runs
        on the IO loop for every publish."""
        self._pub_handlers[channel] = callback
        await self.controller.call("subscribe", {"channel": channel})

    def handle_pub(self, conn, p):
        cb = self._pub_handlers.get(p.get("channel"))
        if cb is not None:
            cb(p.get("key"), p.get("data"))

    def attach_loop(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop

    async def _reaper_loop(self):
        last_metrics = 0.0
        while not self._shutdown:
            await asyncio.sleep(0.5)
            for sub in list(self._submitters.values()):
                await sub.reap_idle(linger_s=2.0)
            if self._shm_garbage and self.store is not None:
                self._shm_garbage = [o for o in self._shm_garbage if not self.store.reap(o)]
            now = time.monotonic()
            if now - last_metrics >= self.config.metrics_report_interval_s:
                last_metrics = now
                await self._report_metrics()

    async def _report_metrics(self):
        """Ship this process's metric series + new task events to the
        controller (reference: per-node agent scrape -> dashboard, and the
        TaskEventBuffer -> GcsTaskManager pipeline, task_event_buffer.h)."""
        try:
            series = _metrics.snapshot() + self._runtime_series()
            if series:
                await self.controller.notify("report_metrics", {"reporter": self.worker_id, "series": series})
        except Exception:
            pass
        await self._flush_task_events()

    def _runtime_series(self) -> list[dict]:
        """First-class runtime metrics that live outside the user registry:
        RPC envelope/byte counters (rpc.metrics_series), queue-depth gauges,
        object-store access counters, dropped-event counters. Records are
        snapshot()-shaped so they merge through the same controller
        pipeline."""
        now = time.time()
        out = rpc.metrics_series()

        def rec(name, kind, value, tags, desc=""):
            out.append({"name": name, "kind": kind, "description": desc,
                        "tags": tags, "value": float(value), "ts": now})

        rec("scheduler.queue.depth", "gauge",
            sum(len(s.queue) for s in self._submitters.values()),
            {"queue": "submitter"}, "task specs queued awaiting worker leases")
        rec("scheduler.queue.depth", "gauge",
            sum(q.qsize() for q in self._actor_send_queues.values()),
            {"queue": "actor_pump"}, "actor tasks buffered in send pumps")
        rec("object.store.ops", "counter", self._obj_hits,
            {"result": "hit"}, "object reads resolved from local memory/shm")
        rec("object.store.ops", "counter", self._obj_misses,
            {"result": "miss"}, "object reads that needed a remote fetch/recovery")
        rec("object.store.bytes", "counter", self._obj_bytes_read,
            {"op": "read"}, "object bytes read locally")
        rec("object.store.bytes", "counter", self._obj_bytes_written,
            {"op": "write"}, "object bytes written by put/task returns")
        if self._events_dropped:
            rec("events_dropped_total", "counter", self._events_dropped,
                {"where": "worker"}, "task events lost to buffer trims before reporting")
        fr = _flight.recorder()
        if fr.events_evicted:
            rec("flight.events_evicted", "counter", fr.events_evicted, {},
                "flight-recorder ring evictions (oldest events displaced)")
        if fr.dumps_written:
            rec("flight.dumps_written", "counter", fr.dumps_written, {},
                "flight-recorder dumps written by this process")
        ps = _profiler.status()
        if ps["samples"]:
            rec("profile.samples", "counter", ps["samples"], {},
                "wall-clock sampler stacks folded by this process")
        if ps["samples_dropped"]:
            rec("profile.samples_dropped", "counter", ps["samples_dropped"], {},
                "sampler stacks rejected by the bounded distinct-stack table")
        # Device-side cost gauges: jax local_devices() memory stats, gated
        # hard (never imports jax; CPU backends report None and emit nothing).
        out.extend(_profiler.device_memory_records(now))
        if _STREAM_BATCH_HIST:
            # Streamed-item batch-size histogram (owner side): how many items
            # each generator_items frame carried — the live-cluster view of
            # the streaming fast lane's coalescing (mirrors rpc.envelope.messages).
            counts = [0] * (len(_STREAM_BATCH_BUCKETS) + 1)
            total, n_frames = 0.0, 0
            for size, cnt in _STREAM_BATCH_HIST.items():
                # Same bucket convention as util.metrics._observe_locked.
                counts[bisect.bisect_left(_STREAM_BATCH_BUCKETS, size)] += cnt
                total += size * cnt
                n_frames += cnt
            out.append({
                "name": "stream.batch.items", "kind": "histogram",
                "description": "items coalesced per generator_items batch frame",
                "tags": {}, "value": 0.0, "ts": now,
                "buckets": list(_STREAM_BATCH_BUCKETS), "counts": counts,
                "sum": total, "n": n_frames,
            })
        if self._stream_items_dropped:
            rec("stream.items_dropped", "counter", self._stream_items_dropped, {},
                "buffered stream items discarded when the consumer closed early")
        # chaos.injected_total{site,kind}: THIS process's injections (driver,
        # spawned worker, or in-process daemons co-resident with a driver) —
        # no silent injection, every fault reaches /metrics.
        out.extend(_chaos.metrics_series())
        return out

    async def _flush_task_events(self):
        # Serialize flushes: the periodic reporter and on-demand
        # tracing.get_task_events() flush can interleave at the awaits,
        # double-sending one slice and never sending the next.
        async with self._events_flush_lock:
            try:
                mark = self._events_reported
                new = self.task_events[mark:]
                if new:
                    await self.controller.notify(
                        "report_task_events", {"reporter": self.worker_id, "events": new}
                    )
                    # Commit only AFTER the send: a failed report (controller
                    # down) must retry these events next tick. Recompute against
                    # the current mark — a concurrent trim may have shifted it.
                    self._events_reported = min(self._events_reported + len(new), len(self.task_events))
            except Exception:
                pass

    def shutdown_sync(self):
        if self._shutdown or self.loop is None:
            return
        self._shutdown = True
        set_ref_hooks(None, None)

        async def _stop():
            for sub in self._submitters.values():
                for w in list(sub.workers):
                    await sub._drop_worker(w)
            await self.server.close()
            for c in list(self._peer_conns.values()) + list(self._daemon_conns.values()):
                await c.close()
            if self.controller:
                await self.controller.close()
            if self.daemon:
                await self.daemon.close()
            for t in asyncio.all_tasks():
                if t is not asyncio.current_task():
                    t.cancel()

        # Stop the loop only AFTER _stop()'s result has been delivered back
        # to this thread: loop.stop() inside the coroutine halts the loop
        # before run_coroutine_threadsafe's done-callback can run, so
        # .result() would always ride out its full timeout.
        try:
            asyncio.run_coroutine_threadsafe(_stop(), self.loop).result(timeout=5)
        except Exception:
            pass
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=2)
        self._executor.shutdown(wait=False)

    # -- helpers --------------------------------------------------------
    def _post_to_loop(self, fn):
        """Queue ``fn`` to run on the IO loop, coalescing wakeups: a burst
        of submissions from a sync caller pays one self-pipe write, not one
        per call. Posted order == execution order."""
        with self._post_lock:
            self._post_buf.append(fn)
            if self._post_armed:
                return
            self._post_armed = True
        try:
            self.loop.call_soon_threadsafe(self._drain_posts)
        except BaseException:
            # ANY scheduling failure (closed loop RuntimeError, loop-not-
            # started AttributeError) must disarm, or every later post
            # no-ops silently and gets hang instead of this loud error.
            with self._post_lock:
                self._post_armed = False
            raise

    def _drain_posts(self):
        # Loop until empty INSIDE one callback — never re-arm via call_soon.
        # The FIFO contract with later cross-thread work depends on it: a fn
        # posted while this drain runs must execute before a get/free the
        # same caller thread schedules afterwards, and a deferred re-arm
        # callback would land BEHIND that get in the ready queue. With the
        # in-callback loop, either this drain's next round picks the fn up,
        # or the post observed armed=False and scheduled a fresh drain
        # before the caller could schedule the get.
        while True:
            with self._post_lock:
                if not self._post_buf:
                    self._post_armed = False
                    return
                fns = list(self._post_buf)
                self._post_buf.clear()
            for fn in fns:
                try:
                    fn()
                except Exception:  # isolate: one bad post must not drop the rest
                    logger.exception("posted submission callback failed")

    def _spawn_bg(self, coro, name: str | None = None) -> "asyncio.Task":
        """create_task with a strong reference held until completion (see
        _bg_tasks: an unreferenced fire-and-forget task can be GC-killed
        mid-await). Must be called from the IO loop."""
        return _spawn_bg_task(self._bg_tasks, coro, name=name)

    def _run(self, coro, timeout=None):
        """Run a coroutine on the IO loop from a sync context."""
        if self.loop is None:
            raise RuntimeError("core worker not started")
        if threading.current_thread() is self._loop_thread or (
            self._loop_thread is None and threading.current_thread() is threading.main_thread() and self.mode == "worker"
        ):
            raise RuntimeError("cannot block the IO loop thread with a sync call")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            # Since 3.11 this is the builtin TimeoutError, so it also catches a
            # TimeoutError subclass the coroutine raised itself (a typed
            # qos.DeadlineExceeded from a remote task): re-raise that as is.
            # Only a wait that ran out while the future is pending is ours.
            if fut.done():
                return fut.result()
            fut.cancel()
            raise GetTimeoutError(f"timed out after {timeout}s")

    async def _peer_conn(self, addr: str) -> rpc.Connection:
        conn = self._peer_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(addr, handler=self, timeout=self.config.rpc_connect_timeout_s, retry=False)
            self._peer_conns[addr] = conn
        return conn

    async def _daemon_conn(self, addr: str) -> rpc.Connection:
        if addr == self.daemon_addr and self.daemon is not None and not self.daemon.closed:
            return self.daemon
        conn = self._daemon_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(addr, handler=self, timeout=self.config.rpc_connect_timeout_s, retry=False)
            self._daemon_conns[addr] = conn
        return conn

    def _event(self, kind: str, **kw):
        # One timeline: the same clock as Span/event() in util/tracing, so
        # state-index timings and span timings interleave consistently.
        ev = {"ts": _tracing.now(), "kind": kind, "worker": self.worker_id[:12], **kw}
        self.task_events.append(ev)
        # Tee into the process-local flight recorder: the reporter buffer
        # above trims once shipped, the ring RETAINS (bounded) so a dump at
        # death still holds the recent story. Same dict, no copy.
        _flight.absorb(ev)
        if len(self.task_events) > self.config.event_buffer_size:
            trimmed = len(self.task_events) // 2
            # Only events the controller never saw are LOST; already-reported
            # ones were shipped before the trim.
            self._events_dropped += max(0, trimmed - self._events_reported)
            del self.task_events[:trimmed]
            self._events_reported = max(0, self._events_reported - trimmed)

    def _task_event(self, kind: str, spec: TaskSpec, **kw):
        """Emit one task-lifecycle FSM event (task_state.EVENT_STATE keys
        it to a transition) carrying the attempt number and attribution the
        controller's per-task index folds. Gated by task_events_enabled so
        the state pipeline can be A/B'd off; always called on the IO loop."""
        if not self.config.task_events_enabled and spec.trace_ctx is None:
            return  # traced events still flow: tracing must survive the A/B flag
        fields = {
            "task_id": spec.task_id.hex(),
            "attempt": getattr(spec, "_attempts", 0),
            "fn": _spec_fn_name(spec),
            "job": spec.job_id.hex(),
        }
        tc = spec.trace_ctx
        if tc is not None:
            fields["trace_id"], fields["parent_id"] = tc[0], tc[1]
        fields.update(kw)
        self._event(kind, **fields)
        self._arm_event_flush()

    def _arm_event_flush(self):
        """Debounced early flush: lifecycle transitions reach the controller
        within task_event_flush_interval_s instead of riding the (much
        slower) metrics tick, so `raytpu list tasks --state RUNNING` sees a
        task soon after it starts. One timer per window, not per event."""
        if self._event_flush_armed or self._shutdown:
            return
        self._event_flush_armed = True
        try:
            self.loop.call_later(
                self.config.task_event_flush_interval_s, self._event_flush_fire
            )
        except Exception:
            self._event_flush_armed = False

    def _event_flush_fire(self):
        self._event_flush_armed = False
        if not self._shutdown:
            self._spawn_bg(self._flush_task_events())

    # -- ownership / refcounting ---------------------------------------
    def _on_ref_created(self, ref: ObjectRef):
        if self._shutdown or self.loop is None:
            return
        if ref.owner_addr == self.address:
            rec = self.owned.get(ref.id)
            if rec is not None:
                rec.local_refs += 1
        else:
            try:
                self.loop.call_soon_threadsafe(self._notify_owner, ref.owner_addr, "add_borrow", ref.id.binary())
            except RuntimeError:
                pass

    def _on_ref_removed(self, ref: ObjectRef):
        if self._shutdown or self.loop is None:
            return
        try:
            if ref.owner_addr == self.address:
                self.loop.call_soon_threadsafe(self._dec_local_ref, ref.id)
            else:
                self.loop.call_soon_threadsafe(self._notify_owner, ref.owner_addr, "remove_borrow", ref.id.binary())
        except RuntimeError:
            pass

    def _notify_owner(self, owner_addr: str, method: str, oid_bin: bytes):
        # Borrower-side ledger (runs on the IO loop, FIFO with the notify):
        # memory_summary reports who this process borrows from, mirroring
        # the owner's borrowers counter.
        if method == "add_borrow":
            ent = self._borrowed.get(oid_bin)
            if ent is None:
                ent = self._borrowed[oid_bin] = {"owner_addr": owner_addr, "refs": 0}
            ent["refs"] += 1
        elif method == "remove_borrow":
            ent = self._borrowed.get(oid_bin)
            if ent is not None:
                ent["refs"] -= 1
                if ent["refs"] <= 0:
                    del self._borrowed[oid_bin]

        async def go():
            try:
                conn = await self._peer_conn(owner_addr)
                await conn.notify(method, {"oid": oid_bin})
            except Exception:
                pass

        self._spawn_bg(go())

    def _dec_local_ref(self, oid: ObjectID):
        rec = self.owned.get(oid)
        if rec is None:
            return
        rec.local_refs -= 1
        self._maybe_free(oid, rec)

    def handle_add_borrow(self, conn, p):
        rec = self.owned.get(ObjectID(p["oid"]))
        if rec is not None:
            rec.borrowers += 1
        return True

    def handle_remove_borrow(self, conn, p):
        oid = ObjectID(p["oid"])
        rec = self.owned.get(oid)
        if rec is not None:
            rec.borrowers -= 1
            self._maybe_free(oid, rec)
        return True

    def _maybe_free(self, oid: ObjectID, rec: OwnedObject):
        if rec.local_refs <= 0 and rec.borrowers <= 0 and rec.state != "PENDING":
            self.owned.pop(oid, None)
            self.memory_store.delete(oid)
            if rec.in_shm:
                self._spawn_bg(self._free_remote(oid))
            self._maybe_release_lineage(oid)

    def _maybe_release_lineage(self, oid: ObjectID):
        """Drop a task's lineage once none of its returns are referenced
        (reference: ReferenceCounter-driven lineage release)."""
        if oid.is_put():
            return
        tid = oid.task_id()
        entry = self._lineage.get(tid.binary())
        if entry is None:
            return
        spec, _deps, cost = entry
        if any(ObjectID.for_return(tid, i) in self.owned for i in range(spec.num_returns)):
            return
        del self._lineage[tid.binary()]
        self._lineage_bytes -= cost

    async def _free_remote(self, oid: ObjectID):
        try:
            await self.controller.call("free_objects", {"oids": [oid.binary()]})
        except Exception:
            pass

    def _register_owned(self, oid: ObjectID, state="PENDING", **kw) -> OwnedObject:
        rec = self.owned.get(oid)
        if rec is None:
            rec = OwnedObject(state=state, ready_event=asyncio.Event(), **kw)
            self.owned[oid] = rec
        return rec

    def _fail_task_returns(self, spec: TaskSpec, err: BaseException):
        self._inflight_deps.pop(spec.task_id.binary(), None)
        # Terminal failure without a reply (infeasible demand, retries
        # exhausted, actor death, dep-resolution failure).
        self._task_event("task_failed", spec, error_type=_error_type(err))
        if spec.num_returns == -1:
            gen = self._streaming.pop(spec.task_id.binary(), None)
            if gen is not None:
                gen._finish(error=err)
            return
        for i in range(spec.num_returns):
            self._mark_ready(ObjectID.for_return(spec.task_id, i), size=0, in_memory=False, in_shm=False, error=err)

    def _mark_ready(self, oid: ObjectID, *, size: int, in_memory: bool, in_shm: bool, error: BaseException | None = None):
        rec = self._register_owned(oid)
        rec.state = "FAILED" if error is not None else "READY"
        rec.size = size
        rec.in_memory = in_memory
        rec.in_shm = in_shm
        rec.error = error
        if rec.ready_event:
            rec.ready_event.set()
        self._maybe_free(oid, rec)

    # -- put / get / wait ----------------------------------------------
    def put_sync(self, value: Any) -> ObjectRef:
        """Owner-side put without blocking on the IO loop: serialization and
        the store write happen on the caller's thread (both stores are
        thread-safe); ownership registration is queued to the loop FIFO, so it
        lands before any subsequent get/free touching the same object."""
        oid = ObjectID.from_put()
        parts, _refs, total = serialization.serialize_parts(value)
        in_shm = self.store is not None and total > self.config.max_inline_object_size
        evicted: list = []
        if in_shm:
            buf, evicted = self.store.create_autoevict(oid, total)
            off = 0
            for part in parts:  # scatter-write: no intermediate join copy
                n = len(part)
                buf[off : off + n] = part
                off += n
            del buf
            self.store.seal(oid)
        else:
            self.memory_store.put(oid, b"".join(parts))
        self._obj_bytes_written += total

        def _commit():
            rec = self._register_owned(oid)
            rec.local_refs += 1
            self._mark_ready(oid, size=total, in_memory=not in_shm, in_shm=in_shm)
            if in_shm:
                self._spawn_bg(self._report_shm_put(oid, total, evicted))

        self._post_to_loop(_commit)
        ref = ObjectRef(oid, self.address, total, _register=False)
        ref._registered = True
        return ref

    async def _report_shm_put(self, oid: ObjectID, size: int, evicted: list):
        if evicted:
            await self._report_evicted(evicted)
        try:
            if self.daemon is not None:
                await self.daemon.notify("report_sealed", {"oid": oid.binary(), "size": size})
            else:
                await self.controller.notify("report_object", {"oid": oid.binary(), "node_id": self.node_id, "size": size})
        except Exception:
            pass

    async def put_async(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_put()
        data, _refs = serialization.serialize(value)
        rec = self._register_owned(oid)
        # Pre-pin before marking ready, else _maybe_free could reap the object
        # in the window before the returned ObjectRef registers itself.
        rec.local_refs = 1
        if self.store is not None and len(data) > self.config.max_inline_object_size:
            await self._write_shm(oid, data)
            self._mark_ready(oid, size=len(data), in_memory=False, in_shm=True)
        else:
            self.memory_store.put(oid, data)
            self._obj_bytes_written += len(data)
            self._mark_ready(oid, size=len(data), in_memory=True, in_shm=False)
        ref = ObjectRef(oid, self.address, len(data), _register=False)
        ref._registered = True
        return ref

    async def _write_shm(self, oid: ObjectID, data: bytes):
        buf, evicted = self.store.create_autoevict(oid, len(data))
        buf[:] = data
        del buf
        self.store.seal(oid)
        self._obj_bytes_written += len(data)
        if evicted:
            await self._report_evicted(evicted)
        if self.daemon is not None:
            await self.daemon.notify("report_sealed", {"oid": oid.binary(), "size": len(data)})
        else:
            await self.controller.notify("report_object", {"oid": oid.binary(), "node_id": self.node_id, "size": len(data)})

    async def _report_evicted(self, evicted: list[ObjectID]):
        try:
            await self.controller.notify(
                "report_objects_evicted", {"oids": [o.binary() for o in evicted], "node_id": self.node_id}
            )
        except Exception:
            pass

    def get_sync(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        refs = list(refs)
        # Fast path: values already resident on this host (owner memory store
        # or the local shm arena) deserialize on the caller's thread with no
        # IO-loop round trip — the common case for owner-side gets of finished
        # results (reference: CoreWorkerMemoryStore GetIfExists fast path).
        out: list = []
        for r in refs:
            v = self._try_local_value(r)
            if v is _MISS:
                break
            out.append(v)
        else:
            return out[0] if single else out
        # Keep already-deserialized prefix values; only the remainder goes
        # through the IO loop.
        out = out + self._run(self._get_many(refs[len(out):]), timeout=timeout)
        return out[0] if single else out

    def _try_local_value(self, ref: ObjectRef):
        """Return the deserialized value if locally resident, else _MISS.
        Thread-safe: MemoryStore and SharedMemoryClient both lock internally;
        `owned` is only read (GIL-atomic) to avoid error-state misreads."""
        oid = ref.id
        data = self.memory_store.get(oid)
        if data is None:
            if ref.owner_addr == self.address:
                # Owner-local: the record is authoritative. PENDING, FAILED,
                # or registration still queued on the IO loop (rec None —
                # submit_actor_task_sync registers via the posted-submission
                # lane, and the caller's get usually beats it) must NOT probe the
                # shm arena: a futile get_pinned + spill-restore stat per
                # call was the sync-call hot path's biggest syscall cost.
                rec = self.owned.get(oid)
                if rec is None or rec.state != "READY":
                    return _MISS  # the slow path waits/raises as appropriate
            if self.store is None:
                return _MISS
            data = self._read_shm(oid)
            if data is None:
                return _MISS
        self._obj_hits += 1
        self._obj_bytes_read += len(data)
        return self._deserialize_value(data)

    async def get_async(self, ref: ObjectRef):
        return (await self._get_many([ref]))[0]

    async def _get_many(self, refs: list[ObjectRef]):
        return await asyncio.gather(*(self._get_one(r) for r in refs))

    async def _get_one(self, ref: ObjectRef, _depth: int = 0):
        oid = ref.id
        # 1. in-process memory store
        data = self.memory_store.get(oid)
        if data is not None:
            self._obj_hits += 1
            self._obj_bytes_read += len(data)
            return self._deserialize_value(data)
        # 2. owned & pending -> wait for completion
        rec = self.owned.get(oid)
        if rec is not None and ref.owner_addr == self.address:
            if rec.state == "PENDING":
                await rec.ready_event.wait()
                rec = self.owned.get(oid) or rec
            if rec.state == "FAILED":
                err = rec.error if rec.error is not None else RemoteError("task failed")
                if isinstance(err, RemoteError) and err.cause is not None:
                    raise err.cause
                raise err
            data = self.memory_store.get(oid)
            if data is not None:
                self._obj_hits += 1
                self._obj_bytes_read += len(data)
                return self._deserialize_value(data)
        # 3. local shared memory
        data = self._read_shm(oid)
        if data is not None:
            self._obj_hits += 1
            self._obj_bytes_read += len(data)
            return self._deserialize_value(data)
        # 4. borrowed -> ask the owner (a local miss from here on)
        self._obj_misses += 1
        if ref.owner_addr and ref.owner_addr != self.address:
            try:
                conn = await self._peer_conn(ref.owner_addr)
                reply = await conn.call("get_owned", {"oid": oid.binary()})
            except (rpc.ConnectionLost, rpc.RpcError):
                reply = None
            if reply is not None:
                if "error" in reply:
                    raise reply["error"]
                if "inline" in reply:
                    return self._deserialize_value(reply["inline"])
                if reply.get("in_shm") and await self._pull_to_local(oid, reply.get("locations")):
                    data = self._read_shm(oid)
                    if data is not None:
                        return self._deserialize_value(data)
        # 5. directory fallback
        if self.store is not None and await self._pull_to_local(oid):
            data = self._read_shm(oid)
            if data is not None:
                return self._deserialize_value(data)
        # 6. every copy is gone: recover via lineage re-execution (owner-side;
        # borrowers ask the owner) — reference: ObjectRecoveryManager
        # (object_recovery_manager.h:41) + TaskManager resubmit (task_manager.h:184).
        if _depth < 3 and await self._try_recover(ref):
            return await self._get_one(ref, _depth + 1)
        raise ObjectLostError(f"object {oid.hex()} is unavailable (owner {ref.owner_addr} unreachable or value lost)")

    async def _ensure_dep_available(self, d) -> None:
        """Best-effort: make sure a dependency's payload exists somewhere in
        the cluster, recovering it via its owner if every copy is gone."""
        if not isinstance(d, ObjectRef):
            return
        oid = d.id
        if self.memory_store.contains(oid):
            return
        rec = self.owned.get(oid) if d.owner_addr == self.address else None
        if rec is not None and rec.in_memory:
            return
        if self.store is not None and self.store.contains_or_spilled(oid):
            return
        locs = await self.controller.call("lookup_object", {"oid": oid.binary()})
        if locs:
            return
        await self._try_recover(d)

    async def _try_recover(self, ref: ObjectRef) -> bool:
        if ref.owner_addr == self.address:
            return await self._recover_object(ref.id)
        if ref.owner_addr:
            try:
                conn = await self._peer_conn(ref.owner_addr)
                return bool(await conn.call("recover_object", {"oid": ref.id.binary()}))
            except Exception:
                return False
        return False

    async def handle_recover_object(self, conn, p):
        return await self._recover_object(ObjectID(p["oid"]))

    async def _recover_object(self, oid: ObjectID) -> bool:
        key = oid.binary()
        pending = self._recovering.get(key)
        if pending is not None:  # coalesce concurrent recoveries of one object
            return await asyncio.shield(pending)
        fut = asyncio.get_running_loop().create_future()
        self._recovering[key] = fut
        ok = False
        try:
            ok = await self._recover_impl(oid)
        except Exception as e:
            logger.warning("recovery of %s failed: %s", oid.hex()[:10], e)
        finally:
            # Resolve the future even on cancellation (e.g. a get() timeout
            # cancels this coroutine) or coalesced waiters hang forever.
            self._recovering.pop(key, None)
            if not fut.done():
                fut.set_result(ok)
        return ok

    async def _recover_impl(self, oid: ObjectID) -> bool:
        # Copy-hunting first: a surviving replica beats re-execution
        # (object_recovery_manager.h:62 pins other copies before lineage).
        if self.store is not None and await self._pull_to_local(oid) and self.store.contains_or_spilled(oid):
            return True
        if oid.is_put():
            return False  # ray.put objects have no producing task
        entry = self._lineage.get(oid.task_id().binary())
        if entry is None:
            return False
        spec, deps, _cost = entry
        retries = spec.options.max_retries
        if retries == -1:
            retries = self.config.max_task_retries_default
        attempts = getattr(spec, "_recoveries", 0)
        if attempts >= retries:  # max_retries=0 => never re-execute (non-idempotent task)
            return False
        spec._recoveries = attempts + 1  # type: ignore[attr-defined]
        # Flip every return of the task back to PENDING so getters re-block on
        # a fresh event while the task re-executes.
        for i in range(spec.num_returns):
            rec = self.owned.get(ObjectID.for_return(spec.task_id, i))
            if rec is not None:
                rec.state = "PENDING"
                rec.ready_event = asyncio.Event()
        logger.warning(
            "object %s lost; re-executing task %s from lineage (attempt %d)",
            oid.hex()[:10],
            spec.task_id.hex()[:8],
            attempts + 1,
        )
        self._event("object_recovery", oid=oid.hex(), task_id=spec.task_id.hex())
        # Reconstruct lost dependencies bottom-up BEFORE resubmitting: the
        # re-executed task would otherwise discover the loss mid-execution
        # while holding its resources — deadlock when the dep's re-execution
        # needs those same resources (the reference resolves/pulls args before
        # the lease grant for the same reason, dependency_resolver.h).
        for d in deps:
            try:
                await self._ensure_dep_available(d)
            except Exception:
                pass
        await self._submit(spec, list(deps))
        rec = self.owned.get(oid)
        if rec is None:
            return False
        await rec.ready_event.wait()
        return rec.state == "READY"

    def _read_shm(self, oid: ObjectID):
        """Read an object payload out of the shared-memory arena.

        Zero-copy: returns a PinnedBuffer whose eviction pin lives as long
        as any view deserialization derives from it (ndarrays reconstructed
        from pickle-5 out-of-band buffers wrap the arena pages directly; the
        pin drops when the last one is collected). Spilled objects come back
        as plain bytes off disk.
        """
        if self.store is None:
            return None
        buf = self.store.get_pinned(oid)
        if buf is None:  # spilled? restore (or read straight off disk if full)
            evicted: list = []
            restored = self.store.restore(oid, evicted_out=evicted)
            if evicted:
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    loop = None
                if loop is self.loop:
                    _spawn_bg_task(self._bg_tasks, self._report_evicted(evicted), loop=loop)
                elif self.loop is not None:
                    # Caller-thread path — including a DIFFERENT running
                    # loop (user code driving its own asyncio loop calls a
                    # sync get): the report must run on the worker IO loop,
                    # where the controller connection lives.
                    asyncio.run_coroutine_threadsafe(self._report_evicted(evicted), self.loop)
            if restored:
                buf = self.store.get_pinned(oid)
            else:
                return self.store.read_spilled(oid)
        return buf

    async def _pull_to_local(self, oid: ObjectID, locations: list | None = None) -> bool:
        if self.daemon is None:
            return False
        payload: dict = {"oid": oid.binary()}
        if locations:
            # Owner-supplied replica hints close the freshly-sealed race (the
            # directory may not have absorbed report_object yet) and save a
            # controller lookup.
            payload["locations"] = locations
        try:
            with _tracing.child_span("object.pull.wait", oid=oid.hex()[:16]):
                # Capture the trace ctx INSIDE the wait span so the daemon's
                # object.pull span nests under it rather than beside it.
                tc = _tracing.current_trace()
                if tc is not None:
                    payload["tc"] = tc
                reply = await self.daemon.call("pull_object", payload)
            return bool(reply.get("ok"))
        except Exception:
            return False

    def _deserialize_value(self, data):
        value = serialization.deserialize(data)
        if isinstance(value, RemoteError):
            raise value.cause if value.cause is not None else value
        return value

    async def handle_get_owned(self, conn, p):
        """Serve an owned object to a borrower (ownership protocol; the
        reference resolves via OwnershipObjectDirectory + plasma promotion)."""
        oid = ObjectID(p["oid"])
        rec = self.owned.get(oid)
        if rec is None:
            data = self.memory_store.get(oid)
            if data is not None:
                return await self._inline_or_promote(oid, data)
            return None
        if rec.state == "PENDING":
            await rec.ready_event.wait()
            rec = self.owned.get(oid) or rec
        if rec.state == "FAILED":
            return {"error": rec.error}
        data = self.memory_store.get(oid)
        if data is not None:
            return await self._inline_or_promote(oid, data)
        # locations: the freshly-sealed report_object may still be in flight
        # to the directory; hand the borrower this node directly.
        return {"in_shm": True, "locations": self._shm_locations()}

    def _shm_locations(self) -> list:
        return [{"node_id": self.node_id, "address": self.daemon_addr}] if self.daemon_addr else []

    async def _inline_or_promote(self, oid: ObjectID, data) -> dict:
        """Small memory-store objects ship inline in the reply; anything over
        a chunk promotes to the shm arena so the borrower takes the streaming
        pull path instead of receiving megabytes pickled inside one RPC."""
        if self.store is None or self.daemon is None or len(data) <= self.config.object_chunk_size:
            return {"inline": bytes(data)}
        rec = self.owned.get(oid)
        if rec is not None and rec.in_shm:
            # Already promoted by an earlier borrower: don't re-put (raises
            # ObjectExistsError) or re-announce the location per request.
            return {"in_shm": True, "locations": self._shm_locations()}
        if await self._promote_to_shm(oid, data):
            return {"in_shm": True, "locations": self._shm_locations()}
        return {"inline": bytes(data)}

    async def _promote_to_shm(self, oid: ObjectID, data) -> bool:
        announce = True
        try:
            evicted = self.store.put(oid, data)
        except ObjectExistsError:
            evicted = []  # already promoted (concurrent borrowers)
            announce = False
        except ObjectStoreFullError:
            return False  # arena can't take it: fall back to inline
        if evicted:
            await self._report_evicted(evicted)
        rec = self.owned.get(oid)
        if rec is not None:
            rec.in_shm = True
        if announce and self.daemon is not None:
            await self.daemon.notify("report_sealed", {"oid": oid.binary(), "size": len(data)})
        return True

    async def handle_wait_owned(self, conn, p):
        oid = ObjectID(p["oid"])
        rec = self.owned.get(oid)
        if rec is None:
            return self.memory_store.contains(oid) or (self.store is not None and self.store.contains_or_spilled(oid))
        if rec.state == "PENDING":
            try:
                await asyncio.wait_for(rec.ready_event.wait(), timeout=p.get("timeout", 30.0))
            except asyncio.TimeoutError:
                return False
        return True

    def wait_sync(self, refs: list[ObjectRef], num_returns: int, timeout: float | None):
        return self._run(self.wait_async(refs, num_returns, timeout))

    async def wait_async(self, refs: list[ObjectRef], num_returns: int, timeout: float | None):
        """Event-driven wait: owner-local refs block on their ready_event,
        borrowed refs park one wait_owned RPC on the owner (which blocks
        server-side on the same event) — no polling (the reference's Wait
        similarly registers memory-store futures, core_worker.h:697)."""
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")

        deadline = None if timeout is None else time.monotonic() + timeout

        async def wait_one(i: int, r: ObjectRef) -> int:
            if self.memory_store.contains(r.id):
                return i
            rec = self.owned.get(r.id)
            if rec is not None and r.owner_addr == self.address:
                if rec.state == "PENDING":
                    await rec.ready_event.wait()
                return i
            if self.store is not None and self.store.contains_or_spilled(r.id):
                return i
            if r.owner_addr and r.owner_addr != self.address:
                while True:
                    # Bound each server-side park: an abandoned client task
                    # (outer timeout) must not orphan an hour-long handler on
                    # the owner — re-arm at most every 60s.
                    remaining = 60.0 if deadline is None else max(0.05, min(60.0, deadline - time.monotonic()))
                    try:
                        conn = await self._peer_conn(r.owner_addr)
                        if await conn.call("wait_owned", {"oid": r.id.binary(), "timeout": remaining}):
                            return i
                        # Owner says unavailable (freed/lost) or parked past
                        # its window: back off; the outer deadline decides
                        # when to give up.
                        await asyncio.sleep(0.05)
                    except Exception:
                        await asyncio.sleep(self.config.rpc_retry_delay_s)
            # Unknown provenance: resolve via a full get (rare).
            await self._get_one(r)
            return i

        tasks = [asyncio.ensure_future(wait_one(i, r)) for i, r in enumerate(refs)]
        ready_idx: set[int] = set()
        pending = set(tasks)
        try:
            while pending and len(ready_idx) < num_returns:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                done, pending = await asyncio.wait(pending, timeout=remaining, return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break  # timed out
                for t in done:
                    if t.exception() is None:
                        ready_idx.add(t.result())
        finally:
            for t in pending:
                t.cancel()
            for t in tasks:
                if not t.done():
                    try:
                        await t
                    except (asyncio.CancelledError, Exception):
                        pass
                elif not t.cancelled():  # retrieve exceptions so GC doesn't log them
                    t.exception()
        ready = [refs[i] for i in sorted(ready_idx)][:num_returns]
        ready_ids = {r.id for r in ready}
        not_ready = [r for r in refs if r.id not in ready_ids]
        return ready, not_ready

    # -- function/class export -----------------------------------------
    def export_callable(self, ns: str, obj: Any) -> str:
        data = serialization.dumps_function(obj)
        key = hashlib.sha1(data + self.job_id.binary()).hexdigest()
        full = f"{ns}:{key}"
        if full not in self._exported:
            self._run(self.controller.call("kv_put", {"ns": "exports", "key": full, "value": data, "overwrite": False}))
            self._exported.add(full)
        return full

    async def _load_callable(self, key: str):
        if key in self._fn_cache:
            return self._fn_cache[key]
        data = await self.controller.call("kv_get", {"ns": "exports", "key": key})
        if data is None:
            raise RuntimeError(f"exported callable {key} not found")
        obj = serialization.loads_function(data)
        self._fn_cache[key] = obj
        return obj

    # -- task submission ------------------------------------------------
    def submit_task_sync(self, fn_id: str, args: tuple, kwargs: dict, opts: TaskOptions):
        task_id = TaskID.from_random()
        streaming = opts.num_returns == "streaming"
        n_returns = -1 if streaming else opts.num_returns
        return_refs = [] if streaming else [
            ObjectRef(ObjectID.for_return(task_id, i), self.address, _register=False) for i in range(n_returns)
        ]
        args_blob, dep_refs = serialization.serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            fn_id=fn_id,
            args_blob=args_blob,
            num_returns=n_returns,
            options=opts,
            caller_addr=self.address,
            trace_ctx=_tracing.current_trace(),  # None unless a span is active
            qos_ctx=_qos.current_wire(),  # None unless a request context is active
        )
        gen = ObjectRefGenerator(task_id, self.address) if streaming else None
        if gen is not None:
            gen._cancel = functools.partial(self.cancel_stream, task_id.binary())

        # One loop hop, no blocking: registration + submission run as a single
        # FIFO callback, so they land before any subsequent get/free from this
        # thread. Ownership records exist before the task can complete, else a
        # fast reply could free the returns before the refs pin them.
        def _go():
            if gen is not None:
                self._streaming[task_id.binary()] = gen
            self._register_returns(return_refs)
            if dep_refs:
                # FSM: the attempt exists but its args aren't resolved yet;
                # _enqueue_submit advances it to PENDING_NODE_ASSIGNMENT.
                self._task_event("task_pending_args", spec)
                self._spawn_bg(self._submit(spec, dep_refs))
            else:
                self._enqueue_submit(spec)

        self._post_to_loop(_go)
        for r in return_refs:
            r._registered = True
        return gen if streaming else return_refs

    def _register_returns(self, refs):
        for r in refs:
            rec = self._register_owned(r.id)
            rec.local_refs += 1

    async def _submit(self, spec: TaskSpec, dep_refs: list[ObjectRef]):
        self._inflight_deps[spec.task_id.binary()] = dep_refs
        # Resolve dependencies BEFORE leasing (dependency_resolver.h) so a
        # queued task never holds a worker while waiting on its args.
        await self._wait_deps(dep_refs)
        self._enqueue_submit(spec)

    def _enqueue_submit(self, spec: TaskSpec):
        """Hand the (dep-free) spec to its scheduling-key submitter. Plain
        function so the no-deps fast path skips a per-call coroutine+task."""
        fault = _chaos.maybe_inject("worker.task.submit", fn=_spec_fn_name(spec))
        if fault is not None and fault.kind == "error":
            # Submission-time failure: the task's returns fail cleanly and
            # its FSM record closes terminal (never enters a queue).
            self._fail_task_returns(spec, fault.error(f"submit {_spec_fn_name(spec)}"))
            return
        key = scheduling_key(spec.fn_id, spec.options)
        sub = self._submitters.get(key)
        if sub is None:
            sub = self._submitters[key] = _KeySubmitter(self, key, spec.options)
        fut = self.loop.create_future()
        fut.add_done_callback(lambda f: f.exception())  # results absorbed via _absorb_task_reply
        sub.queue.append((spec, fut))
        tc = spec.trace_ctx
        if tc is None:
            self._task_event("task_submitted", spec)
        else:
            # span_id rides along for export_timeline's flow arrows.
            self._task_event("task_submitted", spec, span_id=tc[1])
        sub.pump()

    async def _wait_deps(self, dep_refs: list[ObjectRef]):
        for r in dep_refs:
            rec = self.owned.get(r.id)
            if rec is not None and r.owner_addr == self.address:
                if rec.state == "PENDING":
                    await rec.ready_event.wait()
            elif r.owner_addr and r.owner_addr != self.address:
                try:
                    conn = await self._peer_conn(r.owner_addr)
                    await conn.call("wait_owned", {"oid": r.id.binary(), "timeout": 600.0})
                except Exception:
                    pass

    def _add_lineage(self, spec: TaskSpec, deps: list):
        key = spec.task_id.binary()
        if key in self._lineage:
            return
        cost = len(spec.args_blob) + 256
        self._lineage[key] = (spec, deps, cost)
        self._lineage_bytes += cost
        while self._lineage_bytes > self.config.lineage_max_bytes and self._lineage:
            k = next(iter(self._lineage))
            _, _, c = self._lineage.pop(k)
            self._lineage_bytes -= c

    def _absorb_task_reply(self, spec: TaskSpec, reply: dict, fut: asyncio.Future | None = None):
        """Record task return values from a push_task reply."""
        deps = self._inflight_deps.pop(spec.task_id.binary(), None)
        # Untraced actor SUCCESSES stay event-free: the actor call path is
        # the RPC hot row, and one task_finished per ping would both cost
        # per-call CPU and flood the controller's task index with
        # FINISHED-only records that evict real task state. Failures and
        # traced calls always report.
        if spec.actor_id is None or spec.trace_ctx is not None or reply.get("status") == "error":
            extra = {}
            if reply.get("status") == "error" and reply.get("error") is not None:
                extra["error_type"] = _error_type(reply["error"])
            self._task_event("task_finished", spec, status=reply.get("status"), **extra)
        if spec.num_returns == -1:  # streaming: items arrived via notifies
            self._stream_conns.pop(spec.task_id.binary(), None)
            gen = self._streaming.pop(spec.task_id.binary(), None)
            if gen is not None:
                if reply.get("status") == "error":
                    gen._finish(error=reply.get("error") or RemoteError("task failed"))
                else:
                    gen._finish(total=reply.get("streaming_done", 0))
            if fut is not None and not fut.done():
                fut.set_result(reply.get("status") != "error")
            return
        if reply.get("status") == "error":
            err: BaseException = reply.get("error") or RemoteError("task failed")
            for i in range(spec.num_returns):
                oid = ObjectID.for_return(spec.task_id, i)
                self._mark_ready(oid, size=0, in_memory=False, in_shm=False, error=err)
            if fut is not None and not fut.done():
                fut.set_result(False)
            return
        returns = reply.get("returns", [])
        # Shm returns can be lost (eviction, node death): retain the spec for
        # lineage re-execution. Inline returns live in the owner's memory
        # store and die with the owner, which lineage cannot help anyway.
        if any(item.get("inline") is None for item in returns) and spec.actor_id is None:
            self._add_lineage(spec, deps or [])
        for i, item in enumerate(returns):
            self._absorb_return_item(ObjectID.for_return(spec.task_id, i), item)
        if fut is not None and not fut.done():
            fut.set_result(True)

    def handle_generator_items(self, conn, p):
        """Caller side: one BATCH of streamed items from an executing
        generator task (reference: ReportGeneratorItemReturns, coalesced).
        Absorbs N items in one pass — N return objects registered, N refs
        pushed to the consumer under one lock acquisition — so a deep batch
        frame costs one dispatch, not N."""
        gen = self._streaming.get(p["task_id"])
        if gen is None:
            return  # stale task (consumer already gone)
        items = p["items"]
        _STREAM_BATCH_HIST[len(items)] += 1
        if p.get("want_ack") and getattr(gen, "_ack_conn", None) is not conn:
            # Install once per (stream, conn) — never per item. Refreshed
            # only when the conn actually changes: a connection-loss retry
            # replays the stream on a NEW conn, and acks pinned to the dead
            # one would stall a backpressured producer forever.
            self._install_stream_ack(gen, conn, p["task_id"])
        tid = TaskID(p["task_id"])
        pushes = []
        for index, item in items:
            if not gen.reserve(index):
                continue  # duplicate index from a retry replay
            oid = ObjectID.for_return(tid, index)
            rec = self._register_owned(oid)
            rec.local_refs += 1
            self._absorb_return_item(oid, item)
            ref = ObjectRef(oid, self.address, _register=False)
            ref._registered = True
            pushes.append((index, ref))
        if pushes:
            gen._push_many(pushes)

    def _install_stream_ack(self, gen, conn, tb: bytes):
        """Consumption-ack hook, coalescing: consumer-thread acks record the
        latest consumed count and arm ONE loop callback per burst, so N
        items consumed back-to-back cost one self-pipe wakeup and one
        enqueue-only generator_ack covering the whole batch (batch-granular
        acks — the producer's backpressure window advances in batches)."""
        loop = self.loop
        state = {"armed": False, "value": 0}

        def send(conn=conn, tb=tb, state=state):
            # Disarm BEFORE reading the value: a consumption that saw
            # armed=True happened before the disarm, so its count is
            # visible to this read; one that misses the window re-arms.
            state["armed"] = False
            consumed = state["value"]
            if not conn.closed:
                try:
                    conn.notify_soon(
                        "generator_ack", {"task_id": tb, "consumed": consumed}
                    )
                except rpc.ConnectionLost:
                    pass

        def ack(consumed: int, state=state):
            state["value"] = consumed
            if state["armed"]:
                return
            state["armed"] = True
            try:
                loop.call_soon_threadsafe(send)
            except RuntimeError:
                state["armed"] = False

        gen._ack = ack
        gen._ack_conn = conn

    # -- task execution (executor side) --------------------------------
    async def handle_push_tasks(self, conn, p):
        """Execute a batch of pushed tasks sequentially (batched PushTask:
        amortizes per-frame overhead when the submitter's queue is deep;
        execution order and one-at-a-time semantics are unchanged)."""
        return {"results": [await self.handle_push_task(conn, s) for s in p["specs"]]}

    def _decode_pushed(self, conn, p) -> TaskSpec:
        """Wire -> TaskSpec: full spec (interning its constants under the
        caller's small int) or a lean tuple referencing interned constants."""
        spec = p.get("spec")
        if spec is not None:
            oid = p.get("oid")
            if oid is not None:
                conn.meta.setdefault("opts_in", {})[oid] = (
                    spec.options, spec.job_id, spec.caller_addr, spec.fn_id
                )
            return spec
        tid, args_blob, num_returns, oid, attempt = p["lean"]
        options, job_id, caller_addr, fn_id = conn.meta["opts_in"][oid]
        spec = TaskSpec(
            task_id=TaskID(tid), job_id=job_id, fn_id=fn_id, args_blob=args_blob,
            num_returns=num_returns, options=options, caller_addr=caller_addr,
            trace_ctx=p.get("tc"), qos_ctx=p.get("qc"),
        )
        if attempt:
            spec._attempts = attempt  # type: ignore[attr-defined] - retried attempt: exec events key the same index record
        return spec

    async def handle_push_task(self, conn, p):
        """Execute a pushed task (reference: CoreWorkerService.PushTask ->
        TaskReceiver -> scheduling queue -> execute callback)."""
        spec = self._decode_pushed(conn, p)
        streaming = spec.num_returns == -1
        if streaming:
            self._stream_register(spec.task_id.binary())
        try:
            fn = await self._load_callable(spec.fn_id)
            loop = asyncio.get_running_loop()
            tc = spec.trace_ctx
            if tc is None:
                self._task_event("task_exec_start", spec, node=self.node_id)
            else:
                # The execution span: child of the submitter's span; user code
                # inside the task sees (trace_id, exec_span) as its context.
                spec._exec_ctx = (tc[0], _tracing.new_span_id())  # type: ignore[attr-defined]
                self._task_event("task_exec_start", spec, node=self.node_id,
                                 span_id=spec._exec_ctx[1])
            t0 = time.monotonic()
            try:
                # QoS hop "worker": an already-expired request is dropped
                # HERE, before user code — the typed error reply rides the
                # normal error path back to the caller (counted, traced).
                _qos.check_deadline("worker", _qos.from_wire(spec.qos_ctx),
                                    detail=_spec_fn_name(spec))
                fault = _chaos.maybe_inject("worker.exec", fn=_spec_fn_name(spec))
                if fault is not None:
                    if fault.kind == "kill":
                        # Hard worker death mid-task (the SIGKILL shape): no
                        # reply ever leaves this process; the caller's retry
                        # path resubmits on a fresh worker.
                        logger.warning("chaos: worker.exec kill (task %s)", spec.task_id.hex()[:8])
                        # Last-gasp black box: the ring currently holds this
                        # task's exec_start and everything before it. Written
                        # synchronously BEFORE os._exit (no atexit, no flush
                        # window); the node daemon harvests the file alongside
                        # the worker log when it reports the death.
                        _flight.dump("worker.death",
                                     reason=f"chaos worker.exec kill "
                                            f"(task {spec.task_id.hex()[:8]})")
                        os._exit(1)
                    if fault.kind == "delay":
                        await asyncio.sleep(fault.delay_s)  # slow-executor stall
                    elif fault.kind == "error":
                        raise fault.error(f"task {_spec_fn_name(spec)}")
                if streaming:
                    n = await self._execute_streaming_task(conn, fn, spec, loop)
                    return {"status": "ok", "streaming_done": n}
                result = await loop.run_in_executor(self._executor, self._execute_task, fn, spec)
                returns = await self._package_returns(spec, result)
                return {"status": "ok", "returns": returns}
            except BaseException as e:  # noqa: BLE001 - errors propagate to caller
                return {"status": "error", "error": serialization.RemoteError.from_exception(e, where=f"task {spec.fn_id[:24]}")}
            finally:
                _task_latency_task.observe(time.monotonic() - t0)
                if tc is None:
                    self._task_event("task_exec_end", spec, node=self.node_id)
                else:
                    # Carry the trace id so the controller's trace index sees
                    # the execution END too (duration, not just the start).
                    self._task_event("task_exec_end", spec, node=self.node_id,
                                     span_id=spec._exec_ctx[1])
        finally:
            if streaming:
                self._stream_cleanup(spec.task_id.binary())

    async def _execute_streaming_task(self, conn, fn, spec: TaskSpec, loop) -> int:
        """Run a generator task, shipping its yields through the per-stream
        batch lane: the producing thread appends into a bounded buffer (no
        cross-thread round trip per item — the old path paid a full
        run_coroutine_threadsafe().result() per yielded token) and the
        shipper's loop-side pump coalesces adjacent items into one
        generator_items frame. Producer blocking semantics are preserved:
        full buffer (transport backpressure) and, when
        TaskOptions.generator_backpressure is set, the consumer's acked
        consumption bound (reference: _generator_backpressure_num_objects,
        default unbounded)."""
        shipper = _StreamShipper(self, conn, spec, loop)
        self._stream_shippers[spec.task_id.binary()] = shipper

        def run():
            # Context active for the generator BODY too (it runs during the
            # next() calls below, not inside _execute_task's window).
            token = _tracing.activate(getattr(spec, "_exec_ctx", None))
            qtoken = _qos.activate(spec.qos_ctx)
            try:
                out = self._execute_task(fn, spec)
                if not inspect.isgenerator(out):
                    raise TypeError(
                        f"task {spec.fn_id[:24]} declared num_returns='streaming' "
                        f"but returned {type(out).__name__}, not a generator"
                    )
                count = 0
                for value in out:
                    try:
                        shipper.put(count, value)
                    except _StreamClosed:
                        out.close()
                        break
                    count += 1
                shipper.finish()
                return count
            finally:
                _qos.deactivate(qtoken)
                _tracing.deactivate(token)

        # Stream state registered/cleaned by handle_push_task's try/finally.
        return await loop.run_in_executor(self._executor, run)

    def _stream_register(self, tid: bytes):
        """Mark a streaming task live. MUST run synchronously in the push
        handler, before its first await: frames are dispatched in wire order,
        so registering before the handler first yields guarantees a racing
        generator_close (sent after the submit) observes the stream as live."""
        self._live_streams.add(tid)

    def _stream_cleanup(self, tid: bytes):
        """Single place per-stream executor state dies (idempotent)."""
        self._live_streams.discard(tid)
        sh = self._stream_shippers.pop(tid, None)
        if sh is not None:
            # Fold the shipper's early-close discard tally into the process
            # counter before its state dies (stream.items_dropped metric).
            self._stream_items_dropped += sh.items_dropped
        self._cancelled_streams.discard(tid)

    def handle_generator_ack(self, conn, p):
        """Executor side: consumer progress for a backpressured stream —
        one ack can cover a whole consumed batch (the owner coalesces)."""
        sh = self._stream_shippers.get(p["task_id"])
        if sh is not None:
            sh.on_ack(p["consumed"])

    def handle_generator_close(self, conn, p):
        """Executor side: the consumer abandoned this stream. Mark it and
        wake any blocked producer (buffer-full or backpressure wait) so it
        observes the close at its next yield. Only streams still executing
        are marked — a close that races the stream's own completion (its
        finally already discarded the entry) must not re-add the id, or
        long-lived workers leak set entries."""
        tid = p["task_id"]
        if tid not in self._live_streams:
            return
        self._cancelled_streams.add(tid)
        sh = self._stream_shippers.get(tid)
        if sh is not None:
            sh.close_consumer()

    def cancel_stream(self, task_id_bytes: bytes):
        """Caller side: best-effort early termination of a streaming task the
        moment the consumer stops iterating (reference: CancelTask RPC for
        streaming generators). Thread-safe; no-op once the stream finished."""

        def go():
            conn = self._stream_conns.get(task_id_bytes)
            if conn is not None and not conn.closed:
                self._spawn_bg(
                    conn.notify("generator_close", {"task_id": task_id_bytes})
                )

        self.loop.call_soon_threadsafe(go)

    def _execute_task(self, fn, spec: TaskSpec):
        args, kwargs = serialization.deserialize(spec.args_blob)
        args = [self.get_sync(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: (self.get_sync(v) if isinstance(v, ObjectRef) else v) for k, v in kwargs.items()}
        self._current_task = spec
        # Executor threads don't inherit the IO loop's contextvars: install
        # the task's execution span (if traced) and QoS context so user-code
        # spans, nested submissions, and deadline checks chain onto them.
        token = _tracing.activate(getattr(spec, "_exec_ctx", None))
        qtoken = _qos.activate(spec.qos_ctx)
        # Tripwire: user code entering with a LONG-expired deadline means a
        # gate was bypassed (qos.exec.expired_total; grace for jitter).
        _qos.mark_exec_start("worker")
        try:
            return fn(*args, **kwargs)
        finally:
            _qos.deactivate(qtoken)
            _tracing.deactivate(token)
            self._current_task = None

    async def _package_value(self, oid: ObjectID, value) -> dict:
        """Serialize one return/stream item: small -> inline bytes in the
        reply frame; large -> local shm under ``oid`` (size in the frame).
        Single source of the inline-vs-shm split for both the plain-return
        and streaming paths."""
        data, _ = serialization.serialize(value)
        if len(data) <= self.config.max_inline_object_size or self.store is None:
            return {"inline": data}
        await self._write_shm(oid, data)
        return {"size": len(data)}

    def _absorb_return_item(self, oid: ObjectID, item: dict):
        """Caller-side mirror of _package_value: register one arrived
        return/stream item under this owner."""
        if item.get("inline") is not None:
            self.memory_store.put(oid, item["inline"])
            self._mark_ready(oid, size=len(item["inline"]), in_memory=True, in_shm=False)
        else:
            self._mark_ready(oid, size=item.get("size", 0), in_memory=False, in_shm=True)

    async def _package_returns(self, spec: TaskSpec, result) -> list[dict]:
        values = (result,) if spec.num_returns == 1 else tuple(result) if spec.num_returns > 1 else ()
        if spec.num_returns > 1 and len(values) != spec.num_returns:
            raise ValueError(f"task declared num_returns={spec.num_returns} but returned {len(values)}")
        return [
            await self._package_value(ObjectID.for_return(spec.task_id, i), v)
            for i, v in enumerate(values)
        ]

    # -- actors: caller side -------------------------------------------
    def create_actor_sync(self, cls_id: str, init_args_blob: bytes, opts, name: str = "", namespace: str = "default") -> ActorID:
        actor_id = ActorID.from_random()
        spec = ActorSpec(
            actor_id=actor_id,
            job_id=self.job_id,
            cls_id=cls_id,
            init_args_blob=init_args_blob,
            options=opts,
            name=name,
            namespace=namespace,
            owner_addr=self.address,
        )
        info = self._run(self.controller.call("register_actor", {"spec": spec}))
        if info["state"] == "DEAD":
            raise ActorDiedError(f"actor failed to start: {info.get('death_cause')}")
        actor_id = ActorID(info["actor_id"])  # may differ under get_if_exists
        # Creation is async; worker_addr may still be empty. The first task
        # push resolves it via wait_actor_alive.
        self._actor_conns[actor_id] = {"addr": info["worker_addr"], "conn": None}
        return actor_id

    def submit_actor_task_sync(self, actor_id: ActorID, method: str, args, kwargs, num_returns, opts,
                               concurrency_group: str = ""):
        task_id = TaskID.from_random()
        streaming = num_returns == "streaming"
        n_returns = -1 if streaming else num_returns
        args_blob, dep_refs = serialization.serialize_args(args, kwargs)
        tc = _tracing.current_trace()
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            fn_id="",
            args_blob=args_blob,
            num_returns=n_returns,
            options=opts,
            caller_addr=self.address,
            actor_id=actor_id,
            method_name=method,
            concurrency_group=concurrency_group,
            trace_ctx=tc,
            qos_ctx=_qos.current_wire(),
        )
        refs = [] if streaming else [
            ObjectRef(ObjectID.for_return(task_id, i), self.address, _register=False) for i in range(n_returns)
        ]
        gen = ObjectRefGenerator(task_id, self.address) if streaming else None
        if gen is not None:
            gen._cancel = functools.partial(self.cancel_stream, task_id.binary())

        def _go():
            if gen is not None:
                self._streaming[task_id.binary()] = gen
            self._register_returns(refs)
            if tc is not None:
                # Submission event ONLY when traced: actor calls are the hot
                # path and normally emit no events at all (export_timeline's
                # flow arrows need the submit side of the hop).
                self._task_event("task_submitted", spec, span_id=tc[1])
            self._submit_actor_task(spec, dep_refs)

        self._post_to_loop(_go)
        for r in refs:
            r._registered = True
        return gen if streaming else refs

    def _submit_actor_task(self, spec: TaskSpec, dep_refs):
        # Per-actor FIFO pump: submission order must equal wire order (actor
        # tasks execute in arrival order on the executor). A create_task per
        # spec would let conn-setup/dep awaits interleave and reorder sends;
        # a plain enqueue also keeps the per-call hot path task-free.
        q = self._actor_send_queues.get(spec.actor_id)
        if q is None:
            q = self._actor_send_queues[spec.actor_id] = asyncio.Queue()
            self._spawn_bg(self._actor_send_pump(spec.actor_id, q))
        q.put_nowait((spec, dep_refs))

    async def _actor_send_pump(self, actor_id: ActorID, q: "asyncio.Queue"):
        while True:
            batch = [await q.get()]
            # Batch-drain: everything already queued ships back-to-back with
            # one transport flush at the end (amortizes the drain under async
            # call storms; pump order still == wire order, and every call
            # keeps its own reply future).
            while len(batch) < 64 and not q.empty():
                batch.append(q.get_nowait())
            # Failure ownership: _push_actor_batch_ordered fails ITS specs'
            # returns itself (raising only ActorDiedError, for retirement);
            # the pump fails exactly the items it has not yet handed over —
            # never work already flushed to the actor, whose reply futures
            # own the outcome.
            pending = collections.deque(batch)
            specs: list[TaskSpec] = []
            died: ActorDiedError | None = None
            try:
                while pending:
                    spec, dep_refs = pending[0]
                    if dep_refs:
                        # Ship everything accumulated BEFORE awaiting this
                        # task's deps: a dep may be produced by an earlier
                        # batchmate (a.m2.remote(a.m1.remote()) lands both in
                        # one drain) — holding m1 unsent while waiting on its
                        # result would deadlock the pump.
                        if specs:
                            to_push, specs = specs, []
                            await self._push_actor_batch_ordered(to_push)
                        self._inflight_deps[spec.task_id.binary()] = dep_refs
                        try:
                            await self._wait_deps(dep_refs)
                        except Exception as e:
                            pending.popleft()
                            self._fail_task_returns(
                                spec,
                                RemoteError(f"task {spec.method_name} dependency resolution failed: {e}"),
                            )
                            continue
                    pending.popleft()
                    specs.append(spec)
                if specs:
                    to_push, specs = specs, []
                    await self._push_actor_batch_ordered(to_push)
            except ActorDiedError as e:
                died = e
            except Exception as e:
                # Safety net: an unexpected error must not kill the pump task
                # while its queue stays registered (later submissions would
                # enqueue into a dead pump and hang forever). Fail the
                # un-pushed work; the pump lives on for the next drain.
                logger.exception("actor send pump error (actor=%s)", actor_id.hex()[:8])
                for spec, _ in pending:
                    self._fail_task_returns(
                        spec,
                        ActorDiedError(
                            f"actor {actor_id.hex()[:8]} task {spec.method_name} failed to submit: {e}"
                        ),
                    )
            if died is not None:
                for spec, _ in pending:  # drained but never handed to a push
                    self._fail_task_returns(spec, died)
                # Actor is gone: fail everything still queued and retire the
                # pump (a later submission spawns a fresh one, which handles
                # the restarted-actor case via address refresh).
                while not q.empty():
                    pending_spec, _ = q.get_nowait()
                    self._fail_task_returns(pending_spec, died)
                if self._actor_send_queues.get(actor_id) is q:
                    del self._actor_send_queues[actor_id]
                return

    async def _push_actor_batch_ordered(self, specs: list[TaskSpec], retried: bool = False):
        """Issue one message per task in pump order, then ONE transport flush
        for the whole drain. The messages are enqueued synchronously (no
        await between call_starts), so the rpc layer coalesces the entire
        drain into a single envelope: one pickle, one MAC, one write, one
        executor wakeup per batch — while each task keeps its own reply
        future, so a fast call's result is never held behind a slow
        batchmate's (replies coalesce symmetrically on the way back).

        Failure ownership: every spec handed to this method gets an outcome
        here — a reply-awaiting task, a retry, or failed returns. Only
        ActorDiedError escapes (so the pump can retire).

        Ordering contract: wire order == pump order == submission order; the
        executor runs tasks in arrival order, so no sequence numbers are
        needed (the reference's ActorTaskSubmitter/ActorSchedulingQueue pair
        achieves the same with explicit seq_nos over unordered gRPC).
        """
        actor_id = specs[0].actor_id
        entry = self._actor_conns.get(actor_id)
        if entry is None:
            entry = self._actor_conns[actor_id] = {"addr": "", "conn": None}
        sent: list[tuple[TaskSpec, asyncio.Future]] = []
        try:
            await self._actor_conn_fresh(specs[0], entry)
            interned = entry["conn"].meta.setdefault("opts_out", {})
            for spec in specs:
                if spec.num_returns == -1:
                    self._stream_conns[spec.task_id.binary()] = entry["conn"]
                # Lean framing: ship the per-handle constants (options, ids,
                # caller) once per conn, then small tuples — a full TaskSpec
                # costs ~15x a tuple to (un)pickle, the dominant per-call
                # cost for tiny actor calls (reference keeps specs on the
                # wire but pickles them in C++).
                key = (id(spec.options), spec.actor_id)
                ent = interned.get(key)
                if ent is None:
                    if len(interned) >= 512:
                        # Unbounded distinct options (per-call .options()
                        # clones): stop interning, ship full specs.
                        sent.append((spec, entry["conn"].call_start("push_actor_task", {"spec": spec})))
                        continue
                    oid_small = len(interned)
                    interned[key] = (spec.options, oid_small)  # pin: id() stays valid
                    payload = {"spec": spec, "oid": oid_small}
                else:
                    payload = {"lean": (
                        spec.task_id.binary(), spec.method_name, spec.args_blob,
                        spec.num_returns, spec.concurrency_group, ent[1],
                    )}
                    if spec.trace_ctx is not None:
                        payload["tc"] = spec.trace_ctx
                    if spec.qos_ctx is not None:
                        payload["qc"] = spec.qos_ctx
                sent.append((spec, entry["conn"].call_start("push_actor_task", payload)))
            # Backpressure: bound the transport buffer before the next drain.
            await entry["conn"].flush()
        except ActorDiedError as e:
            for spec in specs:
                self._fail_task_returns(spec, e)
            raise
        except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
            # OSError covers raw transport errors (ConnectionResetError from
            # writer.drain()) that the rpc layer does not wrap.
            entry["conn"] = None
            entry["addr"] = ""
            for fut in [f for _, f in sent]:
                fut.cancel()
            if not sent and not retried:
                # Nothing reached the wire (stale address / dial failure):
                # unambiguously safe to retry the whole batch once through
                # the redial path (which refreshes restarted-actor addresses;
                # _refresh_actor_addr raises ActorDiedError for dead ones).
                await self._push_actor_batch_ordered(specs, retried=True)
                return
            # Frames may have been DELIVERED and executed before the drop
            # (TCP delivery is independent of the local error): resending
            # would double-execute non-idempotent methods. Per-task policy,
            # same as a reply lost mid-flight: retry only with the user's
            # opt-in (max_task_retries > 0), else at-most-once wins.
            for spec in specs:
                if getattr(spec.options, "max_task_retries", 0) > 0:
                    try:
                        await self._push_actor_task(spec, attempt=1)
                    except ActorDiedError as e2:
                        self._fail_task_returns(spec, e2)
                else:
                    self._fail_task_returns(
                        spec,
                        ActorDiedError(
                            f"actor {spec.actor_id.hex()[:8]} task {spec.method_name} lost in flight: {e}"
                        ),
                    )
            return
        except Exception as e:
            # Uphold the ownership contract for errors outside the expected
            # set too (every spec handed here gets an outcome): otherwise the
            # callers' reply futures never resolve. Drop the conn as well —
            # it may hold partially-buffered frames for specs whose callers
            # were just told they failed; reusing it would flush those frames
            # and double-execute them.
            logger.exception("actor batch push failed (actor=%s)", actor_id.hex()[:8])
            conn = entry.get("conn")
            entry["conn"] = None
            entry["addr"] = ""
            if conn is not None:
                try:
                    await conn.close()
                except Exception:
                    pass
            for fut in [f for _, f in sent]:
                fut.cancel()
            for spec in specs:
                self._fail_task_returns(
                    spec,
                    ActorDiedError(
                        f"actor {actor_id.hex()[:8]} task {spec.method_name} failed to submit: {e}"
                    ),
                )
            return
        for spec, fut in sent:
            fut.add_done_callback(
                functools.partial(self._on_actor_reply, spec, entry=entry)
            )

    def _on_actor_reply(self, spec: TaskSpec, fut, entry):
        """Reply-future done callback (hot path: NO task per call — absorb
        runs synchronously in the callback; only the exceptional paths spawn
        a coroutine)."""
        exc = fut.cancelled() or fut.exception()
        if not exc:
            self._absorb_task_reply(spec, fut.result())
            return
        self._spawn_bg(self._actor_reply_failed(spec, fut, entry))

    async def _actor_reply_failed(self, spec: TaskSpec, fut, entry):
        try:
            await fut
        except ActorDiedError as e:
            self._fail_task_returns(spec, e)
        except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
            # Connection dropped mid-flight: the task may or may not have
            # executed. Resend ONLY if the user opted into retries
            # (max_task_retries > 0) — otherwise at-most-once wins.
            entry["conn"] = None
            entry["addr"] = ""
            if getattr(spec.options, "max_task_retries", 0) > 0:
                await self._push_actor_task(spec, attempt=1)
            else:
                self._fail_task_returns(
                    spec,
                    ActorDiedError(
                        f"actor {spec.actor_id.hex()[:8]} task {spec.method_name} lost in flight: {e}"
                    ),
                )

    async def _actor_conn_fresh(self, spec: TaskSpec, entry: dict) -> None:
        """Ensure entry has a LIVE connection to the actor's current worker.

        Evidence-based stale-address handling: refresh from the controller
        and DIAL the address it reports. Only when that dial fails (the
        worker is really gone) poll for the record to move — RESTARTING
        blocks inside wait_actor_alive, a restarted incarnation gets a NEW
        worker address, DEAD raises ActorDiedError. A transient connection
        reset to a healthy actor therefore redials the same address and
        proceeds immediately (no false death)."""
        if entry["conn"] is not None and not entry["conn"].closed:
            return
        if not entry["addr"]:
            await self._refresh_actor_addr(spec.actor_id, entry)
        try:
            entry["conn"] = await self._peer_conn(entry["addr"])
            return
        except (rpc.ConnectionLost, OSError):
            dead = entry["addr"]
        deadline = time.monotonic() + self.config.actor_creation_timeout_s
        while entry["addr"] == dead:
            if time.monotonic() > deadline:
                raise ActorDiedError(
                    f"actor {spec.actor_id.hex()[:8]} never left dead address {dead}"
                )
            await asyncio.sleep(self.config.task_retry_delay_s)
            await self._refresh_actor_addr(spec.actor_id, entry)
        entry["conn"] = await self._peer_conn(entry["addr"])

    async def _push_actor_task(self, spec: TaskSpec, attempt: int = 0):
        entry = self._actor_conns.get(spec.actor_id)
        if entry is None:
            entry = self._actor_conns[spec.actor_id] = {"addr": "", "conn": None}
        try:
            await self._actor_conn_fresh(spec, entry)
            reply = await entry["conn"].call("push_actor_task", {"spec": spec})
            self._absorb_task_reply(spec, reply)
        except ActorDiedError as e:
            self._fail_task_returns(spec, e)
        except (rpc.ConnectionLost, rpc.RpcError, KeyError, OSError) as e:
            # OSError covers raw transport failures (ConnectionReset/BrokenPipe
            # out of writer.drain) — anything escaping here would kill the
            # retry task and leave the caller's ref unresolved forever.
            entry["conn"] = None
            entry["addr"] = ""
            max_task_retries = getattr(spec.options, "max_task_retries", 0)
            if attempt < max_task_retries:
                await asyncio.sleep(self.config.task_retry_delay_s)
                await self._push_actor_task(spec, attempt + 1)
            else:
                self._fail_task_returns(
                    spec, ActorDiedError(f"actor {spec.actor_id.hex()[:8]} task {spec.method_name} failed: {e}")
                )

    async def _refresh_actor_addr(self, actor_id: ActorID, entry: dict):
        info = await self.controller.call("wait_actor_alive", {"actor_id": actor_id.binary()})
        if info is None or info["state"] == "DEAD":
            raise ActorDiedError(f"actor {actor_id.hex()[:8]} is dead: {(info or {}).get('death_cause', 'unknown')}")
        entry["addr"] = info["worker_addr"]

    def kill_actor_sync(self, actor_id: ActorID, no_restart: bool = True):
        self._run(self.controller.call("kill_actor", {"actor_id": actor_id.binary(), "no_restart": no_restart}))

    # -- actors: executor side -----------------------------------------
    async def handle_create_actor(self, conn, p):
        spec: ActorSpec = p["spec"]
        cls = await self._load_callable(spec.cls_id)
        args, kwargs = serialization.deserialize(spec.init_args_blob)
        runtime = ActorRuntime(self, spec, cls)
        await runtime.construct(args, kwargs)
        self._actor_runtime = runtime
        return True

    async def handle_push_actor_task(self, conn, p):
        if self._actor_runtime is None:
            raise rpc.RpcError("no actor hosted on this worker")
        spec = p.get("spec")
        if spec is not None:
            # Full spec: intern its per-handle constants under the caller's
            # small int so subsequent calls can ride the lean frame (a full
            # TaskSpec costs ~15x a small tuple to (un)pickle on the wire —
            # the dominant per-call cost for tiny actor calls on one core).
            oid = p.get("oid")
            if oid is not None:
                conn.meta.setdefault("opts_in", {})[oid] = (
                    spec.options, spec.job_id, spec.caller_addr, spec.actor_id
                )
        else:
            tid, method, args_blob, num_returns, cg, oid = p["lean"]
            options, job_id, caller_addr, actor_id = conn.meta["opts_in"][oid]
            spec = TaskSpec(
                task_id=TaskID(tid), job_id=job_id, fn_id="", args_blob=args_blob,
                num_returns=num_returns, options=options, caller_addr=caller_addr,
                actor_id=actor_id, method_name=method, concurrency_group=cg,
                trace_ctx=p.get("tc"), qos_ctx=p.get("qc"),
            )
        streaming = spec.num_returns == -1
        if streaming:
            # Synchronous registration before the first await — see
            # _stream_register for the ordering contract with generator_close.
            self._stream_register(spec.task_id.binary())
        tc = spec.trace_ctx
        if tc is not None:
            # Exec-span events ONLY when traced: untraced actor calls keep
            # their zero-event hot path (the latency histogram below is the
            # always-on signal).
            spec._exec_ctx = (tc[0], _tracing.new_span_id())  # type: ignore[attr-defined]
            self._task_event("task_exec_start", spec, node=self.node_id,
                             span_id=spec._exec_ctx[1])
        t0 = time.monotonic()
        try:
            return await self._actor_runtime.execute(spec, conn)
        finally:
            _task_latency_actor.observe(time.monotonic() - t0)
            if tc is not None:
                # trace id rides along so the index records the end (duration).
                self._task_event("task_exec_end", spec, node=self.node_id,
                                 span_id=spec._exec_ctx[1])
            if streaming:
                self._stream_cleanup(spec.task_id.binary())


    # -- compiled DAG stages (ray_tpu_torch.dag; channels ride the existing
    # peer connections — reference: compiled_dag_node.py exec loops +
    # channels) --
    def handle_dag_setup(self, conn, p):
        from ray_tpu_torch.dag.runtime import dag_setup

        return dag_setup(self, p)

    async def handle_dag_push(self, conn, p):
        from ray_tpu_torch.dag.runtime import dag_push

        return await dag_push(self, conn, p)

    def handle_dag_teardown(self, conn, p):
        from ray_tpu_torch.dag.runtime import dag_teardown

        return dag_teardown(self, p)

    def handle_store_path(self, conn, p):
        """Arena identity probe: same path = same node = zero-copy dag edges."""
        return self.store.path if self.store is not None else ""

    async def handle_profile_cpu(self, conn, p):
        """On-demand CPU profile of THIS worker (the dashboard's
        py-spy-equivalent, reference: dashboard/modules/reporter/
        profile_manager.py:60-100 — here in-process via sys._current_frames).
        Routed through the obs.profiler capture-session API (one entry point,
        session-bounded, shared frame rendering with every other profile
        surface); runs on an executor thread so the IO loop keeps serving
        while sampling. Reply keeps the original shape plus the fold's
        plane/drop counters."""
        duration = min(float(p.get("duration_s", 2.0)), 30.0)
        hz = None
        if p.get("interval_s"):
            hz = 1.0 / max(float(p["interval_s"]), 0.005)

        loop = asyncio.get_running_loop()
        fold = await loop.run_in_executor(
            None, lambda: _profiler.capture(duration, hz=hz))
        return fold

    async def handle_profile_fold(self, conn, p):
        """This process's leg of cluster profile collection (controller ->
        daemon -> worker fan-out, memory_summary-style). Modes (first match):
        ``status`` -> sampler status row; ``trace_id`` -> that trace's
        accumulator; ``seconds`` -> live bounded capture (executor thread);
        ``window_s`` -> recent-window fold; default -> since-arm totals."""
        if p.get("seconds"):
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, lambda: _profiler.local_fold(p))
        return _profiler.local_fold(p)

    def handle_dag_shm_ack(self, conn, p):
        from ray_tpu_torch.dag.runtime import dag_shm_ack

        return dag_shm_ack(self, p)

    def handle_dag_result(self, conn, p):
        from ray_tpu_torch.dag.runtime import dag_result

        return dag_result(self, p)

    # -- collective ring transport (ray_tpu_torch/collective/ring.py) ----------
    # The ring's control plane rides the worker RPC server: a neighbor's
    # hello pins which inbound Connection carries its raw frames; ready/
    # meta/abort notifies key per-op events. Raw tensor frames themselves
    # never reach a handler — they land in expect_raw buffers.

    def handle_collective_ring_hello(self, conn, p):
        from ray_tpu_torch.collective import ring as _colring

        return _colring._on_hello(conn, p)

    def handle_collective_ring_ready(self, conn, p):
        from ray_tpu_torch.collective import ring as _colring

        _colring._on_ready(p)

    def handle_collective_ring_meta(self, conn, p):
        from ray_tpu_torch.collective import ring as _colring

        _colring._on_meta(p)

    def handle_collective_ring_abort(self, conn, p):
        from ray_tpu_torch.collective import ring as _colring

        return _colring._on_abort(p)

    # -- elastic train plane (ray_tpu_torch/elastic/transfer.py) ---------------
    # Live-reshard byte runs ride the same raw lane as object pulls: this
    # handler only slices parked export views and send_raw's them — the
    # payload is never pickled and the reply carries only counters.

    async def handle_elastic_fetch(self, conn, p):
        from ray_tpu_torch.elastic import transfer as _elastic

        return await _elastic.fetch(self, conn, p)

    def handle_shutdown(self, conn, p):
        self._shutdown = True
        if self._actor_runtime is not None:
            self._actor_runtime.on_exit()
        loop = self.loop

        def stop():
            loop.stop()

        loop.call_soon(stop)
        return True

    def handle_memory_summary(self, conn, p):
        """Dump this process's ownership/reference picture (the `ray memory`
        per-worker unit, reference: CoreWorkerService.GetCoreWorkerStats ->
        memory_summary): owned objects with pin counts + borrower counts,
        objects borrowed FROM other owners, lineage pins, and queued
        submissions. Bounded by `limit` with an explicit truncation count."""
        return self.memory_summary(limit=int(p.get("limit", 200)))

    def memory_summary(self, limit: int = 200) -> dict:
        owned = []
        for oid, rec in list(self.owned.items()):
            if len(owned) >= limit:
                break
            owned.append({
                "oid": oid.hex(),
                "state": rec.state,
                "size": rec.size,
                "local_refs": rec.local_refs,
                "borrowers": rec.borrowers,
                "where": "shm" if rec.in_shm else ("memory" if rec.in_memory else "-"),
            })
        borrowed = []
        for oid_bin, ent in list(self._borrowed.items()):
            if len(borrowed) >= limit:
                break
            borrowed.append({
                "oid": ObjectID(oid_bin).hex(),
                "owner_addr": ent["owner_addr"],
                "refs": ent["refs"],
            })
        rt = self._actor_runtime
        return {
            "worker_id": self.worker_id,
            "address": self.address,
            "node_id": self.node_id,
            "actor_id": rt.spec.actor_id.hex() if rt is not None else "",
            "actor_name": rt.spec.name if rt is not None else "",
            "owned": owned,
            "owned_total": len(self.owned),
            "owned_truncated": max(0, len(self.owned) - len(owned)),
            "borrowed": borrowed,
            "borrowed_total": len(self._borrowed),
            "borrowed_truncated": max(0, len(self._borrowed) - len(borrowed)),
            "memory_store_objects": len(self.memory_store),
            "lineage": {"tasks": len(self._lineage), "bytes": self._lineage_bytes},
            "queued": {
                "submitter": sum(len(s.queue) for s in self._submitters.values()),
                "actor_pump": sum(q.qsize() for q in self._actor_send_queues.values()),
                "inflight_deps": len(self._inflight_deps),
            },
        }

    def handle_debug_observability(self, conn, p):
        """Ground-truth snapshot of this worker's observability state (used
        by dashboards/tests to distinguish 'never recorded' from 'never
        flushed' without waiting on reporter ticks)."""
        tail = int(p.get("tail", 5))
        return {
            "worker_id": self.worker_id,
            "task_events_len": len(self.task_events),
            "events_reported": self._events_reported,
            "events_dropped": self._events_dropped,
            "tail": self.task_events[-tail:] if tail > 0 else [],
            "flight": _flight.recorder().stats(),
            "profiler": _profiler.status(),
        }

    def handle_flight_dump(self, conn, p):
        """Operator-requested black-box dump of THIS process (`raytpu debug
        dump <worker>`): writes the ring and returns the path + stats."""
        path = _flight.dump("manual", reason=p.get("reason", "rpc request"))
        return {"path": path, **_flight.recorder().stats()}

    def handle_flight_query(self, conn, p):
        """Events this process's recorder still holds for one trace — the
        per-worker leg of `raytpu trace export` reassembly (controller fans
        out through the daemons, memory_summary-style)."""
        return {"events": _flight.recorder().events_for_trace(p.get("trace_id", ""))}


class ActorRuntime:
    """Hosts one actor instance: FIFO ordering, max_concurrency via thread
    pool (sync methods) or asyncio semaphore (async methods). Named
    concurrency groups get their own lane (pool + semaphore) so e.g. an "io"
    group keeps serving health checks while the default lane is saturated
    (reference: ConcurrencyGroupManager + per-group fiber/thread executors,
    core_worker/task_execution)."""

    def __init__(self, core: CoreWorker, spec: ActorSpec, cls):
        self.core = core
        self.spec = spec
        self.cls = cls
        self.instance = None
        maxc = max(1, spec.options.max_concurrency)
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=maxc, thread_name_prefix="actor")
        self.sem = asyncio.Semaphore(maxc)
        self._ordered = maxc == 1
        self._chain: asyncio.Future | None = None
        self._group_pools: dict[str, concurrent.futures.ThreadPoolExecutor] = {}
        self._group_sems: dict[str, asyncio.Semaphore] = {}
        for gname, gmax in (spec.options.concurrency_groups or {}).items():
            gmax = max(1, int(gmax))
            self._group_pools[gname] = concurrent.futures.ThreadPoolExecutor(
                max_workers=gmax, thread_name_prefix=f"actor-{gname}"
            )
            self._group_sems[gname] = asyncio.Semaphore(gmax)

    def _lane(self, spec: TaskSpec, method) -> tuple:
        """(pool, semaphore, ordered) for this call: explicit per-call group,
        else the method's @method default, else the default lane."""
        group = spec.concurrency_group or getattr(
            method, "__raytpu_method_opts__", {}
        ).get("concurrency_group", "")
        if group:
            pool = self._group_pools.get(group)
            if pool is None:
                raise ValueError(
                    f"unknown concurrency group {group!r}: declared groups are "
                    f"{sorted(self._group_pools)}"
                )
            return pool, self._group_sems[group], False
        return self.pool, self.sem, self._ordered

    async def construct(self, args, kwargs):
        loop = asyncio.get_running_loop()
        args = [self.core.get_sync(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: (self.core.get_sync(v) if isinstance(v, ObjectRef) else v) for k, v in kwargs.items()}

        def make():
            return self.cls(*args, **kwargs)

        self.instance = await loop.run_in_executor(self.pool, make)

    async def execute(self, spec: TaskSpec, conn=None) -> dict:
        method = getattr(self.instance, spec.method_name, None)
        if method is None:
            return {
                "status": "error",
                "error": RemoteError.from_exception(AttributeError(f"no method {spec.method_name}"), "actor task"),
            }
        try:
            # QoS hop "worker" (actor lane): drop already-expired calls
            # before the method runs; the typed error reply reaches the
            # caller through the normal error path (counted, traced).
            _qos.check_deadline("worker", _qos.from_wire(spec.qos_ctx),
                                detail=spec.method_name)
            fault = _chaos.maybe_inject("worker.actor.exec", method=spec.method_name)
            if fault is not None:
                if fault.kind == "delay":
                    await asyncio.sleep(fault.delay_s)
                elif fault.kind == "error":
                    raise fault.error(f"actor method {spec.method_name}")
            if spec.num_returns == -1:  # streaming generator method
                n = await self._execute_streaming(method, spec, conn)
                return {"status": "ok", "streaming_done": n}
            pool, sem, _ordered = self._lane(spec, method)
            if inspect.iscoroutinefunction(method):
                async with sem:
                    result = await self._call_async(method, spec)
            else:
                loop = asyncio.get_running_loop()
                result = await loop.run_in_executor(pool, self._call_sync, method, spec)
            returns = await self.core._package_returns(spec, result)
            return {"status": "ok", "returns": returns}
        except BaseException as e:  # noqa: BLE001
            return {"status": "error", "error": RemoteError.from_exception(e, where=f"actor method {spec.method_name}")}

    async def _execute_streaming(self, method, spec: TaskSpec, conn) -> int:
        """Stream a generator actor method's yields to the caller through
        the same per-stream batch lane as streaming normal tasks: buffered
        appends drained by a loop-side pump into generator_items frames,
        count in the final reply. Sync generators append cross-thread (no
        per-item loop round trip); async generators append loop-side."""
        loop = asyncio.get_running_loop()
        pool, sem, _ = self._lane(spec, method)
        shipper = _StreamShipper(self.core, conn, spec, loop)
        self.core._stream_shippers[spec.task_id.binary()] = shipper
        if inspect.isasyncgenfunction(method):
            args, kwargs = await loop.run_in_executor(None, self._resolve, spec.args_blob)
            count = 0
            token = _tracing.activate(getattr(spec, "_exec_ctx", None))
            qtoken = _qos.activate(spec.qos_ctx)
            try:
                async with sem:
                    agen = method(*args, **kwargs)
                    try:
                        async for value in agen:
                            try:
                                await shipper.aput(count, value)
                            except _StreamClosed:
                                break
                            count += 1
                    finally:
                        await agen.aclose()
                await shipper.afinish()
                return count
            finally:
                _qos.deactivate(qtoken)
                _tracing.deactivate(token)

        def run():
            # Context active for the generator BODY (runs during next()).
            token = _tracing.activate(getattr(spec, "_exec_ctx", None))
            qtoken = _qos.activate(spec.qos_ctx)
            try:
                out = self._call_sync(method, spec)
                if not inspect.isgenerator(out):
                    raise TypeError(
                        f"actor method {spec.method_name} declared "
                        f"num_returns='streaming' but returned {type(out).__name__}"
                    )
                n = 0
                for value in out:
                    try:
                        shipper.put(n, value)
                    except _StreamClosed:
                        out.close()
                        break
                    n += 1
                shipper.finish()
                return n
            finally:
                _qos.deactivate(qtoken)
                _tracing.deactivate(token)

        # Stream state registered/cleaned by handle_push_actor_task's
        # try/finally around execute().
        return await loop.run_in_executor(pool, run)

    def _resolve(self, blob):
        args, kwargs = serialization.deserialize(blob)
        args = [self.core.get_sync(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: (self.core.get_sync(v) if isinstance(v, ObjectRef) else v) for k, v in kwargs.items()}
        return args, kwargs

    def _call_sync(self, method, spec: TaskSpec):
        args, kwargs = self._resolve(spec.args_blob)
        # Pool threads don't inherit the IO loop's contextvars: install the
        # call's execution span (if traced) + QoS context so user code
        # chains onto them.
        token = _tracing.activate(getattr(spec, "_exec_ctx", None))
        qtoken = _qos.activate(spec.qos_ctx)
        _qos.mark_exec_start("worker")
        try:
            return method(*args, **kwargs)
        finally:
            _qos.deactivate(qtoken)
            _tracing.deactivate(token)

    async def _call_async(self, method, spec: TaskSpec):
        args, kwargs = await asyncio.get_running_loop().run_in_executor(None, self._resolve, spec.args_blob)
        token = _tracing.activate(getattr(spec, "_exec_ctx", None))
        qtoken = _qos.activate(spec.qos_ctx)
        _qos.mark_exec_start("worker")
        try:
            return await method(*args, **kwargs)
        finally:
            _qos.deactivate(qtoken)
            _tracing.deactivate(token)

    def on_exit(self):
        inst = self.instance
        if inst is not None and hasattr(inst, "__raytpu_exit__"):
            try:
                inst.__raytpu_exit__()
            except Exception:
                pass
