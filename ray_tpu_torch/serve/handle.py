"""DeploymentHandle: client-side router with power-of-two-choices balancing.

Role-equivalent to the reference's DeploymentHandle + Pow2Router
(python/ray/serve/handle.py,
_private/request_router/pow_2_router.py:27 — pick two candidates, choose the
one with fewer ongoing requests). Departures, by design:
- Admission control is fully client-side: the router tracks per-replica
  ongoing counts and never exceeds a replica's max_ongoing_requests; excess
  demand queues in the handle (the reference queues in the router too).
- The admission queue is a WEIGHTED FAIR QUEUE (ray_tpu_torch/qos/fair_queue.py):
  strict priority between QoS classes, deficit-round-robin across tenants
  within a class, FIFO within a tenant — replacing the unordered
  ``Condition.notify`` scrum (which woke waiters in arbitrary OS order, so
  a burst could starve an old waiter and priorities were impossible).
  Deadlines (qos.RequestContext) are enforced while queued: an expired
  waiter leaves with a typed DeadlineExceeded, counted, and never consumes
  a replica slot.
- Demand metrics (queued + ongoing) are pushed to the ServeController for
  autoscaling (reference: autoscaling_state.py handle metrics).
- KV-cache-aware routing (scale/router.py): requests carrying a prompt-
  prefix digest, a multiplexed model id, or an explicit affinity key stick
  to the replica that last served that key (ONE counted-eviction
  AffinityMap for all three kinds), falling back to power-of-two-choices
  on queue depth. Per-pick accounting on
  serve.routing.cache_hit_total{kind=prefix|affinity|p2c}.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import replace as _dc_replace
from typing import Any, Optional

from ray_tpu_torch.qos import context as _qos
from ray_tpu_torch.qos.fair_queue import FairWaitQueue, Waiter
from ray_tpu_torch.scale.router import AffinityMap

SERVE_NAMESPACE = "serve"
CONTROLLER_NAME = "__serve_controller__"

_registry_lock = threading.Lock()
_replica_sets: dict[tuple, "_ReplicaSet"] = {}


def _controller():
    import ray_tpu_torch as rt

    return rt.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)


def _replica_set(app_name: str, deployment_name: str) -> "_ReplicaSet":
    key = (app_name, deployment_name)
    with _registry_lock:
        rs = _replica_sets.get(key)
        if rs is None:
            rs = _ReplicaSet(app_name, deployment_name)
            _replica_sets[key] = rs
        return rs


def _reset_registry():
    """Called by serve.shutdown(): drop cached membership and stop pushers."""
    with _registry_lock:
        for rs in _replica_sets.values():
            rs.close()
        _replica_sets.clear()


class _ReplicaSet:
    """Shared per-process routing state for one deployment."""

    REFRESH_S = 1.0
    # Per-KIND bound on sticky key->replica pins (model ids, affinity keys,
    # prompt prefixes share ONE AffinityMap but evict within their own kind
    # — prefix churn cannot thrash model pins; LRU evicted, counted).
    AFFINITY_CAP = 1024

    def __init__(self, app_name: str, deployment_name: str):
        self.app = app_name
        self.deployment = deployment_name
        self.cond = threading.Condition()
        self.replicas: dict[str, Any] = {}  # replica name -> ActorHandle
        self.max_ongoing = 8
        # In-flight counts keyed by replica NAME: they survive membership
        # refreshes (an index-keyed reset would both lift admission limits on
        # busy replicas and credit completions to the wrong replica).
        self.ongoing: dict[str, int] = {}
        self.version = -1
        self.fetched_at = 0.0
        self.queued = 0
        # Optional deployment-provided request-router policy fn(Request)->key,
        # executed by the proxy (reference: PrefixCacheAffinityRouter).
        self.request_router = None
        self._closed = False
        self._refreshing = False
        self._outstanding: list[tuple[Any, str]] = []  # (ref, replica_name)
        self._drainer: Optional[threading.Thread] = None
        self._pusher: Optional[threading.Thread] = None
        # First-class queue-depth gauges (per process per deployment; the
        # controller keeps gauges as per-reporter series, so each handle
        # process's router state stays separable on /metrics).
        from ray_tpu_torch.util import metrics as _metrics

        tags = {"app": app_name, "deployment": deployment_name}
        self._queue_gauge = _metrics.Gauge(
            "serve.handle.queued", "requests waiting for replica capacity in this handle",
            tag_keys=("app", "deployment")).set_default_tags(tags)
        self._ongoing_gauge = _metrics.Gauge(
            "serve.handle.ongoing", "requests in flight to replicas from this handle",
            tag_keys=("app", "deployment")).set_default_tags(tags)
        # ONE sticky-pin structure for every affinity kind — multiplexed
        # model ids ("m:"), explicit affinity keys ("k:"), prompt-prefix
        # digests ("p:") — replacing the old model-affinity dict + a
        # would-be second prefix cache. No silent caps (graftlint
        # counted-trims): an LRU-evicted pin costs a model reload or a cold
        # prefill on the next request for that key, so the eviction rate is
        # an operator signal, not an internal detail.
        self._affinity_evicted = _metrics.Counter(
            "serve.routing.affinity_evicted",
            "sticky key->replica pins dropped by the AFFINITY_CAP LRU bound",
            tag_keys=("app", "deployment")).set_default_tags(tags)
        self.affinity = AffinityMap(cap=self.AFFINITY_CAP,
                                    on_evict=self._affinity_evicted.inc)
        # Per-pick routing accounting: which mechanism chose the replica
        # (warm-cache hit kinds vs the power-of-two-choices fallback).
        self._cache_hit = _metrics.Counter(
            "serve.routing.cache_hit_total",
            "routing decisions by mechanism (prefix/affinity pin hit vs p2c fallback)",
            tag_keys=("kind", "app", "deployment")).set_default_tags(tags)
        # QoS admission queue (strict class priority / DRR tenants / FIFO)
        # + the queue-delay histogram the proxy's AIMD controller and the
        # dashboards read. All fair-queue state is guarded by self.cond.
        self._wfq = FairWaitQueue()
        self._queue_delay = _metrics.Histogram(
            "qos.queue.delay_s",
            "seconds a request waited in the handle's fair admission queue",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5],
            tag_keys=("class", "app", "deployment"),
        ).set_default_tags(tags)

    # -- membership --------------------------------------------------------
    def _maybe_refresh(self):
        """Fetch routing info WITHOUT holding the lock (a slow controller must
        not stall routing/draining); apply the result under the lock."""
        with self.cond:
            now = time.time()
            if self._refreshing or (now - self.fetched_at < self.REFRESH_S and self.replicas):
                return
            self._refreshing = True
        import ray_tpu_torch as rt

        # Control-plane send: it must not carry the calling request's
        # context, or an expired request gets the refresh itself dropped at
        # the controller's worker gate (qos.suspend).
        token = _qos.suspend()
        try:
            info = rt.get(
                _controller().get_routing_info.remote(self.app, self.deployment),
                timeout=30,
            )
            handles = {}
            if info is not None:
                for name in info["replica_names"]:
                    try:
                        handles[name] = rt.get_actor(name, namespace=SERVE_NAMESPACE)
                    except ValueError:
                        continue  # replica died between snapshot and lookup
        except Exception:
            with self.cond:
                self._refreshing = False
                self.fetched_at = time.time()  # back off before retrying
            raise
        finally:
            _qos.deactivate(token)
        with self.cond:
            self._refreshing = False
            self.fetched_at = time.time()
            if info is None:
                self.replicas, self.version = {}, -1
                return
            if info["version"] != self.version:
                self.replicas = handles
                self.version = info["version"]
                self.max_ongoing = info["max_ongoing_requests"]
                router_blob = info.get("request_router")
                if router_blob is not None:
                    from ray_tpu_torch.core import serialization

                    try:
                        self.request_router = serialization.loads_function(router_blob)
                    except Exception:
                        # Loud fallback: silently reverting to pow-2 would
                        # make collapsed prefix-cache hit rates undiagnosable.
                        import logging

                        logging.getLogger(__name__).exception(
                            "failed to load request_router for %s/%s; "
                            "falling back to pow-2 routing",
                            self.app, self.deployment,
                        )
                        self.request_router = None
                else:
                    self.request_router = None
                # Release affinity pins to replicas that left the membership
                # — a dead replica's warm cache is gone with it, so requests
                # pinned there must re-route (and re-pin) via p2c.
                self.affinity.retain(handles)
                # Keep counts for surviving replicas; drop departed ones.
                self.ongoing = {n: self.ongoing.get(n, 0) for n in handles}
                self._grant_locked()  # fresh capacity: hand out slots in policy order
                self.cond.notify_all()

    # -- routing -----------------------------------------------------------
    def _has_capacity_locked(self) -> bool:
        return any(self.ongoing.get(n, 0) < self.max_ongoing for n in self.replicas)

    def _grant_locked(self):
        """Hand free replica slots to queued waiters in POLICY order (strict
        class priority -> DRR across tenants -> FIFO within a tenant). Runs
        under self.cond, called by whoever may have freed capacity: release,
        membership refresh, the completion drainer, and a fresh enqueue.
        Each granted waiter gets its slot reserved HERE (ongoing bumped
        before its event is set), so a slow-to-wake waiter can never lose
        its grant to a later one."""
        now = time.time()
        while not self._wfq.empty() and self._has_capacity_locked():
            w = self._wfq.pop_next()
            if w is None:
                break
            if w.deadline is not None and now >= w.deadline:
                # Expired while queued: never takes a slot. The waiter's
                # thread raises the (counted) DeadlineExceeded on wake.
                w.expired = True
                w.event.set()
                continue
            name = self._pick_locked(w.affinity)
            if name is None:
                # Unreachable today (_has_capacity_locked and _pick_locked
                # read the same state under the same lock), but if the two
                # ever drift the waiter must go back to the FRONT of its
                # tenant FIFO — a tail re-push would break FIFO silently.
                self._wfq.requeue_front(w)
                break
            self.ongoing[name] = self.ongoing.get(name, 0) + 1
            w.admitted = (name, self.replicas[name])
            w.event.set()

    def _admit(self, timeout_s: float, model_id: str = "", affinity_key: str = "",
               prefix_key: str = ""):
        """Block until this request is granted a replica slot by the fair
        queue; returns (name, handle) with the ongoing count already
        incremented. QoS: the active RequestContext supplies the priority
        class, tenant, and deadline; expiry raises a typed (and counted)
        DeadlineExceeded, plain admission timeout keeps raising
        TimeoutError."""
        ctx = _qos.current()
        now = time.time()
        qdl = ctx.deadline if ctx is not None else None
        if qdl is not None and now >= qdl:
            _qos.raise_expired("handle", f"{self.app}/{self.deployment} (on arrival)")
        deadline = now + timeout_s
        deadline_eff = deadline if qdl is None else min(deadline, qdl)
        w = Waiter(
            rank=ctx.rank if ctx is not None else 0,
            tenant=ctx.tenant if ctx is not None else _qos.DEFAULT_TENANT,
            affinity=self._routing_keys(model_id, affinity_key, prefix_key),
            deadline=deadline_eff,
            enqueued_at=now,
        )
        klass = ctx.priority if ctx is not None else _qos.DEFAULT_PRIORITY
        try:
            # Fresh handle / stale membership: fetch routing info BEFORE
            # parking — otherwise the first request per deployment per
            # process would sit a full wait slice with nobody to grant.
            self._maybe_refresh()
        except Exception:
            pass  # transient controller hiccup: retry until deadline
        with self.cond:
            self.queued += 1
            self._wfq.push(w)
            self._grant_locked()  # fast path: capacity free and we are next
        try:
            while True:
                with self.cond:
                    if w.admitted is not None:
                        waited = time.time() - w.enqueued_at
                        self._queue_delay.observe(waited, tags={"class": klass})
                        # Autopsy anchor: the admission-wait hop of a traced
                        # request (obs/autopsy.py). Free no-op when untraced.
                        from ray_tpu_torch.util import tracing as _tracing

                        _tracing.event("qos.admitted", waited_s=waited, cls=klass)
                        return w.admitted
                    if w.expired:
                        break  # counted below, outside the lock
                    now = time.time()
                    if now >= deadline_eff:
                        self._wfq.discard(w)
                        if qdl is not None and now >= qdl:
                            break
                        raise TimeoutError(
                            f"no replica of {self.app}/{self.deployment} had capacity "
                            f"within {timeout_s}s"
                        )
                    remaining = deadline_eff - now
                # Re-poll membership at least every REFRESH_S while queued.
                granted = w.event.wait(timeout=min(remaining, self.REFRESH_S))
                if granted:
                    continue
                with self.cond:
                    self.fetched_at = 0.0  # force refresh after a full wait
                try:
                    self._maybe_refresh()
                except Exception:
                    pass  # transient controller hiccup: retry until deadline
                with self.cond:
                    self._grant_locked()
        finally:
            with self.cond:
                self.queued -= 1
        if qdl is None or time.time() < qdl:
            # The waiter timed out at its ADMISSION deadline, not the
            # request's own deadline: keep the legacy contract.
            raise TimeoutError(
                f"no replica of {self.app}/{self.deployment} had capacity "
                f"within {timeout_s}s"
            )
        _qos.raise_expired("handle", f"{self.app}/{self.deployment} (while queued)")

    def _release(self, name: str):
        with self.cond:
            self.ongoing[name] = max(0, self.ongoing.get(name, 1) - 1)
            self._grant_locked()
            self.cond.notify_all()

    def _submission_ctx(self, rid: str):
        """The wire context the replica call ships: the caller's active
        RequestContext (or the default) with the handle-minted request id
        attached, so the replica can be told about cancellation."""
        base = _qos.current() or _qos.RequestContext()
        return _qos.to_wire(_dc_replace(base, rid=rid))

    def route(self, method: str, args: tuple, kwargs: dict, timeout_s: float = 60.0,
              model_id: str = "", affinity_key: str = "", prefix_key: str = "",
              rid: str = ""):
        """Pick a replica (pow-2 choices; sticky when a multiplexed model id,
        an affinity key, or a prompt-prefix key is set), submit, return
        (ref, name)."""
        name, replica = self._admit(timeout_s, model_id=model_id,
                                    affinity_key=affinity_key, prefix_key=prefix_key)
        token = _qos.activate(self._submission_ctx(rid))
        try:
            if model_id:
                ref = replica.handle_request.remote(method, args, kwargs, model_id)
            else:
                ref = replica.handle_request.remote(method, args, kwargs)
        except Exception:
            self._release(name)
            with self.cond:
                self.fetched_at = 0.0
            raise
        finally:
            _qos.deactivate(token)
        with self.cond:
            self._outstanding.append((ref, name))
            self._ensure_threads()
            self.cond.notify_all()  # wake the drainer (event-driven wait)
        return ref, name

    def route_streaming(self, method: str, args: tuple, kwargs: dict,
                        timeout_s: float = 60.0, proxy: bool = False,
                        model_id: str = "", affinity_key: str = "",
                        prefix_key: str = "", rid: str = ""):
        """Streaming variant: returns (ObjectRefGenerator, name). The ongoing
        count is held until the caller exhausts/closes the stream and calls
        _release(name) (DeploymentResponseGenerator owns that)."""
        name, replica = self._admit(timeout_s, model_id=model_id,
                                    affinity_key=affinity_key, prefix_key=prefix_key)
        actor_method = (
            replica.handle_request_proxy if proxy else replica.handle_request_streaming
        )
        token = _qos.activate(self._submission_ctx(rid))
        try:
            if model_id:
                gen = actor_method.options(num_returns="streaming").remote(
                    method, args, kwargs, model_id
                )
            else:
                gen = actor_method.options(num_returns="streaming").remote(method, args, kwargs)
        except Exception:
            self._release(name)
            with self.cond:
                self.fetched_at = 0.0
            raise
        finally:
            _qos.deactivate(token)
        with self.cond:
            self._ensure_threads()  # demand pusher must see streaming load too
        return gen, name

    def _cancel_downstream(self, name: str, rid: str):
        """Best-effort: tell the replica serving ``rid`` that its caller
        gave up (sets the request's cancel event — cooperative user code
        checks qos.cancel_requested() and frees the slot early)."""
        if not rid:
            return
        with self.cond:
            replica = self.replicas.get(name)
        if replica is None:
            return
        # Control-plane send: MUST NOT inherit the data request's (possibly
        # already-expired) context — the worker gate would drop the cancel
        # itself with a second counted expiry and the replica would never
        # see it.
        token = _qos.suspend()
        try:
            replica.cancel_request.remote(rid)
        except Exception:
            pass  # replica gone: nothing left to cancel
        finally:
            _qos.deactivate(token)

    @staticmethod
    def _routing_keys(model_id: str = "", affinity_key: str = "",
                      prefix_key: str = "") -> tuple:
        """Ordered sticky-key candidates for one request. Routing order is
        prefix -> affinity (model pins and explicit keys share the kind) ->
        p2c fallback; the namespacing prefixes keep the three key spaces
        collision-free inside the ONE AffinityMap."""
        keys = []
        if prefix_key:
            keys.append(("prefix", "p:" + prefix_key))
        if model_id:
            keys.append(("affinity", "m:" + model_id))
        if affinity_key:
            keys.append(("affinity", "k:" + affinity_key))
        return tuple(keys)

    def _pick_locked(self, keys: tuple = ()) -> Optional[str]:
        live = [n for n in self.replicas if self.ongoing.get(n, 0) < self.max_ongoing]
        if not live:
            return None
        # Warm-cache stickiness, most specific first: the replica pinned to
        # the request's prompt-prefix digest holds those KV pages hot; the
        # model/affinity pin holds the model loaded. Reuse while it has
        # capacity; otherwise fall through to pow-2 and re-pin every key to
        # the new pick (the new replica is now the warm one).
        for kind, key in keys:
            sticky = self.affinity.get(key)
            if sticky in live:
                self._cache_hit.inc(tags={"kind": kind})
                # The serving replica is now the warm one for EVERY key the
                # request carries (a prefix pin whose replica saturated
                # must follow the request to where it actually ran).
                for _okind, okey in keys:
                    if okey != key:
                        self.affinity.pin(okey, sticky)
                return sticky
        if len(live) == 1:
            pick = live[0]
        else:
            a, b = random.sample(live, 2)
            pick = a if self.ongoing.get(a, 0) <= self.ongoing.get(b, 0) else b
        for _kind, key in keys:
            self.affinity.pin(key, pick)
        self._cache_hit.inc(tags={"kind": "p2c"})
        return pick

    def fail_over(self, name: str):
        """A request observed this replica dead: force membership refresh."""
        with self.cond:
            self.version = -1
            self.fetched_at = 0.0
            self.cond.notify_all()

    # -- background: completion drain + demand metrics ---------------------
    def _ensure_threads(self):
        if self._drainer is None or not self._drainer.is_alive():
            self._drainer = threading.Thread(
                target=self._drain_loop, name=f"serve-drain-{self.deployment}", daemon=True
            )
            self._drainer.start()
        if self._pusher is None or not self._pusher.is_alive():
            self._pusher = threading.Thread(
                target=self._push_loop, name=f"serve-push-{self.deployment}", daemon=True
            )
            self._pusher.start()

    def _drain_loop(self):
        import ray_tpu_torch as rt

        idle_since = time.time()
        while not self._closed:
            with self.cond:
                pending = list(self._outstanding)
                if not pending:
                    if time.time() - idle_since > 10.0:
                        return  # thread parks; recreated on next route()
                    # Event-driven: route() notifies under this condition
                    # when it appends an outstanding request.
                    self.cond.wait(timeout=1.0)
                    continue
            idle_since = time.time()
            refs = [r for r, _ in pending]
            try:
                # Block until SOMETHING completes (event-driven in the core:
                # rt.wait parks on ready events, no client-side polling).
                ready, _ = rt.wait(refs, num_returns=1, timeout=1.0)
                if ready:
                    # Sweep everything already done in the same pass.
                    ready, _ = rt.wait(refs, num_returns=len(refs), timeout=0)
            except Exception:
                ready = refs  # core shut down: release everything
            if not ready:
                continue
            done = set(id(r) for r in ready)
            with self.cond:
                kept = []
                for ref, name in self._outstanding:
                    if id(ref) in done:
                        if name in self.ongoing:
                            self.ongoing[name] = max(0, self.ongoing[name] - 1)
                    else:
                        kept.append((ref, name))
                self._outstanding = kept
                self._grant_locked()  # freed slots flow to queued waiters in order
                self.cond.notify_all()

    def _push_loop(self):
        last = None
        while not self._closed:
            time.sleep(0.25)
            with self.cond:
                queued, ongoing = self.queued, sum(self.ongoing.values())
            demand = queued + ongoing
            self._queue_gauge.set(queued)
            self._ongoing_gauge.set(ongoing)
            if demand == 0 and last in (0, None):
                last = 0
                continue
            try:
                _controller().record_handle_metrics.remote(
                    self.app, self.deployment, id(self), demand, time.time()
                )
            except Exception:
                pass
            last = demand

    def close(self):
        self._closed = True
        # Zero the demand gauges: the registry is process-global and the
        # reporter keeps shipping last-set values — a closed handle must not
        # leave phantom queued/ongoing demand on /metrics forever.
        self._queue_gauge.set(0)
        self._ongoing_gauge.set(0)


class DeploymentResponse:
    """Future-like result of handle.remote() (reference: handle.py
    DeploymentResponse). `result()` retries once on replica death.

    Cancel-on-client-timeout: when `result(timeout)` gives up, the response
    cancels its in-flight downstream work instead of orphaning it — the
    handle's admission slot is released immediately and the replica's cancel
    event fires so cooperative user code (qos.cancel_requested(), the LLM
    generate loop) stops burning capacity for a departed caller."""

    def __init__(self, rs: _ReplicaSet, method: str, args: tuple, kwargs: dict,
                 model_id: str = "", affinity_key: str = "", prefix_key: str = ""):
        self._rs = rs
        self._method = method
        self._args = args
        self._kwargs = kwargs
        self._model_id = model_id
        self._affinity_key = affinity_key
        self._prefix_key = prefix_key
        self._rid = _qos.mint_rid()
        self._cancelled = False
        self._ref, self._idx = rs.route(method, args, kwargs, model_id=model_id,
                                        affinity_key=affinity_key,
                                        prefix_key=prefix_key, rid=self._rid)

    def result(self, timeout: float | None = 60.0):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.worker import ActorDiedError
        from ray_tpu_torch.qos import DeadlineExceeded

        for attempt in range(3):
            try:
                return rt.get(self._ref, timeout=timeout)
            except DeadlineExceeded:
                # The request died of ITS OWN deadline at some hop: there is
                # no downstream work left to cancel — surface it typed.
                raise
            except TimeoutError:
                # The CALLER gave up (result-timeout): free the admission
                # slot now and cancel the downstream work.
                self.cancel()
                raise
            except ActorDiedError:
                self._rs.fail_over(self._idx)
                if attempt == 2:
                    raise
                self._ref, self._idx = self._rs.route(
                    self._method, self._args, self._kwargs, model_id=self._model_id,
                    affinity_key=self._affinity_key, prefix_key=self._prefix_key,
                    rid=self._rid,
                )

    def cancel(self):
        """Abandon this request: release the handle's admission slot (the
        completion drainer will not double-release — the outstanding entry
        is withdrawn here) and fire the replica-side cancel event."""
        if self._cancelled:
            return
        self._cancelled = True
        rs = self._rs
        with rs.cond:
            before = len(rs._outstanding)
            rs._outstanding = [
                (r, n) for r, n in rs._outstanding if r is not self._ref
            ]
            withdrawn = len(rs._outstanding) != before
        if withdrawn:
            rs._release(self._idx)
        rs._cancel_downstream(self._idx, self._rid)

    def _to_object_ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call's yielded items (reference:
    handle.py DeploymentResponseGenerator over a streaming replica call).
    Holds one unit of the replica's ongoing-request budget until the stream
    is exhausted, errors, or is closed."""

    def __init__(self, rs: _ReplicaSet, method: str, args: tuple, kwargs: dict,
                 proxy: bool = False, model_id: str = "", affinity_key: str = "",
                 prefix_key: str = ""):
        self._rs = rs
        self._released = False
        self._rid = _qos.mint_rid()
        self._gen, self._name = rs.route_streaming(
            method, args, kwargs, proxy=proxy, model_id=model_id,
            affinity_key=affinity_key, prefix_key=prefix_key, rid=self._rid,
        )

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.worker import ActorDiedError

        try:
            ref = next(self._gen)
            return rt.get(ref, timeout=60)
        except StopIteration:
            self._release()
            raise
        except ActorDiedError:
            # No mid-stream retry: items may already have been delivered.
            self._rs.fail_over(self._name)
            self._release()
            raise
        except BaseException:
            self.close()  # producer may still be running: cancel it
            raise

    def _release(self):
        if not self._released:
            self._released = True
            self._rs._release(self._name)

    # -- async consumption (the proxy's no-pump-thread path) ---------------
    def arm_async(self, loop):
        """Forward the stream's arrival wakeups onto ``loop``; returns an
        asyncio.Event set whenever new items (or the finish) land. Pair with
        poll(): an event loop can drain the stream without parking a thread
        per chunk in __next__."""
        import asyncio

        ev = asyncio.Event()

        def wake():
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass  # consumer loop already closed; the stream is abandoned

        self._gen.set_wakeup(wake)
        return ev

    def disarm_async(self):
        """Drop the wakeup hook (the consumer loop is done with the stream)."""
        self._gen.set_wakeup(None)

    def poll(self):
        """Non-blocking probe mirroring __next__'s bookkeeping:
        ('item', ObjectRef) | ('wait', None) | ('end', None) |
        ('error', err). End/error release this stream's admission slot (the
        caller still owns close() for early abandonment)."""
        kind, payload = self._gen.poll()
        if kind == "end":
            self._release()
        elif kind == "error":
            from ray_tpu_torch.core.worker import ActorDiedError

            if isinstance(payload, ActorDiedError):
                # No mid-stream retry (items may already be delivered), but
                # the membership refresh must still happen.
                self._rs.fail_over(self._name)
            self._release()
        return kind, payload

    def close(self, abandon: bool = True):
        """Stop consuming: cancels the replica-side generator task (its next
        yield observes the close and the user generator is closed), fires
        the request's cancel event (a producer blocked BETWEEN yields — an
        engine wait loop — sees qos.cancel_requested() without waiting for
        its next yield), then frees this stream's admission slot.

        ``abandon=False``: the logical response already completed (the
        proxy's buffered 'value' reply) — skip the downstream cancel RPC;
        one control-plane actor call per plain HTTP request would be pure
        hot-path waste and would churn the replica's early-cancel memory.
        A stream whose final reply already landed (completed()) has nothing
        left to cancel either way."""
        self._gen.close()
        if abandon and not self._released and not self._gen.completed():
            self._rs._cancel_downstream(self._name, self._rid)
        self._release()

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


class DeploymentHandle:
    """Picklable handle to a deployment (rebuilds router state lazily in the
    destination process, so it can be shipped as a bind() init arg)."""

    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = "", affinity_key: str = "",
                 prefix_key: str = ""):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.method_name = method_name
        self.stream = stream
        self.multiplexed_model_id = multiplexed_model_id
        self.affinity_key = affinity_key
        self.prefix_key = prefix_key

    def options(self, method_name: Optional[str] = None, stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                affinity_key: Optional[str] = None,
                prefix_key: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name,
            self.app_name,
            self.method_name if method_name is None else method_name,
            self.stream if stream is None else stream,
            self.multiplexed_model_id if multiplexed_model_id is None else multiplexed_model_id,
            self.affinity_key if affinity_key is None else affinity_key,
            self.prefix_key if prefix_key is None else prefix_key,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, self.app_name, name,
                                self.stream, self.multiplexed_model_id,
                                self.affinity_key, self.prefix_key)

    def remote(self, *args, **kwargs):
        rs = _replica_set(self.app_name, self.deployment_name)
        if self.stream:
            return DeploymentResponseGenerator(rs, self.method_name, args, kwargs,
                                               model_id=self.multiplexed_model_id,
                                               affinity_key=self.affinity_key,
                                               prefix_key=self.prefix_key)
        return DeploymentResponse(rs, self.method_name, args, kwargs,
                                  model_id=self.multiplexed_model_id,
                                  affinity_key=self.affinity_key,
                                  prefix_key=self.prefix_key)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self.app_name,
                                   self.method_name, self.stream,
                                   self.multiplexed_model_id, self.affinity_key,
                                   self.prefix_key))

    def __repr__(self):
        return f"DeploymentHandle({self.app_name}/{self.deployment_name}.{self.method_name})"
