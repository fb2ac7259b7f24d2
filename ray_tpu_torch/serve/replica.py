"""Replica actor: hosts one copy of a deployment's user callable.

Role-equivalent to the reference's RayServeReplica / UserCallableWrapper
(python/ray/serve/_private/replica.py — request wrapper,
ongoing-request accounting, reconfigure, health checks). Ordering departs
from the reference: methods run on the actor's thread pool (max_concurrency
sized to max_ongoing_requests), and admission control lives in the router,
which never exceeds a replica's advertised capacity.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.qos import context as _qos
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing


class Replica:
    """Generic replica actor body (created by the ServeController)."""

    def __init__(
        self,
        app_name: str,
        deployment_name: str,
        replica_id: str,
        user_callable: Any,
        init_args: tuple,
        init_kwargs: dict,
        user_config: Any = None,
    ):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._ongoing = 0
        self._total = 0
        self._started_at = time.time()
        # QoS cancellation: rid -> Event for requests executing HERE, plus a
        # bounded memory of cancels that arrived before their request did
        # (cancel_request and the request ride separate frames).
        self._cancel_events: dict[str, threading.Event] = {}
        self._cancelled_early: dict[str, float] = {}
        self._cancel_early_dropped = 0  # counted trim: bounded memory
        # Per-deployment runtime metrics (reporter -> controller -> /metrics):
        # request latency histogram + request counter, tagged by app/deployment
        # so multi-app clusters stay separable on the Prometheus side.
        tags = {"app": app_name, "deployment": deployment_name}
        self._latency_metric = _metrics.Histogram(
            "serve.request.latency_s",
            "serve request latency per deployment (seconds)",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
            tag_keys=("app", "deployment", "cls", "tenant"),
        )
        self._latency_tags = tags
        self._latency = self._latency_metric.bind(tags)
        # Per-(class, tenant) bound series so SLO objectives can scope
        # latency to a priority class / tenant (obs/slo.py). Each request
        # lands in EXACTLY ONE series (qos-scoped when a RequestContext rode
        # the call, the plain deployment series otherwise), so summing
        # matching series never double-counts. Bounded: past the cap, new
        # (class, tenant) pairs coarsen into the plain series — observations
        # are never dropped, only their tags.
        self._latency_by: dict[tuple, Any] = {}
        self._LATENCY_SERIES_CAP = 64
        self._requests = _metrics.Counter(
            "serve.requests", "serve requests handled per deployment",
            tag_keys=("app", "deployment"),
        ).set_default_tags(tags)
        if isinstance(user_callable, type):
            self._instance = user_callable(*init_args, **init_kwargs)
            self._is_function = False
        else:
            if init_args or init_kwargs:
                raise TypeError("function deployments take no bind() args")
            self._instance = user_callable
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)

    def _observe_latency(self, dt: float):
        """Record one request's latency into its (class, tenant)-scoped
        series when a RequestContext is active, else the plain deployment
        series. Bound series are cached, so the steady-state cost matches
        the old single bind (dict lookup + bisect)."""
        ctx = _qos.current()
        if ctx is None:
            self._latency.observe(dt)
            return
        key = (ctx.priority, ctx.tenant)
        bound = self._latency_by.get(key)
        if bound is None:
            if len(self._latency_by) >= self._LATENCY_SERIES_CAP:
                self._latency.observe(dt)  # cardinality cap: coarsen, never drop
                return
            bound = self._latency_metric.bind(
                {**self._latency_tags, "cls": ctx.priority, "tenant": ctx.tenant})
            self._latency_by[key] = bound
        bound.observe(dt)

    # -- data path ---------------------------------------------------------
    def _resolve_fn(self, method: str):
        if self._is_function:
            if method not in ("__call__", ""):
                raise AttributeError(
                    f"function deployment {self.deployment_name} has no method {method!r}"
                )
            return self._instance
        return getattr(self._instance, method or "__call__")

    def _enter_request(self, method: str):
        """Shared per-request prologue for all three call paths.

        1. QoS "replica" inbox gate: a request whose deadline already passed
           is dropped HERE, typed and counted — it never reaches user code
           (the core invariant the overload_storm scenario pins).
        2. serve.replica.slow chaos gate: injected per-request exec delay
           (AFTER the gate — it models slow execution, not a bypassed gate).
        3. Cancel-event registration for the request's rid, so cooperative
           user code sees qos.cancel_requested() when the caller gives up.

        Returns (rid, cancel_token, gate_now) for _leave_request."""
        gate_now = _qos.check_deadline(
            "replica", detail=f"{self.deployment_name}.{method or '__call__'}")
        # Tripwire BEFORE the chaos delay: the delay models slow EXECUTION
        # (the request legitimately began unexpired); a long-stale deadline
        # here means an upstream gate was bypassed.
        _qos.mark_exec_start("replica")
        fault = _chaos.maybe_inject("serve.replica.slow",
                                    deployment=self.deployment_name,
                                    method=method or "__call__")
        if fault is not None and fault.kind == "delay":
            time.sleep(fault.delay_s)
        ctx = _qos.current()
        rid = ctx.rid if ctx is not None else ""
        token = None
        if rid:
            ev = threading.Event()
            with self._lock:
                if self._cancelled_early.pop(rid, None) is not None:
                    ev.set()  # the cancel frame outran the request frame
                self._cancel_events[rid] = ev
            token = _qos.set_cancel_event(ev)
        return rid, token, gate_now

    def _leave_request(self, rid: str, token):
        if rid:
            with self._lock:
                self._cancel_events.pop(rid, None)
            _qos.reset_cancel_event(token)

    def cancel_request(self, rid: str) -> bool:
        """The caller abandoned request ``rid`` (client timeout/disconnect):
        fire its cancel event so the executing user code can bail and free
        this replica's capacity. Cancels that arrive before their request
        are remembered (bounded, counted trim)."""
        with self._lock:
            ev = self._cancel_events.get(rid)
            if ev is not None:
                ev.set()
                return True
            self._cancelled_early[rid] = time.time()
            while len(self._cancelled_early) > 4096:
                self._cancelled_early.pop(next(iter(self._cancelled_early)))
                self._cancel_early_dropped += 1
        return False

    def handle_request(self, method: str, args: tuple, kwargs: dict, model_id: str = ""):
        from ray_tpu_torch.serve.multiplex import _set_model_id

        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = _set_model_id(model_id) if model_id else None
        rid = qtoken = None
        t0 = time.perf_counter()
        try:
            # child_span: a no-op unless the caller's trace context arrived
            # with the actor call (proxy/handle root span).
            with _tracing.child_span(f"serve.replica.{self.deployment_name}",
                                     method=method or "__call__"):
                rid, qtoken, _ = self._enter_request(method)
                return self._resolve_fn(method)(*args, **kwargs)
        finally:
            self._leave_request(rid or "", qtoken)
            self._observe_latency(time.perf_counter() - t0)
            self._requests.inc()
            if token is not None:
                from ray_tpu_torch.serve.multiplex import _model_id_ctx

                _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method: str, args: tuple, kwargs: dict,
                                 model_id: str = ""):
        """Streaming call path: the user callable must return a generator;
        each yielded item ships to the caller as its own streamed return
        (reference: replica.py streaming generator user code riding
        ReportGeneratorItemReturns). Invoked with num_returns='streaming'."""
        import inspect

        from ray_tpu_torch.serve.multiplex import _model_id_ctx, _set_model_id

        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = _set_model_id(model_id) if model_id else None
        rid = qtoken = None
        t0 = time.perf_counter()
        try:
            with _tracing.child_span(f"serve.replica.{self.deployment_name}",
                                     method=method or "__call__", stream=True):
                rid, qtoken, _ = self._enter_request(method)
                out = self._resolve_fn(method)(*args, **kwargs)
                if not inspect.isgenerator(out) and not hasattr(out, "__next__"):
                    raise TypeError(
                        f"deployment {self.deployment_name}.{method or '__call__'} was called "
                        f"with stream=True but returned {type(out).__name__}, not a generator"
                    )
                yield from out
        finally:
            self._leave_request(rid or "", qtoken)
            self._observe_latency(time.perf_counter() - t0)
            self._requests.inc()
            if token is not None:
                _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1

    def handle_request_proxy(self, method: str, args: tuple, kwargs: dict,
                             model_id: str = ""):
        """HTTP-proxy call path: always streamed on the wire, tagged so the
        proxy can choose a buffered response for plain results and chunked
        transfer for generator results without knowing the deployment's shape
        up front. Yields ('value', x) once, or ('chunk', x) per item."""
        import inspect

        from ray_tpu_torch.serve.multiplex import _model_id_ctx, _set_model_id

        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = _set_model_id(model_id) if model_id else None
        rid = qtoken = None
        t0 = time.perf_counter()
        try:
            with _tracing.child_span(f"serve.replica.{self.deployment_name}",
                                     method=method or "__call__", proxy=True):
                rid, qtoken, _ = self._enter_request(method)
                out = self._resolve_fn(method)(*args, **kwargs)
                if inspect.isgenerator(out) or (
                    hasattr(out, "__next__") and not isinstance(out, (str, bytes))
                ):
                    for item in out:
                        yield ("chunk", item)
                else:
                    yield ("value", out)
        finally:
            self._leave_request(rid or "", qtoken)
            self._observe_latency(time.perf_counter() - t0)
            self._requests.inc()
            if token is not None:
                _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1

    # -- control path ------------------------------------------------------
    def get_metrics(self) -> dict:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "ongoing": self._ongoing,
                "total": self._total,
                "uptime_s": time.time() - self._started_at,
            }

    def reconfigure(self, user_config: Any) -> None:
        """Propagate dynamic config (reference: replica.py reconfigure)."""
        if not self._is_function and hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)

    def heartbeat(self) -> dict:
        """Health + queue depth in one round trip (controller health loop).
        The ongoing count is the scale plane's server-side demand signal —
        it survives a handle process dying with its demand reports."""
        with self._lock:
            ongoing, total = self._ongoing, self._total
        return {"healthy": self.check_health(), "ongoing": ongoing, "total": total}

    def check_health(self) -> bool:
        if not self._is_function and hasattr(self._instance, "check_health"):
            try:
                self._instance.check_health()
            except Exception:
                traceback.print_exc()
                return False
        return True

    def prepare_for_shutdown(self) -> None:
        """Drain: wait (bounded) for ongoing requests to finish."""
        deadline = time.time() + 5.0
        while time.time() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return
            time.sleep(0.02)
