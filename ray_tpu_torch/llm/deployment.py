"""LLM serving callable: one engine, a background stepping thread, and
blocking and streaming generate for many concurrent callers.

Counterpart of ``ray_tpu/llm/deployment.py``'s ``LLMServer``. Concurrent
``generate`` calls land in the engine's waiting queue and are batched at
iteration level by the stepping thread, so caller concurrency maps directly
onto engine slots. ``generate_stream`` yields per-decode-block events as
they reach the host. A deadline or a cancelled caller aborts the engine
request, so its slot frees at once.

On the GPU the stepping thread launches the engine's kernels (K1 in
prefill, K4 in paged decode) on the default stream, as the constructor's
warmup does in the caller's thread: no thread sets a stream of its own.

``build_llm_app`` makes a serve application of it: each replica is an
actor that builds its own engine, and ``params`` may be an ``ObjectRef`` to
one tree in the object store that every replica fetches in its own process
(``torch.Tensor`` leaves move out of band). ``weights_channel`` subscribes
each replica to a checkpoint channel (``ray_tpu_torch.ckpt``): a manifest
published there is fetched and digest-verified off the engine's step lock,
then swapped in between two engine steps.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch.qos import context as _qos
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing


def _tensor_tree(tree):
    """The tree with its numpy leaves as CPU torch tensors (no copy)."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        import torch

        return torch.from_numpy(tree)
    return tree


def _coerce_sampling(sampling):
    """Accept a SamplingParams, a kwargs dict (the over-the-wire form), or
    None."""
    if sampling is None or not isinstance(sampling, dict):
        return sampling
    from ray_tpu_torch.llm.sampling import SamplingParams

    return SamplingParams(**sampling)


class LLMServer:
    """Hosts an LLMEngine and its stepping thread.

    Use through build_llm_app() or directly:
        app = serve.deployment(LLMServer).options(...).bind(cfg_kwargs, engine_kwargs)

    ``params``: the port's parameter tree (``ray_tpu_torch.convert.
    from_numpy_tree``), an ``ObjectRef`` to one, or None for seeded random
    weights. ``device``: None is the GPU (raising when none is visible);
    pass ``device="cpu"`` for the CPU."""

    def __init__(self, model_config: dict, engine_config: Optional[dict] = None,
                 warmup_buckets: Optional[tuple] = None, params=None,
                 weights_channel: Optional[str] = None, device=None):
        from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
        from ray_tpu_torch.models.transformer import TransformerConfig

        # train->serve weight handoff: `params` may be an ObjectRef to a
        # param tree in the object store; each replica fetches it here, in
        # its own process (a CUDA tensor lands on this process's current
        # device, one H2D copy per leaf; core/serialization.py).
        if params is not None:
            from ray_tpu_torch.core.object_ref import ObjectRef

            if isinstance(params, ObjectRef):
                import ray_tpu_torch as rt

                params = rt.get(params, timeout=300.0)
        cfg = TransformerConfig(**model_config)
        ec = EngineConfig(**(engine_config or {}))
        self.engine = LLMEngine(cfg, params=params, engine_config=ec, device=device)
        if warmup_buckets:
            # Build and run the prefill/decode shapes before serving: first
            # calls belong to startup, never to a request's TTFT.
            self.engine.warmup(buckets=tuple(warmup_buckets))
        self._cond = threading.Condition()
        self._done: dict[str, dict] = {}
        self._ttft: dict[str, float] = {}
        # Submit time (perf_counter) of each request whose first token has
        # not been handed over yet.
        self._submitted: dict[str, float] = {}
        # TTFT distribution (serve.ttft_s), the SLO engine's
        # time-to-first-token metric in the reference: from the call of
        # generate / generate_stream to the hand-over of the first event
        # with tokens to the request's stream or result.
        self._ttft_hist = _metrics.Histogram(
            "serve.ttft_s", "time to first token per request, submit to hand-over",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
            tag_keys=("deployment",),
        ).bind(tags={"deployment": "llm"})
        # Per-request event streams for generate_stream subscribers.
        self._streams: dict[str, deque] = {}
        # Requests whose caller gave up; the stepping thread aborts them in
        # the engine (frees their slots) before its next step.
        self._aborts: set[str] = set()
        self._counter = 0
        self._stop = False
        # Weight swap gate: step() and set_params() exclude each other, so a
        # swap lands between engine iterations — in-flight batches finish on
        # the old weights, no request ever reads a mixed tree.
        self._swap_lock = threading.Lock()
        self._weights_sub = None
        if weights_channel:
            # ckpt publication plane: subscribe this replica to the named
            # checkpoint channel; committed manifests hot-swap in place
            # (fetch + digest-verify happen OFF the swap lock).
            from ray_tpu_torch.ckpt import WeightSubscriber

            self._weights_sub = WeightSubscriber(weights_channel, self._swap_weights)
        self._thread = threading.Thread(target=self._loop, name="llm-engine", daemon=True)
        self._thread.start()

    def _swap_weights(self, tree, summary):
        tree = _tensor_tree(tree)  # a restored manifest's leaves are numpy
        with self._swap_lock:
            self.engine.set_params(tree)

    def apply_weights(self, tree) -> bool:
        """Push-style weight refresh (tests / manual rollout): same gate as
        the subscription path — lands between two engine steps, so in-flight
        batches finish their step on the old weights."""
        self._swap_weights(tree, None)
        return True

    def weights_version(self) -> Optional[str]:
        sub = self._weights_sub
        return sub.current_version if sub is not None else None

    def _loop(self):
        # A step that raises ends this thread (check_health turns false)
        # and waiting callers time out, as in the reference.
        while not self._stop:
            with self._cond:
                aborts, self._aborts = self._aborts, set()
                if not aborts and not self.engine.has_work():
                    self._cond.wait(timeout=0.05)
                    continue
            with self._swap_lock:
                if aborts:
                    # Under the condition's lock: add_request runs under it
                    # too, so no append races abort's rebuild of the queue.
                    with self._cond:
                        for rid in aborts:
                            self.engine.abort(rid)
                            self._submitted.pop(rid, None)
                if not self.engine.has_work():
                    continue
                events = self.engine.step()
            if not events:
                continue
            with self._cond:
                handed = time.perf_counter()
                for rid, ev in events.items():
                    # The engine repeats ttft_s on a finish event of a later
                    # step; keep each request's first (the reference
                    # observes both).
                    if ev.get("ttft_s") is not None and rid not in self._ttft:
                        self._ttft[rid] = ev["ttft_s"]
                    if ev.get("new_tokens") and rid in self._submitted:
                        self._ttft_hist.observe(handed - self._submitted.pop(rid))
                    stream = self._streams.get(rid)
                    if stream is not None:
                        stream.append(ev)
                    if ev.get("finished"):
                        self._submitted.pop(rid, None)
                        self._done[rid] = {
                            "tokens": ev["tokens"],
                            "ttft_s": self._ttft.pop(rid, ev.get("ttft_s")),
                            "finish_reason": ev.get("finish_reason"),
                        }
                self._cond.notify_all()

    def _new_rid(self) -> str:
        self._counter += 1
        return f"r{self._counter}-{time.monotonic_ns()}"

    def generate(self, tokens, max_tokens: int = 64, timeout_s: float = 300.0,
                 sampling=None) -> dict:
        """Blocking generate; safe to call from many threads at once — the
        engine batches all in-flight requests per decode iteration.
        sampling: per-request SamplingParams (or kwargs dict for one).

        QoS: an active RequestContext caps the wait at the request's
        deadline, and a caller that gave up (qos.cancel_requested()) ABORTS
        the engine request — in both cases the engine slot frees at once
        instead of decoding to completion for nobody."""
        submitted = time.perf_counter()
        sampling = _coerce_sampling(sampling)
        qctx = _qos.current()
        rem = qctx.remaining() if qctx is not None else None
        if rem is not None:
            timeout_s = min(timeout_s, max(rem, 0.0))
        cancellable = _qos.cancel_event() is not None
        # Short wait slices only when there is a cancel/deadline to notice.
        slice_s = 0.25 if (cancellable or rem is not None) else 1.0
        with _tracing.child_span("llm.generate", max_tokens=max_tokens):
            with self._cond:
                rid = self._new_rid()
                self._submitted[rid] = submitted
                self.engine.add_request(rid, tokens, max_tokens, sampling=sampling)
                self._cond.notify_all()
                deadline = time.time() + timeout_s
                while rid not in self._done:
                    if cancellable and _qos.cancel_requested():
                        self._aborts.add(rid)
                        self._cond.notify_all()
                        raise _qos.RequestCancelled(
                            "caller abandoned generate(); engine slot freed")
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        # Free the slot: a timed-out request must not keep
                        # decoding to completion.
                        self._aborts.add(rid)
                        self._cond.notify_all()
                        if qctx is not None and qctx.expired():
                            _qos.raise_expired("llm", "generate")
                        raise TimeoutError(f"generate timed out after {timeout_s}s")
                    self._cond.wait(timeout=min(remaining, slice_s))
                return self._done.pop(rid)

    def generate_stream(self, tokens, max_tokens: int = 64, timeout_s: float = 300.0,
                        sampling=None):
        """Streaming generate: yields one event dict per engine step that
        produced tokens for this request ({"new_tokens": [...], "ttft_s":
        float|None, "finished": bool}, final event carries "tokens" and
        "finish_reason").

        QoS: the wait is capped at the request's deadline and a cancelled
        caller aborts the engine request between yields; closing the
        generator early aborts it too."""
        submitted = time.perf_counter()
        sampling = _coerce_sampling(sampling)
        qctx = _qos.current()
        rem = qctx.remaining() if qctx is not None else None
        if rem is not None:
            timeout_s = min(timeout_s, max(rem, 0.0))
        cancellable = _qos.cancel_event() is not None
        slice_s = 0.25 if (cancellable or rem is not None) else 1.0
        with self._cond:
            rid = self._new_rid()
            self._streams[rid] = deque()
            self._submitted[rid] = submitted
            self.engine.add_request(rid, tokens, max_tokens, sampling=sampling)
            self._cond.notify_all()
        deadline = time.time() + timeout_s
        finished = False
        try:
            while True:
                with self._cond:
                    while not self._streams[rid]:
                        if cancellable and _qos.cancel_requested():
                            raise _qos.RequestCancelled(
                                "caller abandoned generate_stream(); engine slot freed")
                        remaining = deadline - time.time()
                        if remaining <= 0:
                            if qctx is not None and qctx.expired():
                                _qos.raise_expired("llm", "generate_stream")
                            raise TimeoutError(f"generate timed out after {timeout_s}s")
                        self._cond.wait(timeout=min(remaining, slice_s))
                    ev = self._streams[rid].popleft()
                out = {
                    "new_tokens": ev.get("new_tokens", []),
                    "ttft_s": ev.get("ttft_s"),
                    "finished": bool(ev.get("finished")),
                }
                if out["finished"]:
                    out["tokens"] = ev.get("tokens", [])
                    out["finish_reason"] = ev.get("finish_reason")
                    finished = True
                yield out
                if finished:
                    return
        finally:
            with self._cond:
                self._streams.pop(rid, None)
                self._done.pop(rid, None)
                self._submitted.pop(rid, None)
                if not finished:
                    # Consumer left early (client disconnect): free the slot.
                    self._aborts.add(rid)
                    self._cond.notify_all()

    def _sse_stream(self, tokens, max_tokens: int, sampling=None):
        """OpenAI-style SSE frames: one `data: {json}` frame per event, then
        `data: [DONE]`."""
        for ev in self.generate_stream(tokens, max_tokens, sampling=sampling):
            yield f"data: {json.dumps(ev)}\n\n"
        yield "data: [DONE]\n\n"

    def __call__(self, request):
        """Accepts a serve HTTP Request (JSON body) or a plain dict:
        {"tokens": [...], "max_tokens": N, "stream": bool, plus optional
        per-request sampling: temperature/top_p/top_k/ignore_eos}. With
        stream=true returns a generator of SSE frames; otherwise blocks and
        returns the full completion."""
        if hasattr(request, "json") and not isinstance(request, dict):
            payload = request.json()
        else:
            payload = request
        tokens = payload["tokens"]
        max_tokens = int(payload.get("max_tokens", 64))
        sampling = {
            k: payload[k]
            for k in ("temperature", "top_p", "top_k", "ignore_eos")
            if k in payload
        }
        if sampling:
            # A partial dict must not silently flip temperature to greedy:
            # absent keys inherit the engine's configured default.
            sampling.setdefault("temperature", self.engine.ec.temperature)
            sampling = dict(sampling, max_tokens=max_tokens)
        else:
            sampling = None
        if payload.get("stream"):
            return self._sse_stream(tokens, max_tokens, sampling)
        return self.generate(tokens, max_tokens, sampling=sampling)

    def check_health(self) -> bool:
        return self._thread.is_alive()

    def stats(self) -> dict:
        active = sum(1 for s in self.engine.slots if s is not None)
        out = {"active_slots": active, "waiting": len(self.engine.waiting)}
        if self.engine.ec.prefix_cache:
            out["prefix_cache"] = self.engine.prefix_cache_stats
        return out

    def __raytpu_exit__(self):
        """Stops the stepping thread and waits for it (a step in flight
        finishes first)."""
        self._stop = True
        if self._weights_sub is not None:
            self._weights_sub.stop()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=60.0)


def build_llm_app(model_config: dict, engine_config: Optional[dict] = None,
                  num_replicas: int = 1, max_ongoing_requests: Optional[int] = None,
                  warmup_buckets: Optional[tuple] = None,
                  ray_actor_options: Optional[dict] = None,
                  params=None, weights_channel: Optional[str] = None,
                  autoscaling_config=None, device=None):
    """Build a serve application serving this model. max_ongoing_requests
    defaults to the engine's slot count (router admission == engine capacity).
    params: trained weights, a param tree or an ObjectRef to one (the
    train->serve handoff: one put, each replica fetches it).
    weights_channel: subscribe every replica to this named checkpoint
    channel — committed manifests hot-swap weights in place, no restart.
    autoscaling_config: AutoscalingConfig (or kwargs dict);
    the replica count then floats between min/max, driven by the scale
    plane's demand + QoS signals (ray_tpu_torch/scale/) instead of
    num_replicas. ray_actor_options={"num_gpus": f} gives each replica a
    share f of a card; with tensor_parallel > 1 a replica demands that many
    GPUs unless num_gpus says otherwise. device: passed on to each replica's LLMServer (None
    is the GPU, raising in the replica when none is visible)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.engine import EngineConfig

    ec = EngineConfig(**(engine_config or {}))
    if isinstance(autoscaling_config, dict):
        autoscaling_config = serve.AutoscalingConfig(**autoscaling_config)
    aopts = dict(ray_actor_options or {})
    if ec.tensor_parallel > 1:
        # Tensor-parallel replica: gang-schedule it onto a node with that
        # many GPUs (the reference demands {"TPU": tp}); its engine builds
        # its mesh over the cards (or slots) the replica's process sees.
        aopts.setdefault("num_gpus", float(ec.tensor_parallel))
    dep = serve.deployment(LLMServer).options(
        name="llm",
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests or ec.max_slots,
        ray_actor_options=aopts,
        autoscaling_config=autoscaling_config,
    )
    return dep.bind(model_config, engine_config, warmup_buckets, params, weights_channel,
                    device)
