"""OpenAI-compatible text surface over the port's LLMServer.

Counterpart of ``ray_tpu/llm/openai.py``: one callable that owns the
tokenizer AND the engine, speaking the serve ``Request``/SSE protocol. Text
in, text out:

    srv = OpenAIServer(model_config, engine_config, tokenizer="tok.json")
    srv({"prompt": "hello", "max_tokens": 16})             # /v1/completions
    srv({"messages": [{"role": "user", "content": "hi"}],  # /v1/chat/completions
         "stream": True})                                  # -> SSE frames

Per-request sampling rides SamplingParams into the engine, so one continuous
batch mixes greedy and sampled requests. Stop STRINGS are applied here at
the text layer (with holdback so a stop sequence split across decode blocks
never leaks to the client); stop token ids and eos retire in the engine.

DEVIATION from the OpenAI API (the reference's): a request that omits
`temperature` inherits the ENGINE's configured default
(EngineConfig.temperature, 0.0 = greedy) — not OpenAI's 1.0. It is
advertised in /v1/models metadata (`default_temperature`).

``build_openai_app`` makes a serve application of it, reached through the
HTTP proxy (``serve.run(app, route_prefix="/")``, then POST
``/v1/completions`` or ``/v1/chat/completions`` to ``serve.http_port()``).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Optional

from ray_tpu_torch import qos
from ray_tpu_torch.llm.deployment import LLMServer
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.llm.tokenizer import load_tokenizer
from ray_tpu_torch.serve.proxy import HTTPResponse
from ray_tpu_torch.util import tracing as _tracing


def _as_tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


class _StopTruncator:
    """Incremental detokenizer + stop-string application for one stream.

    Feeds on token ids, emits text deltas. Holds back (a) trailing bytes of
    an incomplete UTF-8 character (byte-level BPE can split a char across
    tokens) and (b) any suffix that is a prefix of a stop string, so a stop
    sequence arriving across two decode blocks is still caught before any
    part of it reaches the client."""

    def __init__(self, tok, stops: tuple):
        self.tok = tok
        self.stops = tuple(s for s in stops if s)
        self.ids: list[int] = []
        self.emitted = 0  # chars of `text` already released
        self.stopped = False

    def feed(self, new_ids) -> str:
        """Returns the text delta safe to emit for these new token ids."""
        if self.stopped:
            return ""
        self.ids.extend(int(t) for t in new_ids)
        text = self.tok.decode(self.ids)
        # Check stops against the full text (stop may span block boundary).
        cut = None
        for s in self.stops:
            pos = text.find(s, max(0, self.emitted - max(len(x) for x in self.stops)))
            if pos != -1 and (cut is None or pos < cut):
                cut = pos
        if cut is not None:
            self.stopped = True
            delta = text[self.emitted:cut]
            self.emitted = cut
            return delta
        # Hold back partial UTF-8 (shows as U+FFFD at the tail) and possible
        # stop-string prefixes.
        hold = 0
        while hold < len(text) and text[len(text) - 1 - hold] == "�":
            hold += 1
        safe_end = len(text) - hold
        for s in self.stops:
            for k in range(min(len(s) - 1, safe_end), 0, -1):
                if text[:safe_end].endswith(s[:k]):
                    safe_end -= k
                    break
        if safe_end <= self.emitted:
            return ""
        delta = text[self.emitted:safe_end]
        self.emitted = safe_end
        return delta

    def flush(self) -> str:
        """Release held-back text at end of stream (no stop ever completed)."""
        if self.stopped:
            return ""
        text = self.tok.decode(self.ids)
        while text.endswith("�"):
            text = text[:-1]  # a split char at EOS can never complete
        delta = text[self.emitted:]
        self.emitted = len(text)
        return delta


class OpenAIServer:
    """OpenAI-compatible request surface over an LLMServer (and its
    LLMEngine). ``device``: None is the GPU (raising when none is visible);
    pass ``device="cpu"`` for the CPU.

    Routes (a ``Request``'s path; a dict body picks its route by shape):
      GET  /v1/models
      POST /v1/completions        (prompt: str)
      POST /v1/chat/completions   (messages: [{role, content}, ...])
    Both POST routes accept stream, temperature, top_p, top_k, max_tokens,
    stop (str | [str]), ignore_eos.
    """

    def __init__(self, model_config: dict, engine_config: Optional[dict] = None,
                 tokenizer: Optional[str] = None, model_name: str = "ray-tpu-llm",
                 warmup_buckets: Optional[tuple] = None,
                 chat_template: Optional[str] = None, device=None):
        self.tok = load_tokenizer(tokenizer)
        self.model_name = model_name
        self.created = int(time.time())
        # Chat prompt rendering, in precedence order (reference: vLLM's
        # template resolution — explicit template arg, else the checkpoint's
        # own tokenizer template):
        # 1. `chat_template` containing jinja syntax -> rendered with
        #    (messages, add_generation_prompt), HF template semantics.
        # 2. no arg + an HF tokenizer that ships chat_template -> the
        #    checkpoint's own format (what the model was tuned on).
        # 3. legacy format string: "{messages}" substituted with
        #    "role: content\n" turns (the dependency-free fallback).
        self.chat_template = chat_template or "{messages}assistant:"
        self._jinja = None
        if chat_template and ("{%" in chat_template or "{{" in chat_template):
            import jinja2

            env = jinja2.Environment(
                trim_blocks=True, lstrip_blocks=True,
                undefined=jinja2.StrictUndefined,
            )
            # The globals HF templates rely on (Llama-2 uses bos_token/
            # eos_token; many use raise_exception for role validation).
            inner = getattr(self.tok, "_tok", None)
            env.globals["bos_token"] = getattr(inner, "bos_token", None) or ""
            env.globals["eos_token"] = getattr(inner, "eos_token", None) or ""

            def _raise(msg):
                raise ValueError(f"chat template error: {msg}")

            env.globals["raise_exception"] = _raise
            self._jinja = env.from_string(chat_template)
        self._use_tok_template = (
            chat_template is None
            and getattr(self.tok, "chat_template", None) is not None
        )
        ec = dict(engine_config or {})
        if "eos_id" not in ec and self.tok.eos_id >= 0:
            ec["eos_id"] = self.tok.eos_id
        # Requests that omit temperature inherit the engine default (see
        # module docstring: deliberate deviation from OpenAI's 1.0).
        self.default_temperature = float(ec.get("temperature", 0.0))
        self._llm = LLMServer(model_config, ec, warmup_buckets=warmup_buckets, device=device)

    # -- request plumbing --------------------------------------------------
    def _error(self, status: int, msg: str, etype: str = "invalid_request_error"):
        return HTTPResponse(
            status, json.dumps({"error": {"message": msg, "type": etype}})
        )

    def _qos_scope(self, request, body: dict):
        """Map the request's QoS fields into a RequestContext for the
        generate call: ``x-priority`` / ``x-tenant`` / ``x-request-timeout-s``
        headers (the proxy's convention) or, for handle/dict callers, the
        body keys ``priority`` / ``tenant`` / ``timeout_s``. Inherits any
        context already propagated from the proxy (request_context layers
        over it); returns a no-op scope when nothing is specified."""
        headers = getattr(request, "headers", None) or {}
        prio = (headers.get("x-priority") or body.get("priority") or "").strip().lower()
        tenant = (headers.get("x-tenant") or body.get("tenant") or "").strip()
        tmo = qos.parse_timeout_s(headers.get("x-request-timeout-s") or body.get("timeout_s"))
        if not (prio or tenant or tmo > 0):
            return contextlib.nullcontext()
        deadline = None
        if tmo > 0:
            deadline = _tracing.now() + tmo
            cur = qos.current()
            if cur is not None and cur.deadline is not None:
                # The proxy already minted this request's deadline at INGRESS;
                # re-deriving here would hand back the time already spent
                # queued. A deadline only ever tightens downstream.
                deadline = min(deadline, cur.deadline)
        return qos.request_context(
            priority=prio if prio in qos.PRIORITIES else None,
            tenant=tenant or None,
            deadline=deadline,
        )

    def _sampling(self, body: dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(body.get("temperature", self.default_temperature)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            max_tokens=int(body.get("max_tokens", 128)),
            ignore_eos=bool(body.get("ignore_eos", False)),
        )

    def _chat_prompt(self, messages) -> tuple[str, bool]:
        """Returns (prompt, templated): templated prompts already carry
        their own special tokens (BOS etc.), so encode must NOT add BOS
        again — most HF templates open with the bos text and a second
        bos_id would push the prompt off the model's trained distribution."""
        if self._jinja is not None:
            import jinja2

            try:
                return (
                    self._jinja.render(messages=messages, add_generation_prompt=True),
                    True,
                )
            except jinja2.TemplateError as e:  # surfaces as a 400, not a 500
                raise ValueError(f"chat template error: {e}") from e
        if self._use_tok_template:
            return self.tok.apply_chat_template(messages, add_generation_prompt=True), True
        turns = "".join(f"{m.get('role', 'user')}: {m.get('content', '')}\n" for m in messages)
        return self.chat_template.format(messages=turns), False

    def __call__(self, request):
        if isinstance(request, dict):
            # Handle-call convention (no HTTP): infer the route from the
            # body shape — messages => chat, prompt => completions.
            path = "/v1/chat/completions" if "messages" in request else "/v1/completions"
            method = "POST"
        else:
            path = getattr(request, "path", "/")
            method = getattr(request, "method", "POST")
        if path.rstrip("/") == "/v1/models":
            return {
                "object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "created": self.created, "owned_by": "ray_tpu",
                          # Deviation note: omitted temperature => this
                          # value, not OpenAI's 1.0 (module docstring).
                          "default_temperature": self.default_temperature}],
            }
        is_chat = path.rstrip("/") == "/v1/chat/completions"
        if not is_chat and path.rstrip("/") != "/v1/completions":
            return self._error(404, f"no route {path}")
        if method != "POST":
            return self._error(405, f"{method} not allowed on {path}")
        try:
            body = request.json() if not isinstance(request, dict) else request
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            templated = False
            if is_chat:
                messages = body["messages"]
                prompt, templated = self._chat_prompt(messages)
            else:
                prompt = body["prompt"]
                if not isinstance(prompt, str):
                    raise ValueError("prompt must be a string")
            sp = self._sampling(body)
            stops = _as_tuple(body.get("stop"))
        except (KeyError, ValueError, TypeError) as e:
            return self._error(400, str(e))
        # Templated prompts already contain their special tokens.
        prompt_ids = self.tok.encode(prompt, add_bos=not templated)
        rid = f"{'chatcmpl' if is_chat else 'cmpl'}-{time.monotonic_ns():x}"
        scope = self._qos_scope(request, body)
        if body.get("stream"):
            return self._stream_scoped(scope, rid, is_chat, prompt_ids, sp, stops)
        with scope:
            return self._complete(rid, is_chat, prompt_ids, sp, stops, len(prompt_ids))

    def _stream_scoped(self, scope, rid, is_chat, prompt_ids, sp, stops):
        """Generator wrapper keeping the QoS scope active for the STREAM's
        whole body (the generator runs lazily, after __call__ returned —
        a plain `with` in __call__ would reset the context before the first
        token is generated)."""
        with scope:
            yield from self._stream(rid, is_chat, prompt_ids, sp, stops)

    # -- non-streaming -----------------------------------------------------
    def _complete(self, rid, is_chat, prompt_ids, sp, stops, n_prompt):
        out = self._llm.generate(prompt_ids, sampling=sp)
        trunc = _StopTruncator(self.tok, stops)
        text = trunc.feed(out["tokens"]) + trunc.flush()
        # Engine's retire cause ("stop" = eos/stop-token, "length" =
        # max_tokens OR the max_seq context cap); a text-layer stop string
        # overrides to "stop".
        finish = "stop" if trunc.stopped else (out.get("finish_reason") or "stop")
        usage = {
            "prompt_tokens": n_prompt,
            "completion_tokens": len(out["tokens"]),
            "total_tokens": n_prompt + len(out["tokens"]),
        }
        if is_chat:
            return {
                "id": rid, "object": "chat.completion", "created": int(time.time()),
                "model": self.model_name,
                "choices": [{"index": 0,
                             "message": {"role": "assistant", "content": text},
                             "finish_reason": finish}],
                "usage": usage,
            }
        return {
            "id": rid, "object": "text_completion", "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "text": text, "finish_reason": finish}],
            "usage": usage,
        }

    # -- streaming ---------------------------------------------------------
    def _chunk(self, rid, is_chat, delta_text, finish=None, first=False) -> str:
        if is_chat:
            delta = {}
            if first:
                delta["role"] = "assistant"
            if delta_text:
                delta["content"] = delta_text
            choice = {"index": 0, "delta": delta, "finish_reason": finish}
            obj = "chat.completion.chunk"
        else:
            choice = {"index": 0, "text": delta_text, "finish_reason": finish}
            obj = "text_completion"
        payload = {"id": rid, "object": obj, "created": int(time.time()),
                   "model": self.model_name, "choices": [choice]}
        return f"data: {json.dumps(payload)}\n\n"

    def _delta_renderer(self, rid, is_chat):
        """Pre-render the static SSE envelope once per stream: the per-token
        cost becomes one json.dumps of the delta STRING spliced between two
        constant halves, instead of a fresh nested dict + full json.dumps
        per chunk. Built by dumping the real chunk dict around a sentinel
        and splitting on it, so the rendered bytes track _chunk's schema
        exactly (model names with quotes and all). `created` freezes at
        stream start — one timestamp per stream, the OpenAI convention."""
        sentinel = "\u0000raytpu\u0000"
        if is_chat:
            choice = {"index": 0, "delta": {"content": sentinel}, "finish_reason": None}
            obj = "chat.completion.chunk"
        else:
            choice = {"index": 0, "text": sentinel, "finish_reason": None}
            obj = "text_completion"
        envelope = json.dumps({
            "id": rid, "object": obj, "created": int(time.time()),
            "model": self.model_name, "choices": [choice],
        })
        head, tail = envelope.split(json.dumps(sentinel))
        head = "data: " + head
        tail = tail + "\n\n"

        def render(delta_text: str) -> str:
            return head + json.dumps(delta_text) + tail

        return render

    def _stream(self, rid, is_chat, prompt_ids, sp, stops):
        trunc = _StopTruncator(self.tok, stops)
        render = self._delta_renderer(rid, is_chat)
        first = True
        engine_finish = None
        for ev in self._llm.generate_stream(prompt_ids, sampling=sp):
            delta = trunc.feed(ev.get("new_tokens", ()))
            if first:
                # First chunk carries the role (chat) — full dict path.
                yield self._chunk(rid, is_chat, delta, first=True)
                first = False
            elif delta:
                yield render(delta)  # the hot per-token path
            if ev.get("finished"):
                engine_finish = ev.get("finish_reason")
            if trunc.stopped or ev.get("finished"):
                break
        tail = trunc.flush()
        if tail:
            if first:
                yield self._chunk(rid, is_chat, tail, first=True)
                first = False
            else:
                yield render(tail)
        finish = "stop" if trunc.stopped else (engine_finish or "stop")
        yield self._chunk(rid, is_chat, "", finish=finish, first=first)
        yield "data: [DONE]\n\n"

    # -- serve integration -------------------------------------------------
    def check_health(self) -> bool:
        return self._llm.check_health()

    def stats(self) -> dict:
        return self._llm.stats()

    def __raytpu_exit__(self):
        self._llm.__raytpu_exit__()


def _request_prefix_text(request) -> str:
    try:
        body = request.json()
    except Exception:
        return ""
    if not isinstance(body, dict):
        return ""
    if "messages" in body:
        return "".join(
            f"{m.get('role', '')}:{m.get('content', '')}\n"
            for m in body["messages"][:4]
            if isinstance(m, dict)
        )
    text = body.get("prompt", "")
    return text if isinstance(text, str) else ""


def make_prefix_router(tokenizer=None, page_size: int = 128):
    """Build a proxy-side router policy keyed on the request's FIRST KV
    PAGE: requests sharing a page-aligned token prefix map to one affinity
    key, so they stick to the replica whose engine caches those pages
    (reference: PrefixCacheAffinityRouter, prefix_aware_router.py:39).

    Sharing the first full page is a necessary condition for ANY prefix-
    cache hit (the cache is page-granular), so the first page IS the right
    affinity key: finer keys split cache-compatible requests across
    replicas, coarser ones collapse unrelated prompts onto one.

    With a tokenizer the key is the digest of tokens[:page_size], exactly
    the engine's first chain digest. Without one, a char-space proxy is
    used (~4 chars/token). Prompts too short to fill a page can never hit
    the page cache, so they hash whole — spreading them is free."""
    tok = None
    if tokenizer is not None:
        tok = load_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer

    def policy(request) -> str:
        text = _request_prefix_text(request)
        if not text:
            return ""
        if tok is not None:
            # Bound BPE cost on the routing hot path: only the first page of
            # tokens matters, and ~6 chars/token over-covers any tokenizer.
            ids = tok.encode(text[: page_size * 6], add_bos=True)
            head = ids[:page_size]
        else:
            head = text[: page_size * 4]
        return hashlib.sha1(repr(head).encode()).hexdigest()[:16]

    return policy


def build_openai_app(model_config: dict, engine_config: Optional[dict] = None,
                     tokenizer: Optional[str] = None, model_name: str = "ray-tpu-llm",
                     num_replicas: int = 1, max_ongoing_requests: Optional[int] = None,
                     warmup_buckets: Optional[tuple] = None,
                     ray_actor_options: Optional[dict] = None,
                     prefix_routing: bool = False,
                     chat_template: Optional[str] = None, device=None):
    """OpenAI-compatible serving app; serve.run(...) it with a route_prefix
    and POST /v1/chat/completions to the proxy port. prefix_routing=True
    installs the prefix-affinity router policy in the proxy (pair with
    engine_config={"kv_layout": "paged", "prefix_cache": True} so the sticky
    replica actually reuses the pages). ray_actor_options={"num_gpus": f}
    gives each replica a share f of a card (tensor_parallel > 1: tp GPUs
    unless num_gpus says otherwise). device: passed on to each
    replica's OpenAIServer (None is the GPU, raising in the replica when
    none is visible)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.engine import EngineConfig

    ec = EngineConfig(**{k: v for k, v in (engine_config or {}).items()
                         if k in EngineConfig.__dataclass_fields__})
    aopts = dict(ray_actor_options or {})
    if ec.tensor_parallel > 1:
        aopts.setdefault("num_gpus", float(ec.tensor_parallel))  # gang-schedule the TP replica
    dep = serve.deployment(OpenAIServer).options(
        name="openai_llm",
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests or ec.max_slots,
        ray_actor_options=aopts,
        # Router keys match the engine's page-granular cache: same
        # tokenizer, same page size -> the affinity key IS the engine's
        # first chain digest boundary.
        request_router=(
            make_prefix_router(tokenizer, ec.page_size) if prefix_routing else None
        ),
    )
    return dep.bind(model_config, engine_config, tokenizer, model_name,
                    warmup_buckets, chat_template, device)
