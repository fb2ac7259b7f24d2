"""HTTP proxy actor: routes requests to deployment handles.

Role-equivalent to the reference's ProxyActor / HTTPProxy
(python/ray/serve/_private/proxy.py:710 — per-node ASGI
server resolving routes from the controller and streaming to replicas).
Redesigned: a stdlib asyncio HTTP/1.1 server inside an actor (no ASGI
dependency); blocking router/get calls are pushed to a thread pool so the
accept loop never stalls.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import socket
import threading
import time
import traceback
from typing import Any, Optional
from urllib.parse import parse_qs, urlsplit

from ray_tpu_torch.qos import context as _qos
from ray_tpu_torch.scale import router as _scale_router


def _capped_timeout(timeout_s, default: float = 60.0) -> float:
    """THE client-timeout policy for both binary-RPC dispatch lanes:
    client-controlled, but CAPPED (qos.parse_timeout_s — shared with the
    HTTP header and OpenAI-body mappings) — the dispatch pool is shared
    with routing/health, so an unbounded wait would let one caller pin its
    threads indefinitely. 0/None means "no opinion" -> default."""
    t = _qos.parse_timeout_s(timeout_s)
    return t if t > 0 else min(default, _qos.MAX_CLIENT_TIMEOUT_S)


class HTTPResponse:
    """Return one of these from a deployment's __call__ to control the HTTP
    status/content type (the default mapping JSON-encodes any other return
    value as 200). body: bytes or str."""

    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 422: "Unprocessable Entity",
                429: "Too Many Requests", 500: "Internal Server Error"}

    def __init__(self, status: int, body, content_type: str = "application/json"):
        self.status = int(status)
        self.body = body.encode() if isinstance(body, str) else bytes(body)
        self.content_type = content_type

    @property
    def status_line(self) -> str:
        return f"{self.status} {self._REASONS.get(self.status, 'Status')}"

    def __reduce__(self):
        return (HTTPResponse, (self.status, self.body, self.content_type))


class Request:
    """What an HTTP deployment's __call__ receives."""

    def __init__(self, method: str, path: str, query: dict, headers: dict, body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query, self.headers, self.body))


_STREAM_END = object()


def _encode_chunk(chunk) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return json.dumps(chunk).encode() + b"\n"


class _StreamBody:
    """Streaming response source: the handle's DeploymentResponseGenerator
    plus the already-consumed first item. Consumed by _stream_on_loop via
    the generator's arm_async()/poll() surface — drained on the proxy's own
    event loop, no dedicated pump thread, no per-chunk sync-queue handoff."""

    def __init__(self, gen, first, app: str = "", deployment: str = ""):
        self.gen = gen  # DeploymentResponseGenerator of proxy-tagged items
        self.first = first
        self.app = app
        self.deployment = deployment


def _qos_wire_from_headers(headers: dict) -> Optional[tuple]:
    """Map the QoS ingress headers (``x-priority`` / ``x-tenant`` /
    ``x-request-timeout-s``) to a wire context tuple, or None when absent
    (the quiet path installs nothing). The client's timeout becomes an
    ABSOLUTE deadline here, once, on the shared clock — every later hop
    compares against it instead of re-deriving."""
    prio = headers.get("x-priority", "").strip().lower()
    tenant = headers.get("x-tenant", "").strip()
    tmo = headers.get("x-request-timeout-s", "").strip()
    if not (prio or tenant or tmo):
        return None
    rank = _qos.PRIORITIES.index(prio) if prio in _qos.PRIORITIES else 0
    deadline = None
    t = _qos.parse_timeout_s(tmo)
    if t > 0:
        from ray_tpu_torch.util import tracing as _tracing

        deadline = _tracing.now() + t
    return (rank, tenant or _qos.DEFAULT_TENANT, deadline, "")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ProxyActor:
    """One per serving node (tests run one). Owns port + route cache.

    Two ingress protocols (reference: HTTPProxy proxy.py:710 + gRPCProxy
    proxy.py:534): HTTP/1.1 on `port`, and a length-prefixed binary RPC
    protocol on `rpc_port` speaking TWO payload formats, distinguished by
    a leading magic:
    - "PB1\\0" + protobuf ServeRequest (serve/protocol/serve_rpc.proto):
      the POLYGLOT surface — any language codegens the schema and speaks
      JSON-in-protobuf over a socket; this is the role the reference's
      gRPC proxy plays. Reply: "PB1\\0" + ServeReply.
    - otherwise pickled (app, deployment, method, args, kwargs) for
      trusted in-datacenter Python callers; reply = pickled
      ("ok", result) | ("err", message).
    Both ride the same per-frame keyed-BLAKE2b session tag (see
    serve_rpc.proto — native keyed BLAKE2b, NOT HMAC)."""

    ROUTE_TTL_S = 1.0

    def __init__(self, port: int = 0, rpc_port: int = 0):
        self.port = port or _free_port()
        self.rpc_port = rpc_port or _free_port()
        self._routes: dict[str, tuple[str, str]] = {}
        self._routes_at = 0.0
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=32, thread_name_prefix="proxy")
        # Streaming data-plane metrics (reporter -> controller -> /metrics):
        # how many items each chunked-transfer write coalesced, and the item
        # rate of the last completed stream per deployment.
        from ray_tpu_torch.util import metrics as _metrics

        self._stream_batch = _metrics.Histogram(
            "serve.stream.batch_size",
            "items coalesced per chunked-transfer write",
            boundaries=[1, 2, 4, 8, 16, 32, 64],
            tag_keys=("app", "deployment"),
        )
        self._stream_rate = _metrics.Gauge(
            "serve.stream.items_per_s",
            "streamed items per second over the last completed stream",
            tag_keys=("app", "deployment"),
        )
        # -- QoS plane: adaptive admission (AIMD on observed queue delay,
        # class-tiered shedding) + its observability. None = plane off
        # (Config.qos_enabled=False), the overload bench's OFF arm.
        self._shed_total = _metrics.Counter(
            "serve.request.shed_total",
            "requests rejected by the proxy's adaptive admission (429 + Retry-After)",
            tag_keys=("reason", "class"),
        )
        self._limit_gauge = _metrics.Gauge(
            "qos.admission.limit", "the proxy's adaptive concurrency limit")
        self._inflight_gauge = _metrics.Gauge(
            "qos.admission.inflight", "requests currently admitted by the proxy")
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.qos import AdmissionController

        # The CLUSTER config: a spawned worker adopts the head's config onto
        # its CoreWorker at registration (adopt_cluster) — the process-global
        # get_config() would silently read this process's env defaults.
        core = getattr(_api, "_global_worker", None)
        cfg = getattr(core, "config", None) or get_config()
        self._qos_ctl: Optional[AdmissionController] = None
        if cfg.qos_enabled:
            def _on_adapt(limit, inflight):
                self._limit_gauge.set(limit)
                self._inflight_gauge.set(inflight)

            self._qos_ctl = AdmissionController(
                target_delay_s=cfg.qos_target_delay_s,
                min_limit=cfg.qos_min_concurrency,
                max_limit=cfg.qos_max_concurrency,
                initial_limit=cfg.qos_initial_concurrency,
                interval_s=cfg.qos_adapt_interval_s,
                on_adapt=_on_adapt,
            )
            self._limit_gauge.set(self._qos_ctl.limit)
        # -- scale plane: per-deployment shed/expired tallies + the QoS
        # telemetry pusher (proxy -> ServeController -> scale/signals.py).
        # The AIMD controller's own signals can only SHED here; shipped to
        # the controller they let the autoscaler REQUEST capacity.
        self._dep_qos_lock = threading.Lock()
        self._dep_qos: dict[str, dict] = {}  # "app/dep" -> cumulative tallies
        self._qos_pusher: Optional[threading.Thread] = None
        if self._qos_ctl is not None:
            self._qos_pusher = threading.Thread(
                target=self._qos_push_loop, name="proxy-qos-push", daemon=True)
            self._qos_pusher.start()
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="serve-proxy", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("proxy HTTP server failed to start")

    def get_port(self) -> int:
        return self.port

    def get_rpc_port(self) -> int:
        return self.rpc_port

    def check_health(self) -> bool:
        return self._thread.is_alive()

    # -- server ------------------------------------------------------------
    def _serve(self):
        asyncio.set_event_loop(self._loop)

        async def start():
            server = await asyncio.start_server(self._handle_conn, "127.0.0.1", self.port)
            rpc_server = await asyncio.start_server(
                self._handle_rpc_conn, "127.0.0.1", self.rpc_port
            )
            self._ready.set()
            async with server, rpc_server:
                await asyncio.gather(server.serve_forever(), rpc_server.serve_forever())

        try:
            self._loop.run_until_complete(start())
        except Exception:
            traceback.print_exc()

    # -- binary RPC ingress -------------------------------------------------
    async def _handle_rpc_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        import pickle

        from ray_tpu_torch.core import rpc as _rpc

        authed = bool(_rpc.get_auth_token())
        try:
            while True:
                hdr = await reader.readexactly(4)
                n = int.from_bytes(hdr, "little")
                if n > 64 * 1024 * 1024:
                    return
                frame = await reader.readexactly(n)
                if authed:
                    # Frames carry the session HMAC tag (rpc.frame_tag):
                    # unauthenticated bytes NEVER reach pickle.loads — the
                    # same contract as core RPC (rpc.py per-frame auth).
                    tag, frame = frame[:_rpc.FRAME_TAG_LEN], frame[_rpc.FRAME_TAG_LEN:]
                    if not _rpc.frame_verify(tag, frame):
                        return  # drop the unauthenticated peer

                def run(frame=frame):
                    from ray_tpu_torch.serve.handle import DeploymentHandle
                    from ray_tpu_torch.serve.protocol import PROTO_MAGIC

                    if frame.startswith(PROTO_MAGIC):
                        # Polyglot protobuf surface: JSON args in, JSON
                        # result out — pickle never touches these frames.
                        # (pb2 imported lazily inside the branch: the pickle
                        # path must keep working without google.protobuf.)
                        from ray_tpu_torch.serve.protocol import pb2

                        pb = pb2()
                        reply = pb.ServeReply()
                        try:
                            req = pb.ServeRequest()
                            req.ParseFromString(frame[len(PROTO_MAGIC):])
                            payload = json.loads(req.json_payload or b"{}")
                            handle = DeploymentHandle(
                                req.deployment, req.app, req.method or "__call__"
                            )
                            if req.affinity_key:
                                handle = handle.options(affinity_key=req.affinity_key)
                            timeout = _capped_timeout(req.timeout_s)
                            result = handle.remote(
                                *payload.get("args", []), **payload.get("kwargs", {})
                            ).result(timeout=timeout)
                            reply.status = pb.ServeReply.OK
                            reply.json_result = json.dumps(result).encode()
                        except Exception as e:  # noqa: BLE001 — serialized to the client
                            reply.status = pb.ServeReply.ERROR
                            reply.error = f"{type(e).__name__}: {e}"
                        return PROTO_MAGIC + reply.SerializeToString()
                    try:
                        # 5-tuple (legacy) or 6-tuple with a trailing
                        # client timeout — both lanes share the ONE
                        # capped-timeout policy (_capped_timeout); the
                        # legacy shape used to hardcode result(timeout=60)
                        # while the protobuf lane honored req.timeout_s.
                        fields = pickle.loads(frame)
                        app, deployment, method, args, kwargs = fields[:5]
                        timeout = _capped_timeout(fields[5] if len(fields) > 5 else 0.0)
                        handle = DeploymentHandle(deployment, app, method or "__call__")
                        result = handle.remote(*args, **kwargs).result(timeout=timeout)
                        return pickle.dumps(("ok", result), protocol=5)
                    except Exception as e:  # noqa: BLE001 — serialized to the client
                        return pickle.dumps(("err", f"{type(e).__name__}: {e}"), protocol=5)

                reply = await self._loop.run_in_executor(self._pool, run)
                reply = _rpc.frame_tag(reply) + reply if authed else reply
                writer.write(len(reply).to_bytes(4, "little") + reply)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, target, _ = line.decode().split(" ", 2)
                except ValueError:
                    break
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                n = int(headers.get("content-length", 0) or 0)
                if n:
                    body = await reader.readexactly(n)
                resp = await self._loop.run_in_executor(
                    self._pool, self._dispatch, method, target, headers, body
                )
                if len(resp) == 4 and resp[3] is True:
                    # streaming: (status, chunk_iter, ctype, True)
                    await self._write_streaming(writer, resp)
                else:
                    # buffered: (status, payload, ctype[, extra_headers])
                    status, payload, ctype = resp[:3]
                    extra = resp[3] if len(resp) == 4 else None
                    extra_lines = "".join(
                        f"{k}: {v}\r\n" for k, v in (extra or {}).items()
                    )
                    head = (
                        f"HTTP/1.1 {status}\r\ncontent-type: {ctype}\r\n"
                        f"content-length: {len(payload)}\r\n{extra_lines}"
                        f"connection: keep-alive\r\n\r\n"
                    )
                    writer.write(head.encode() + payload)
                    await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _write_streaming(self, writer: asyncio.StreamWriter, resp):
        """Write an HTTP/1.1 chunked-transfer response. Handle streams
        (_StreamBody) drain on THIS loop: the stream's arrival wakeups set
        an asyncio.Event, every wake drains ALL available items, and the
        drained run ships as ONE chunked-transfer write — no pump thread,
        no per-chunk sync-queue handoff, adjacent chunks coalesced per tick.
        Plain iterators keep the legacy pump-thread path (a blocking
        iterator must never stall the accept loop)."""
        status, chunks, ctype, _ = resp
        head = (
            f"HTTP/1.1 {status}\r\ncontent-type: {ctype}\r\n"
            f"transfer-encoding: chunked\r\nconnection: keep-alive\r\n\r\n"
        )
        writer.write(head.encode())
        await writer.drain()
        if isinstance(chunks, _StreamBody):
            await self._stream_on_loop(writer, chunks)
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return
        # One dedicated pump thread per stream (NOT the shared dispatch pool:
        # a slow token stream blocks its puller for the stream's lifetime, and
        # N concurrent streams on the shared pool would starve dispatch and
        # health checks). Bounded queue gives the producer backpressure.
        q: asyncio.Queue = asyncio.Queue(maxsize=8)
        stop = threading.Event()
        loop = self._loop

        def put_blocking(item) -> bool:
            """Blocking put that survives a departed writer: periodically
            re-checks `stop` instead of waiting on the queue forever."""
            while True:
                fut = asyncio.run_coroutine_threadsafe(q.put(item), loop)
                try:
                    fut.result(timeout=1.0)
                    return True
                except concurrent.futures.TimeoutError:
                    fut.cancel()
                    if stop.is_set():
                        return False
                except Exception:
                    return False

        def pump():
            try:
                for chunk in chunks:
                    if stop.is_set() or not put_blocking(chunk):
                        break
            except Exception:
                pass  # mid-stream failure: terminate the chunked body
            finally:
                close = getattr(chunks, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
                put_blocking(_STREAM_END)

        threading.Thread(target=pump, name="serve-stream-pump", daemon=True).start()
        try:
            while True:
                chunk = await q.get()
                if chunk is _STREAM_END:
                    break
                data = _encode_chunk(chunk)
                if not data:
                    continue
                writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                await writer.drain()
        finally:
            stop.set()
            while not q.empty():  # unblock a pump stuck on a full queue
                q.get_nowait()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _stream_on_loop(self, writer: asyncio.StreamWriter, body: "_StreamBody"):
        """Drain a handle stream on the proxy loop. Each drain cycle frames
        every available item and ships them in one write + one drain;
        between cycles the loop is free for other connections. Item values
        resolve via the owner's thread-safe local fast path (streamed chunks
        are inline objects already absorbed by the time their refs surface);
        only a miss (large shm item) pays an executor-thread get."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.core.worker import _MISS

        core = _api._require_worker()
        gen = body.gen
        ev = gen.arm_async(self._loop)
        tags = {"app": body.app, "deployment": body.deployment}
        t0 = time.perf_counter()
        total_items = 1  # the first item was consumed by the router
        pending: list[bytes] = []
        data = _encode_chunk(body.first)
        if data:
            pending.append(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        try:
            done = False
            while True:
                # Clear BEFORE polling: a push landing between the last poll
                # and the wait re-sets the event, so no arrival is lost.
                ev.clear()
                while True:
                    kind, payload = gen.poll()
                    if kind == "wait":
                        break
                    if kind in ("end", "error"):
                        # error: everything already delivered stays delivered;
                        # the chunked body terminates (same as the pump path).
                        done = True
                        break
                    value = core._try_local_value(payload)
                    if value is _MISS:
                        value = await self._loop.run_in_executor(
                            self._pool, functools.partial(rt.get, payload, timeout=60)
                        )
                    if isinstance(value, tuple) and len(value) == 2:
                        value = value[1]  # replica proxy-tags items ('chunk', x)
                    data = _encode_chunk(value)
                    if data:
                        pending.append(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    total_items += 1
                if pending:
                    self._stream_batch.observe(len(pending), tags=tags)
                    writer.write(b"".join(pending))
                    pending.clear()
                    await writer.drain()
                if done:
                    return
                await ev.wait()
        except Exception:
            pass  # client gone / item resolution failed: terminate the body
        finally:
            gen.disarm_async()
            gen.close()  # idempotent: cancels the producer, frees admission
            elapsed = max(time.perf_counter() - t0, 1e-9)
            self._stream_rate.set(round(total_items / elapsed, 1), tags=tags)

    def _dispatch(self, method: str, target: str, headers: dict, body: bytes):
        """Entry for every HTTP request (thread pool). Tracing: a ROOT span
        per request when enabled process-wide (tracing.set_trace_enabled /
        RAYTPU_TRACE=1) or per-request via an ``x-trace`` header; the span's
        context then rides the handle->replica actor call and every nested
        task, stitching the whole fan-out into one trace. Untraced requests
        pay one contextvar-free boolean check."""
        from ray_tpu_torch.util import tracing

        if not (tracing.trace_enabled()
                or headers.get("x-trace", "") in ("1", "true", "on")):
            return self._dispatch_inner(method, target, headers, body)
        with tracing.span("serve.request", method=method,
                          path=urlsplit(target).path or "/"):
            return self._dispatch_inner(method, target, headers, body)

    def _note_dep_qos(self, app: str, deployment: str, field: str):
        """Cumulative per-deployment tallies the telemetry pusher ships to
        the serve controller (the estimator differentiates them into
        shed/expiry rates per deployment)."""
        key = f"{app}/{deployment}"
        with self._dep_qos_lock:
            rec = self._dep_qos.setdefault(
                key, {"sheds_total": 0.0, "expired_total": 0.0, "requests_total": 0.0})
            rec[field] += 1.0

    def _qos_push_loop(self):
        """Ship the AIMD controller's telemetry + per-deployment tallies to
        the ServeController every half second (fire-and-forget, like the
        handle's demand pusher). The push is the upscale half of the QoS
        loop: these same signals already shed load locally."""
        from ray_tpu_torch.serve.handle import _controller

        reporter = f"proxy-{id(self)}"
        last_empty = False
        while True:
            time.sleep(0.5)
            ctl = self._qos_ctl
            if ctl is None:
                return
            report = ctl.telemetry()
            with self._dep_qos_lock:
                report["deployments"] = {k: dict(v) for k, v in self._dep_qos.items()}
            if not report["deployments"]:
                if last_empty:
                    continue  # nothing routed yet / idle: don't spam the controller
                last_empty = True
            else:
                last_empty = False
            try:
                _controller().record_qos_telemetry.remote(reporter, report, time.time())
            except Exception:
                pass  # controller restarting: next tick retries

    def _shed_response(self, klass: str, retry_after: float,
                       app: str = "", deployment: str = ""):
        """Reject one request under overload: 429 + Retry-After, counted
        (serve.request.shed_total{reason,class}) and dropped onto the active
        trace — never a silent rejection (graftlint: counted-sheds)."""
        self._shed_total.inc(tags={"reason": "overload", "class": klass})
        if deployment:
            self._note_dep_qos(app, deployment, "sheds_total")
        from ray_tpu_torch.obs import flight as _flight
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.event("qos.shed", reason="overload", cls=klass)
        # Black box: sheds are exactly what a post-mortem of an overload
        # window needs, and untraced requests leave no span to carry them.
        _flight.record("qos.shed", reason="overload", cls=klass,
                       app=app, deployment=deployment)
        body = json.dumps({
            "error": "overloaded", "class": klass, "retry_after_s": retry_after,
        }).encode()
        return ("429 Too Many Requests", body, "application/json",
                {"retry-after": f"{retry_after:g}"})

    # -- routing (runs on thread pool) -------------------------------------
    def _route_table(self) -> dict:
        now = time.time()
        if now - self._routes_at > self.ROUTE_TTL_S:
            try:
                import ray_tpu_torch as rt
                from ray_tpu_torch.serve.handle import _controller

                table = rt.get(_controller().get_route_table.remote(), timeout=10)
                self._routes = {p: (t["app"], t["deployment"]) for p, t in table.items()}
                self._routes_at = time.time()
            except Exception:
                self._routes_at = now  # back off; serve stale table
        return self._routes

    def _dispatch_inner(self, method: str, target: str, headers: dict, body: bytes):
        parts = urlsplit(target)
        path = parts.path or "/"
        if path == "/-/healthz":
            return "200 OK", b"ok", "text/plain"
        if path == "/-/routes":
            return "200 OK", json.dumps({p: f"{a}/{d}" for p, (a, d) in self._route_table().items()}).encode(), "application/json"
        routes = self._route_table()
        match = None
        for prefix in sorted(routes, key=len, reverse=True):
            norm = prefix.rstrip("/") or ""
            if path == prefix or path.startswith(norm + "/") or path == norm:
                match = (prefix, *routes[prefix])
                break
        if match is None:
            return "404 Not Found", b'{"error": "no route"}', "application/json"
        prefix, app, deployment = match
        sub_path = path[len(prefix.rstrip("/")) :] or "/"
        query = {k: v[0] if len(v) == 1 else v for k, v in parse_qs(parts.query).items()}
        req = Request(method, sub_path, query, headers, body)
        # -- QoS ingress: headers -> RequestContext for this dispatch (the
        # context then rides the handle -> replica call like the trace ctx),
        # adaptive admission (shed with 429 before any routing work), and
        # the "proxy" deadline hop. With the plane off (qos_enabled=False)
        # headers are NOT mapped either — the OFF baseline is the pre-plane
        # proxy: no classes, no deadlines, no shedding.
        qwire = _qos_wire_from_headers(headers) if self._qos_ctl is not None else None
        qtoken = _qos.activate(qwire)
        rank = qwire[0] if qwire is not None else 0
        klass = _qos.PRIORITIES[rank]
        admitted = False
        try:
            if self._qos_ctl is not None:
                ok, retry_after = self._qos_ctl.try_admit(rank)
                if not ok:
                    return self._shed_response(klass, retry_after, app, deployment)
                admitted = True
            try:
                from ray_tpu_torch.core.worker import ActorDiedError
                from ray_tpu_torch.serve.handle import DeploymentResponseGenerator, _replica_set

                _qos.check_deadline("proxy", detail=path)
                rs = _replica_set(app, deployment)
                # Replica affinity: a deployment-provided router policy maps the
                # request to a sticky key (reference: PrefixCacheAffinityRouter —
                # requests sharing a prompt prefix land on the replica whose
                # engine caches those KV pages); clients can also pass an
                # x-affinity-key header directly.
                akey = headers.get("x-affinity-key", "")
                router_fn = getattr(rs, "request_router", None)
                if router_fn is None:
                    rs._maybe_refresh()  # router policy arrives with routing info
                    router_fn = getattr(rs, "request_router", None)
                if router_fn is not None:
                    try:
                        akey = str(router_fn(req) or akey)
                    except Exception:
                        traceback.print_exc()
                # KV-cache-aware routing: a digest of the prompt head
                # (tenant-scoped) pins same-prefix requests to the replica
                # whose engine prefix-cache holds those KV pages. Clients
                # may also pass x-prefix-key directly.
                pkey = headers.get("x-prefix-key", "")
                if not pkey:
                    pkey = _scale_router.prefix_key_for_body(
                        body, qwire[1] if qwire is not None else "")
                self._note_dep_qos(app, deployment, "requests_total")
                # Retry replica death only before the first item: nothing has
                # reached the client yet, so re-routing is safe (mid-stream death
                # is surfaced — items were already delivered).
                for attempt in range(3):
                    t_admit = time.perf_counter()
                    gen = DeploymentResponseGenerator(rs, "__call__", (req,), {},
                                                      proxy=True, affinity_key=akey,
                                                      prefix_key=pkey)
                    if self._qos_ctl is not None:
                        # The AIMD signal: time spent waiting for a replica
                        # slot in the handle's fair queue (pure queueing —
                        # service time is NOT part of it), per class: with
                        # strict priority, interactive's near-zero delays
                        # must not mask a background standing queue.
                        self._qos_ctl.record_delay(
                            time.perf_counter() - t_admit, rank)
                    try:
                        tag, first = next(gen)
                        break
                    except StopIteration:
                        return "200 OK", b"", "text/plain"
                    except ActorDiedError:
                        rs.fail_over("")
                        if attempt == 2:
                            raise
            except _qos.DeadlineExceeded as e:
                # Counted at the hop that dropped it (expired_total{hop});
                # the client sees a typed timeout status, not a 500. The
                # per-deployment tally feeds the scale plane's expiry rate.
                self._note_dep_qos(app, deployment, "expired_total")
                return ("504 Gateway Timeout",
                        json.dumps({"error": str(e)}).encode(), "application/json")
            except Exception as e:
                traceback.print_exc()
                return "500 Internal Server Error", json.dumps({"error": str(e)}).encode(), "application/json"
        finally:
            # Admission covers the queue+dispatch phase (for streaming
            # responses the body drains on the proxy loop afterwards); the
            # queue-delay signal is what the AIMD limit controls.
            if admitted:
                self._qos_ctl.release(rank)
            _qos.deactivate(qtoken)
        if tag == "value":
            gen.close(abandon=False)  # response complete: nothing to cancel
            result = first
            if isinstance(result, HTTPResponse):
                return result.status_line, result.body, result.content_type
            if isinstance(result, bytes):
                return "200 OK", result, "application/octet-stream"
            if isinstance(result, str):
                return "200 OK", result.encode(), "text/plain"
            return "200 OK", json.dumps(result).encode(), "application/json"
        # Generator result: stream it (chunked). Content type from the first
        # chunk's shape: SSE lines -> text/event-stream, str -> text/plain,
        # bytes -> octet-stream, anything else -> newline-delimited JSON.
        if isinstance(first, str):
            ctype = "text/event-stream" if first.startswith("data:") else "text/plain"
        elif isinstance(first, bytes):
            ctype = "application/octet-stream"
        else:
            ctype = "application/x-ndjson"
        return "200 OK", _StreamBody(gen, first, app, deployment), ctype, True
