"""Minimal symmetric asyncio RPC: length-prefixed pickled frames over TCP/UDS.

Role-equivalent to the reference's gRPC scaffolding (src/ray/rpc):
every process exposes a handler object; both ends of a connection can invoke
methods on the other (the reference achieves the same with per-direction gRPC
services, e.g. CoreWorkerService.PushTask flowing caller->callee and
PubsubLongPolling flowing callee->caller). Frames are pickled tuples —
small control messages only; bulk data rides the shared-memory object store.

Wire format: 8-byte little-endian length, then 1 discriminator byte —
WIRE_VERSION for the pickled envelope lane, _RAW_MARKER for the raw chunk
lane (a frame from a build speaking a different generation is REFUSED with
a clear log line before any byte of it reaches pickle, so two mixed-version
hosts fail loud instead of corrupting each other mid-rolling-upgrade).
Envelope lane: [16-byte session tag when a token is set] + pickle of EITHER
one (kind, msg_id, method_or_status, payload) message tuple OR a list of
such tuples (a coalesced envelope). kind: 0=request, 1=reply, 2=notify (no
reply expected). Raw lane (bulk object chunks, never pickled): see the
"raw chunk lane" section on Connection.

Adaptive frame coalescing (the async actor-call hot path): every send
lands in a per-connection buffer that is flushed once per event-loop tick
(a ``call_soon`` callback — never a timer), so N messages enqueued within
one tick ship as ONE envelope paying one length header, one version byte,
one keyed-BLAKE2b tag, one ``pickle.dumps`` (whose memo also interns
constants — method-name strings, shared options objects — once per batch
instead of once per call), one socket write, and one reader wakeup. A lone
message flushes at the tail of the same tick: sync-call latency gains one
sub-tick callback hop, never a timer delay. The batch is adaptive purely by
queue depth — only what is ALREADY pending coalesces (reference inspiration:
the paper's L0/L3 submission queues over a batched RPC plane, and T3-style
overlap of transport with compute).

Authentication (ON BY DEFAULT): pickle-over-TCP executes arbitrary code on
unpickle, so a session token is installed for every cluster (auto-minted at
head start unless RAYTPU_AUTO_TOKEN=0; pin one with ``Config.auth_token`` /
``RAYTPU_AUTH_TOKEN`` for multi-host; it propagates to daemons/workers/jobs
via config+env). With a token installed, EVERY frame carries a
16-byte keyed-BLAKE2b MAC of its payload, verified constant-time
BEFORE the payload is unpickled. Frames from peers without the token (or
tampered frames) are dropped and the connection closed — their bytes never
reach pickle (reference: token auth, src/ray/rpc/authentication). Stateless
per frame: no handshake ordering to get wrong. Limitation: no replay
nonce — an on-path attacker can replay a previously-sent frame verbatim,
but cannot forge new payloads.
"""
from __future__ import annotations

import asyncio
import collections
import hashlib
import hmac
import itertools
import logging
import os
import pickle
import socket
import time
import traceback
from typing import Any

from ray_tpu_torch.util.bgtasks import spawn_bg as _spawn_bg
from ray_tpu_torch import chaos as _chaos

logger = logging.getLogger(__name__)

_REQ, _REP, _NOTIFY = 0, 1, 2
_HDR = 8
_TAG_LEN = 16
# Wire-format generation. Bump when the frame schema changes (pickle tuple
# shape, tag algorithm/length, header layout). Reference: protobuf gives the
# reference schema evolution for free; pickle frames get a refuse-on-mismatch
# version byte instead. Chosen != 0x80 (pickle PROTO opcode) so pre-version
# builds are also rejected, not misparsed.
# v2: payload may be a LIST of message tuples (coalesced envelope) instead
# of a single tuple; a v1 build would misdispatch a list, so fail loud.
# v3: adds the raw-frame lane (first byte _RAW_MARKER instead of the version
# byte): a frame carrying a small pickled header plus an out-of-band binary
# payload that is never pickled — bulk object-chunk transfer at link speed
# (see send_raw/expect_raw). A v2 build would feed the marker byte to its
# version check and refuse, so mixed-version hosts still fail loud.
WIRE_VERSION = 3
_VER = bytes([WIRE_VERSION])
# Raw-lane discriminator: a v3 frame starts with either WIRE_VERSION (pickled
# envelope lane) or this marker (raw chunk lane). Outside the plausible
# version-byte range and != 0x80 (pickle PROTO) so foreign builds reject it.
_RAW_MARKER = 0x40 | WIRE_VERSION
_RAW = bytes([_RAW_MARKER])
# Raw-lane header sanity cap: the header is a tiny pickled (key, length)
# tuple; anything bigger is a protocol violation.
_MAX_RAW_HDR = 1 << 16
# Domain separation for the raw header MAC (a replayed envelope tag must not
# verify as a raw header tag).
_RAW_HDR_DOMAIN = b"raytpu-raw-hdr:"
# Domain separation for the per-window payload MAC (window mode, see
# raw_window_hasher): a window tag must never verify as a per-chunk ptag or
# an envelope tag.
_RAW_WIN_DOMAIN = b"raytpu-raw-win:"
# Raw-frame header flag bits (third element of the header tuple; a 2-tuple
# header means flags == 0 — v3 per-chunk frames stay parseable verbatim).
# NOPTAG: no trailing per-chunk ptag; the payload is covered by an
# out-of-band window MAC instead (returned in the serve RPC's authenticated
# envelope reply and checked by the puller over the whole window).
_RAW_F_NOPTAG = 1

# -- raw-lane tuning (installed cluster-wide via apply_transport_config) ----
# Vectored sends: ship a whole raw frame (prefix + payload slices + tag) as
# ONE sendmsg syscall straight on the socket when the transport buffer is
# empty, instead of three transport writes (each of which memcpys any unsent
# remainder into the transport's buffer on this interpreter). Off = the
# pre-wire-speed sequential-write shape, kept as a bench A/B arm.
_VECTORED_SEND = True
# "window" | "chunk": whether pullers ask for whole MAC-per-window runs
# (read_object_window_raw) or per-chunk ptag frames. Transport-level default;
# the PullManager consults this via raw_lane_config().
_MAC_GRANULARITY = "window"
# Degraded-network shaping (token bucket + fixed delay) applied to every
# raw-lane frame send. 0/0 = wire speed. This is the in-process stand-in for
# a netem-shaped loopback when tc/CAP_NET_ADMIN is unavailable.
_NET_RATE_BPS = 0.0
_NET_DELAY_S = 0.0
_NET_BURST = 1 << 20  # bucket depth: one part-sized burst
_net_tokens = 0.0
_net_stamp = 0.0
# Socket buffer target for peer links: the kernel default (~208 KiB rmem)
# wakes the receiving loop ~64 times per 8 MiB object; 4 MiB buffers let a
# whole chunk land per wakeup, which on a 1-core host is most of the win.
_SOCK_BUF = 4 << 20


def configure_raw_lane(*, vectored: bool | None = None, mac_granularity: str | None = None):
    """Install raw-lane behavior knobs for this process (idempotent; called
    at every config-adoption site so head, daemons and workers agree)."""
    global _VECTORED_SEND, _MAC_GRANULARITY
    if vectored is not None:
        _VECTORED_SEND = bool(vectored)
    if mac_granularity is not None:
        if mac_granularity not in ("window", "chunk"):
            raise ValueError(f"raw_mac_granularity must be 'window' or 'chunk', got {mac_granularity!r}")
        _MAC_GRANULARITY = mac_granularity


def raw_lane_config() -> dict:
    return {
        "vectored": _VECTORED_SEND,
        "mac_granularity": _MAC_GRANULARITY,
        "net_rate_bps": _NET_RATE_BPS,
        "net_delay_s": _NET_DELAY_S,
    }


def set_net_shape(spec: str | None):
    """Install (or clear, with empty spec) degraded-network shaping for the
    raw lane from a JSON ``{"rate_mb_s": X, "delay_ms": Y}`` spec. Applied
    at send time by _net_pace; both sides of a link shape independently so
    a loopback A/B pays the configured rate once per direction."""
    global _NET_RATE_BPS, _NET_DELAY_S, _net_tokens, _net_stamp
    if not spec:
        _NET_RATE_BPS = 0.0
        _NET_DELAY_S = 0.0
        return
    import json

    shape = json.loads(spec)
    _NET_RATE_BPS = float(shape.get("rate_mb_s", 0.0)) * 1e6
    _NET_DELAY_S = float(shape.get("delay_ms", 0.0)) / 1e3
    _net_tokens = float(_NET_BURST)
    _net_stamp = time.monotonic()


async def _net_pace(nbytes: int):
    """Token-bucket pacing + fixed one-way delay for a raw frame of
    ``nbytes``. No-op (no await) when shaping is off."""
    global _net_tokens, _net_stamp
    if _NET_DELAY_S > 0.0:
        await asyncio.sleep(_NET_DELAY_S)
    if _NET_RATE_BPS <= 0.0:
        return
    now = time.monotonic()
    _net_tokens = min(float(_NET_BURST), _net_tokens + (now - _net_stamp) * _NET_RATE_BPS)
    _net_stamp = now
    _net_tokens -= nbytes
    if _net_tokens < 0.0:
        await asyncio.sleep(-_net_tokens / _NET_RATE_BPS)


def apply_transport_config(cfg) -> None:
    """One-call install of the transport knobs a Config carries
    (raw_vectored_send, raw_mac_granularity, net_shape_spec) — the single
    home for config->transport wiring so every adoption site (head init,
    node/worker adopt_cluster, controller start) stays in lockstep."""
    configure_raw_lane(
        vectored=getattr(cfg, "raw_vectored_send", True),
        mac_granularity=getattr(cfg, "raw_mac_granularity", "window"),
    )
    set_net_shape(getattr(cfg, "net_shape_spec", "") or "")


def _tune_peer_socket(sock) -> None:
    """Large SO_SNDBUF/SO_RCVBUF on peer links (both dial and accept side):
    bulk raw-lane frames are 4 MiB, and a receive buffer that holds a whole
    chunk turns ~64 read-loop wakeups per 8 MiB object into a handful."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)
    except OSError:
        pass  # platform cap (wmem_max) applies silently; best effort


def _raw_payload_hasher():
    """Streaming MAC for raw-lane payloads: HMAC-SHA256 (truncated to
    _TAG_LEN), NOT the envelope lane's keyed-BLAKE2b. Lane-appropriate MACs:
    blake2b wins on the tiny frames of the control plane (lower per-call
    setup), but for megabyte chunk payloads per-byte throughput is all that
    matters and OpenSSL's SHA-NI sha256 hashes ~2x faster than hashlib's
    blake2b on commodity hosts (measured 971 vs 476 MB/s on the 1-core bench
    box — the MAC is the bulk lane's dominant CPU cost). Same 32-byte
    session key, same truncated tag length, equivalent forgery resistance.

    Measured dead end, recorded so it isn't retried blind: offloading these
    passes to the default thread executor (the C hash releases the GIL)
    LOST ~17% on the paired pull A/B in-process — two task/future handoffs
    per chunk outweighed the second-core overlap. Revisit only with a
    multi-host bench in hand."""
    return hmac.new(_frame_key, None, hashlib.sha256)


def raw_window_hasher():
    """Streaming MAC for a whole pull window (window mode): HMAC-SHA256 over
    the domain prefix + the window's payload bytes in send order. Both sides
    hash every byte (tamper detection still covers the full payload — the
    saving vs per-chunk ptags is finalize/compare/control-RPC overhead and
    the 16-byte trailer per 4 MiB frame, not hashing), the server returns
    the tag in its authenticated envelope reply, and the puller compares
    after the last chunk of the window lands. Chunk headers stay
    individually keyed-BLAKE2b'd (htag), so lengths/keys/ordering are
    authenticated per frame; the concatenated-payload MAC then pins the
    bytes to that authenticated sequence."""
    h = hmac.new(_frame_key, None, hashlib.sha256)
    h.update(_RAW_WIN_DOMAIN)
    return h
# Sanity cap on a declared frame length: readexactly buffers the whole frame
# BEFORE the auth check can reject the peer, so an untrusted header must not
# be able to demand unbounded memory.
_MAX_FRAME = 1 << 30
# Coalesced envelopes larger than this split back into one frame per message
# (individually-fine messages must never combine into a frame the receiver's
# _MAX_FRAME cap rejects). Comfortably under _MAX_FRAME with margin for the
# biggest sane inline payloads.
_SPLIT_BYTES = 32 << 20

_frame_key: bytes = b""  # empty = auth disabled


def set_auth_token(token: str | bytes | None):
    """Install the session token for this process. Every frame sent gets a
    keyed-BLAKE2b(token, payload) tag prepended; every frame received must
    verify. All peers of a session must run the same build (the tag
    algorithm is part of the wire format; there is no version negotiation —
    a mismatched peer is dropped as unauthenticated)."""
    global _frame_key
    if not token:
        _frame_key = b""
    else:
        raw = token.encode() if isinstance(token, str) else bytes(token)
        _frame_key = hashlib.blake2b(raw, digest_size=32, person=b"raytpu-rpc").digest()


def get_auth_token() -> bytes:
    return _frame_key


def _tag(payload: bytes) -> bytes:
    # Keyed BLAKE2b (a PRF by construction — no HMAC wrapper needed): ~2x
    # faster than HMAC-SHA256 on the small frames the actor hot path sends,
    # and this tag is computed 4x per call (send+verify on both ends).
    return hashlib.blake2b(payload, key=_frame_key, digest_size=_TAG_LEN).digest()


def frame_tag(payload: bytes) -> bytes:
    """Public tag helper for auxiliary authenticated protocols (e.g. the
    serve proxy's binary ingress): keyed-BLAKE2b(session key, payload)
    prefix, or b"" when auth is disabled. Verify with frame_verify."""
    return _tag(payload) if _frame_key else b""


def frame_verify(tag: bytes, payload: bytes) -> bool:
    if not _frame_key:
        return True  # auth disabled for this session
    return len(tag) == _TAG_LEN and hmac.compare_digest(tag, _tag(payload))


def derive_frame_key(token: str | bytes) -> bytes:
    """The session token -> frame key derivation (single home: off-cluster
    clients, e.g. serve's ProtoServeClient, must produce byte-identical
    tags to this process's set_auth_token path)."""
    raw = token.encode() if isinstance(token, str) else bytes(token)
    return hashlib.blake2b(raw, digest_size=32, person=b"raytpu-rpc").digest()


def tag_with_key(key: bytes, payload: bytes) -> bytes:
    """frame_tag with an explicit key (off-cluster callers)."""
    return hashlib.blake2b(payload, key=key, digest_size=_TAG_LEN).digest()


FRAME_TAG_LEN = _TAG_LEN

# Process-wide envelope-size histograms ({messages-per-envelope: envelopes}),
# send and receive sides, across every Connection in this process. Cheap
# enough to keep always-on; bench_core.py reports them in row `detail`.
_SEND_BATCH_HIST: collections.Counter = collections.Counter()
_RECV_BATCH_HIST: collections.Counter = collections.Counter()
# Bytes-on-wire (payload + header), both directions. Plain ints: one += per
# frame on the hot path; promoted to first-class counters by metrics_series.
_SEND_BYTES = 0
_RECV_BYTES = 0
# Raw-lane bytes (subset of the totals above): how much of the wire traffic
# rode the pickle-free chunk lane.
_RAW_SEND_BYTES = 0
_RAW_RECV_BYTES = 0


def batch_stats(reset: bool = False) -> dict:
    """Envelope-size distribution observed by this process:
    {"send": {batch_size: count}, "recv": {batch_size: count}}."""
    out = {
        "send": {k: v for k, v in sorted(_SEND_BATCH_HIST.items())},
        "recv": {k: v for k, v in sorted(_RECV_BATCH_HIST.items())},
    }
    if reset:
        _SEND_BATCH_HIST.clear()
        _RECV_BATCH_HIST.clear()
    return out


# Envelope-size histogram bucket boundaries for the Prometheus view (the raw
# per-size Counter stays available to bench via batch_stats).
_ENVELOPE_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128]


def metrics_series() -> list[dict]:
    """This process's RPC transport counters as snapshot()-shaped metric
    records (see ray_tpu_torch.util.metrics): envelope batch-size histograms per
    side + bytes-on-wire counters. Shipped by the CoreWorker reporter so the
    coalescing behavior of the live cluster is visible on /metrics, not just
    in bench_core histograms."""
    import time as _time

    now = _time.time()
    out: list[dict] = []
    for side, hist in (("send", _SEND_BATCH_HIST), ("recv", _RECV_BATCH_HIST)):
        counts = [0] * (len(_ENVELOPE_BUCKETS) + 1)
        total = 0.0
        n = 0
        for size, cnt in hist.items():
            i = 0
            while i < len(_ENVELOPE_BUCKETS) and size > _ENVELOPE_BUCKETS[i]:
                i += 1
            counts[i] += cnt
            total += size * cnt
            n += cnt
        out.append({
            "name": "rpc.envelope.messages",
            "kind": "histogram",
            "description": "messages coalesced per rpc envelope",
            "tags": {"side": side},
            "value": 0.0,
            "ts": now,
            "buckets": list(_ENVELOPE_BUCKETS),
            "counts": counts,
            "sum": total,
            "n": n,
        })
    for side, nbytes in (("send", _SEND_BYTES), ("recv", _RECV_BYTES)):
        out.append({
            "name": "rpc.bytes",
            "kind": "counter",
            "description": "rpc bytes on the wire (frames incl. headers)",
            "tags": {"side": side},
            "value": float(nbytes),
            "ts": now,
        })
    for side, nbytes in (("send", _RAW_SEND_BYTES), ("recv", _RAW_RECV_BYTES)):
        out.append({
            "name": "rpc.raw.bytes",
            "kind": "counter",
            "description": "bytes moved on the pickle-free raw chunk lane",
            "tags": {"side": side},
            "value": float(nbytes),
            "ts": now,
        })
    return out


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RawWindowTamperError(RpcError):
    """Window-mode MAC mismatch: some byte of a pull window's payload was
    tampered in flight. Typed so callers (and chaos assertions) can tell
    integrity failure from transport failure; the whole window is refetched
    per-chunk after the offending peer is dropped."""


def parse_addr(addr: str):
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    host, _, port = addr.rpartition(":")
    return ("tcp", host, int(port))


class Connection:
    """One live peer connection. ``call`` awaits a reply; ``notify`` doesn't."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, handler: Any, peer_name: str = "?"):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.peer_name = peer_name
        self._loop = asyncio.get_running_loop()
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self._send_lock = asyncio.Lock()  # serializes drain() waiters only
        # Coalescing buffer: messages enqueued this loop tick; flushed as one
        # envelope by a call_soon callback (see module docstring).
        self._out: list[tuple] = []
        self._flush_scheduled = False
        # Raw-lane receive state: key -> [dest memoryview, future]. The read
        # loop recv's a matching raw frame's payload straight into dest (no
        # intermediate bytes) and resolves the future.
        self._raw_expect: dict[bytes, list] = {}
        self._raw_sock = None  # lazily dup'd fd for zero-copy sock_recv_into
        self._raw_send_sock = None  # lazily dup'd fd for vectored/sendfile sends
        # Set once the first backlogged send_raw zeroes the transport's
        # write-buffer limits (drain == buffer fully empty; see send_raw).
        self._raw_zero_limits = False
        # Serializes raw-lane senders (vectored sends await mid-frame, so
        # two concurrent send_raw calls could interleave frame parts).
        self._raw_send_lock = asyncio.Lock()
        # True while a vectored raw send owns the socket directly (bytes in
        # flight that the transport doesn't know about): envelope flushes
        # must not writer.write() underneath it or their bytes would land
        # mid-raw-frame. _flush_out defers; release reschedules it.
        self._tx_hold = False
        # Strong refs to in-flight dispatch tasks: asyncio tracks tasks
        # weakly, and a gc cycle landing mid-await kills an unreferenced
        # task with GeneratorExit. Handlers can run for minutes (a
        # pull_object dispatch carries a whole windowed transfer), so the
        # weak-ref footgun here means a silently half-pulled object and a
        # caller that waits out its full timeout.
        self._dispatch_tasks: set[asyncio.Task] = set()
        self._task = asyncio.create_task(self._read_loop())
        self.on_close = None  # optional callback
        self.meta: dict = {}  # server-side per-connection state (registration info)

    def _enqueue(self, msg: tuple):
        """Queue one message; the per-tick flush callback ships everything
        queued since the last flush as a single envelope. Enqueue order ==
        envelope order == wire order."""
        self._out.append(msg)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush_out)

    def _flush_out(self):
        """Encode + write everything pending as ONE wire frame: one pickle
        of the message list (single message: the bare tuple — no list
        wrapper cost for the lone-frame case), one MAC, one write."""
        self._flush_scheduled = False
        if self._closed or not self._out:
            self._out.clear()
            return
        if self._tx_hold:
            # A vectored raw send owns the socket; writing now would splice
            # envelope bytes into the middle of its frame. The hold's
            # release reschedules this flush.
            return
        msgs = self._out
        self._out = []
        payload = msgs[0] if len(msgs) == 1 else msgs
        try:
            data = pickle.dumps(payload, protocol=5)
        except Exception:
            # A failing payload anywhere in the batch (unpicklable value, or
            # MemoryError on the combined dump) must not sink its batchmates
            # — pre-coalescing, pickling was per-message at the call site
            # and failed only that message. Salvage per-message; no second
            # combined dump that could fail the same way.
            for frame in self._salvage_unpicklable(msgs):
                self._write_frame(frame)
                _SEND_BATCH_HIST[1] += 1
            return
        if len(data) > _SPLIT_BYTES and len(msgs) > 1:
            # A combined envelope could exceed the receiver's _MAX_FRAME cap
            # even when each message is individually fine: fall back to one
            # frame per message (the pre-coalescing wire shape).
            for m in msgs:
                self._write_frame(pickle.dumps(m, protocol=5))
                _SEND_BATCH_HIST[1] += 1
            return
        self._write_frame(data)
        _SEND_BATCH_HIST[len(msgs)] += 1

    def _write_frame(self, data: bytes):
        global _SEND_BYTES
        data = _VER + _tag(data) + data if _frame_key else _VER + data
        fault = _chaos.maybe_inject("rpc.frame.send", peer=self.peer_name)
        if fault is not None and fault.kind == "drop":
            return  # frame vanishes; callers see timeouts/conn teardown
        if fault is not None and fault.kind == "corrupt_mac":
            # Flip the byte after the version marker. With auth on that is a
            # tag byte: the peer's constant-time verify fails and drops this
            # connection (the fail-loud auth contract). With auth OFF it is
            # the first pickle byte: unpickling fails and the peer's read
            # loop tears down — a recorded injection must never be a no-op.
            data = data[:1] + bytes([data[1] ^ 0xFF]) + data[2:]
        _SEND_BYTES += len(data) + _HDR
        try:
            wire = len(data).to_bytes(_HDR, "little") + data
            if fault is not None and fault.kind == "truncate":
                # Write fewer bytes than the header declares: the peer stalls
                # mid-frame (a wedged writer) and, when this connection later
                # carries anything else, misparses it as frame tail — either
                # way the receiver fails loud and tears the peer down.
                self.writer.write(wire[: _HDR + 1 + max(1, len(data) // 2)])
                return
            self.writer.write(wire)
            if fault is not None and fault.kind == "duplicate":
                self.writer.write(wire)
        except Exception:
            pass  # transport gone: the read loop tears the connection down

    def _salvage_unpicklable(self, msgs: list) -> list:
        """Per-message encoded frames for a batch whose combined pickle
        failed. Messages that pickle alone survive verbatim; an unpicklable
        reply becomes an 'err' reply (what the pre-batching _dispatch
        produced); an unpicklable request fails its own local reply future;
        a notify is logged and dropped."""
        frames = []
        for m in msgs:
            try:
                frames.append(pickle.dumps(m, protocol=5))
                continue
            except Exception as e:
                err = RpcError(f"unpicklable rpc payload ({type(e).__name__}: {e})")
            kind, msg_id = m[0], m[1]
            logger.warning("dropping unpicklable %s frame to %s: %s",
                           ("request", "reply", "notify")[kind], self.peer_name, err)
            if kind == _REP:
                frames.append(pickle.dumps((_REP, msg_id, "err", err), protocol=5))
            elif kind == _REQ:
                fut = self._pending.get(msg_id)
                if fut is not None and not fut.done():
                    fut.set_exception(err)
        return frames

    async def _send(self, frame: tuple):
        self._enqueue(frame)
        # Yield exactly one loop turn: the flush callback (scheduled by this
        # tick's first enqueue, hence ahead of our resumption in the ready
        # queue) runs before we proceed, so the frame is on the transport
        # when drain() returns. Replies/notifies produced by OTHER tasks in
        # the same tick ride the same envelope — this is what batches reply
        # absorption without ever delaying a lone frame behind a timer.
        await asyncio.sleep(0)
        async with self._send_lock:
            await self.writer.drain()

    def call_start(self, method: str, payload: Any = None) -> "asyncio.Future":
        """Synchronously enqueue a request frame; return the reply future.

        Unlike ``call``, the message joins the outbound envelope before this
        returns, so invocation order == wire order — required by per-actor
        FIFO task submission (the reference orders actor tasks with sequence
        numbers in ActorTaskSubmitter; here wire order is the sequence).
        """
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        msg_id = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        fut.add_done_callback(lambda f: self._pending.pop(msg_id, None))
        self._enqueue((_REQ, msg_id, method, payload))
        return fut

    def notify_soon(self, method: str, payload: Any = None):
        """Fire-and-forget notify with NO coroutine and NO backpressure:
        enqueue onto the coalescing buffer and return. For fan-out bursts
        (pubsub publish) where a per-event task is pure overhead; callers
        that need transport backpressure use ``notify``."""
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        self._enqueue((_NOTIFY, 0, method, payload))

    # -- raw chunk lane -------------------------------------------------
    # Bulk object-chunk transfer (reference: ObjectManager Push/Pull chunked
    # streams over their own gRPC channel). A raw frame is
    #   len8 | _RAW_MARKER | [htag16] | hlen4 | hdr-pickle | payload | [ptag16]
    # where hdr is a tiny pickled (key, payload_len) tuple and the payload is
    # NEVER pickled: the sender writes the caller's memoryview slices
    # directly to the transport (writev-style, no bytes() copy) and the
    # receiver recv's into a pre-registered destination buffer at the right
    # offset — zero intermediate copies end to end. With auth on, htag
    # (keyed-BLAKE2b over a domain prefix + header) is verified BEFORE the
    # header reaches pickle, and ptag (HMAC-SHA256, see _raw_payload_hasher)
    # is streamed over header+payload and verified before the chunk is
    # acknowledged; payload bytes do land in the (unsealed, transfer-private)
    # destination buffer before verification, but a failed tag drops the peer
    # and the chunk is never acked, so a tampered chunk cannot be sealed into
    # an object. Payload bytes are NEVER unpickled, so a forged payload can
    # corrupt data at worst, never execute code — the header is the lane's
    # code-execution surface and keeps the strict verify-before-pickle rule.

    def expect_raw(self, key: bytes, dest: memoryview, hasher=None) -> "asyncio.Future":
        """Register ``dest`` as the landing buffer for an incoming raw frame
        keyed ``key``; returns a future resolving True once the payload has
        fully landed (and, with auth enabled, verified). The payload length
        must equal len(dest) or the frame is discarded and the future
        resolves False. Unregister with unexpect_raw on timeout.

        ``hasher`` (window mode): a shared raw_window_hasher() updated with
        this frame's payload bytes as they land, INSTEAD of a per-chunk ptag
        (the sender marks the frame NOPTAG). The caller compares the final
        digest against the serve RPC's window tag after the whole window
        lands — until then the bytes are unverified and must stay in a
        transfer-private buffer."""
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        fut = self._loop.create_future()
        self._raw_expect[key] = [dest, fut, hasher]
        return fut

    def unexpect_raw(self, key: bytes):
        entry = self._raw_expect.pop(key, None)
        if entry is not None and not entry[1].done():
            entry[1].set_result(False)

    async def _raw_send_fault(self) -> bool:
        """The raw-lane send fault gate, shared by send_raw and
        send_raw_file (ONE literal ``rpc.raw.send`` injection point —
        chaos-gate's uniqueness contract — and both senders must fail
        identically under it). True = drop this frame."""
        fault = _chaos.maybe_inject("rpc.raw.send", peer=self.peer_name)
        if fault is not None:
            if fault.kind == "drop":
                return True
            if fault.kind == "stall":
                await asyncio.sleep(fault.delay_s)
        return False

    async def send_raw(self, key: bytes, payload, hasher=None) -> None:
        """Send one raw-lane frame. ``payload`` is bytes/memoryview OR a
        list/tuple of them (a multi-part frame: header + every slice ship as
        one vectored syscall); payload bytes are written to the socket
        as-is — no pickle, no bytes() copy, no join. Awaits transport drain
        (bulk-lane backpressure).

        ``hasher`` (window mode, auth on): a shared raw_window_hasher()
        updated with the payload; the frame is sent NOPTAG and the caller
        ships hasher.digest() out of band (authenticated envelope reply).
        Without it, an authenticated frame carries the per-chunk ptag."""
        global _SEND_BYTES, _RAW_SEND_BYTES
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        if await self._raw_send_fault():
            return  # chunk never lands; the puller's deadline fails it over
        if isinstance(payload, (list, tuple)):
            parts = [p if isinstance(p, memoryview) else memoryview(p) for p in payload]
        else:
            parts = [payload if isinstance(payload, memoryview) else memoryview(payload)]
        plen = sum(len(p) for p in parts)
        noptag = hasher is not None and bool(_frame_key)
        hdr = pickle.dumps((key, plen, _RAW_F_NOPTAG) if noptag else (key, plen), protocol=5)
        taglen = (_TAG_LEN if noptag else 2 * _TAG_LEN) if _frame_key else 0
        ln = 1 + taglen + 4 + len(hdr) + plen
        prefix = bytearray(ln.to_bytes(_HDR, "little"))
        prefix += _RAW
        ptag = b""
        if _frame_key:
            prefix += hashlib.blake2b(
                _RAW_HDR_DOMAIN + hdr, key=_frame_key, digest_size=_TAG_LEN
            ).digest()
            if noptag:
                for p in parts:
                    hasher.update(p)
            else:
                h = _raw_payload_hasher()
                h.update(hdr)
                for p in parts:
                    h.update(p)
                ptag = h.digest()[:_TAG_LEN]
        prefix += len(hdr).to_bytes(4, "little")
        prefix += hdr
        _SEND_BYTES += ln + _HDR
        _RAW_SEND_BYTES += ln + _HDR
        await _net_pace(ln + _HDR)
        bufs = [prefix, *parts]
        if ptag:
            bufs.append(ptag)
        if _VECTORED_SEND:
            sock = self.writer.get_extra_info("socket")
            if sock is not None and await self._send_bufs_vectored(sock, bufs):
                return
        try:
            # Legacy sequential-write shape (also the fallback when envelope
            # bytes are still backlogged in the transport — ordering must go
            # through the same buffer then). Consecutive synchronous writes:
            # frame parts cannot interleave with other frames (single loop
            # thread, no await in between).
            self.writer.write(bytes(prefix))
            for p in parts:
                self.writer.write(p)
            if ptag:
                self.writer.write(ptag)
        except Exception:
            pass  # transport gone: the read loop tears the connection down
        # The caller releases its arena pin when this returns, so the
        # payload view must be OUT of the transport buffer by then: on
        # Python 3.12+ the selector transport queues unsent data as the
        # caller's memoryview UNCOPIED (zero-copy writes), and a released
        # pin lets eviction recycle the region mid-flight — the wire would
        # carry whatever object landed there next. Zero write-buffer-limits
        # make drain() wait for a fully EMPTY buffer (pause at >0 bytes,
        # resume at 0), so this await completes only once the kernel owns
        # every payload byte. When the synchronous writes flushed everything
        # (the common un-backlogged case) the buffer is already empty and no
        # drain round trip is paid.
        if self.writer.transport.get_write_buffer_size() > 0:
            if not self._raw_zero_limits:
                self._raw_zero_limits = True
                self.writer.transport.set_write_buffer_limits(0)
            async with self._send_lock:
                await self.writer.drain()

    async def _send_bufs_vectored(self, sock, bufs: list) -> bool:
        """Ship ``bufs`` as one sendmsg syscall directly on the socket. Only
        valid while the transport buffer is EMPTY (then the transport has no
        writer registered and kernel-order == our order) — checked under the
        raw-send lock; returns False (caller takes the sequential path) when
        envelope bytes are backlogged there. The common case — 4 MiB frame
        into a 4 MiB SO_SNDBUF — completes in that single syscall with ZERO
        userspace copies (the sequential-write path pays a transport-buffer
        memcpy for every byte the first write couldn't flush). A partial
        send finishes via sock_sendall on a dup'd fd under _tx_hold so
        envelope flushes can't splice into the frame.
        """
        if len(bufs) > 64:  # stay far under IOV_MAX; absurd part counts take the sequential path
            return False
        async with self._raw_send_lock:
            if self._closed or self.writer.transport.get_write_buffer_size() > 0:
                return False
            if self._raw_send_sock is None:
                try:
                    # The transport's extra-info socket is a TransportSocket
                    # facade without send methods; sendmsg needs a real
                    # socket on a dup'd fd (same trick as _read_raw_into).
                    self._raw_send_sock = socket.socket(fileno=os.dup(sock.fileno()))
                    self._raw_send_sock.setblocking(False)
                except OSError:
                    return False
            try:
                sent = self._raw_send_sock.sendmsg(bufs)  # graftlint: disable=counted-transfers  send_raw counts the whole frame before dispatching to this path helper
            except (BlockingIOError, InterruptedError):
                sent = 0
            except OSError:
                return True  # transport gone: the read loop tears the connection down
            total = sum(len(b) for b in bufs)
            if sent == total:
                return True
            self._tx_hold = True
            try:
                for b in bufs:
                    if sent >= len(b):
                        sent -= len(b)
                        continue
                    mv = b if isinstance(b, memoryview) else memoryview(b)
                    try:
                        await self._loop.sock_sendall(self._raw_send_sock, mv[sent:] if sent else mv)  # graftlint: disable=counted-transfers  remainder of a frame send_raw already counted
                    except OSError:
                        return True  # peer gone mid-frame; read loop tears down
                    sent = 0
            finally:
                self._release_tx_hold()
            return True

    def _release_tx_hold(self):
        self._tx_hold = False
        if self._out and not self._flush_scheduled and not self._closed:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush_out)

    async def send_raw_file(self, key: bytes, fd: int, offset: int, length: int) -> None:
        """Send one raw-lane frame whose payload is ``length`` bytes at
        ``offset`` of file descriptor ``fd``, fd->socket via os.sendfile —
        the payload never enters userspace (kills the pread->bytes->write
        double copy on the spilled-chunk serve path). ONLY callable with
        auth disabled: a MAC needs the bytes in userspace, so authenticated
        links serve spilled chunks via pread + send_raw instead (callers
        gate on get_auth_token())."""
        global _SEND_BYTES, _RAW_SEND_BYTES
        if _frame_key:
            raise RpcError("send_raw_file requires auth off (MAC needs userspace bytes)")
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        if await self._raw_send_fault():
            return  # chunk never lands; the puller's deadline fails it over
        hdr = pickle.dumps((key, length), protocol=5)
        ln = 1 + 4 + len(hdr) + length
        prefix = bytearray(ln.to_bytes(_HDR, "little"))
        prefix += _RAW
        prefix += len(hdr).to_bytes(4, "little")
        prefix += hdr
        _SEND_BYTES += ln + _HDR
        _RAW_SEND_BYTES += ln + _HDR
        await _net_pace(ln + _HDR)
        sock = self.writer.get_extra_info("socket")
        if sock is None or not hasattr(os, "sendfile"):
            raise RpcError("transport does not support sendfile")
        async with self._raw_send_lock:
            # Flush any transport-buffered envelope bytes first so the frame
            # lands after them, then own the socket for the whole frame.
            if self.writer.transport.get_write_buffer_size() > 0:
                if not self._raw_zero_limits:
                    self._raw_zero_limits = True
                    self.writer.transport.set_write_buffer_limits(0)
                async with self._send_lock:
                    await self.writer.drain()
            self._tx_hold = True
            try:
                if self._raw_send_sock is None:
                    self._raw_send_sock = socket.socket(fileno=os.dup(sock.fileno()))
                    self._raw_send_sock.setblocking(False)  # dup'd fd: same trick as _read_raw_into
                await self._loop.sock_sendall(self._raw_send_sock, prefix)
                pos, left = offset, length
                while left > 0:
                    try:
                        k = os.sendfile(self._raw_send_sock.fileno(), fd, pos, left)
                    except (BlockingIOError, InterruptedError):
                        k = 0
                    if k == 0:
                        await self._sock_writable(self._raw_send_sock)
                        continue
                    pos += k
                    left -= k
            except OSError:
                return  # peer gone mid-frame; read loop tears down
            finally:
                self._release_tx_hold()

    def _sock_writable(self, sock) -> "asyncio.Future":
        """Await socket writability (sendfile has no asyncio wrapper that
        takes a raw fd + explicit offset, so the wait is hand-rolled)."""
        fut = self._loop.create_future()
        fd = sock.fileno()

        def _ready():
            self._loop.remove_writer(fd)
            if not fut.done():
                fut.set_result(None)

        self._loop.add_writer(fd, _ready)
        return fut

    async def _read_raw_frame(self, ln: int) -> bool:
        """Decode one raw frame (marker byte already consumed). Returns False
        when the peer must be dropped (tampered/garbled frame)."""
        reader = self.reader
        pos = 1
        htag = b""
        if _frame_key:
            fixed = await reader.readexactly(_TAG_LEN + 4)
            htag, hlen_b = fixed[:_TAG_LEN], fixed[_TAG_LEN:]
            pos += _TAG_LEN + 4
        else:
            hlen_b = await reader.readexactly(4)
            pos += 4
        hlen = int.from_bytes(hlen_b, "little")
        if hlen > _MAX_RAW_HDR or pos + hlen > ln:
            logger.warning("dropping peer %s: absurd raw header length %d", self.peer_name, hlen)
            return False
        hdr = await reader.readexactly(hlen)
        pos += hlen
        if _frame_key:
            want = hashlib.blake2b(
                _RAW_HDR_DOMAIN + hdr, key=_frame_key, digest_size=_TAG_LEN
            ).digest()
            # Constant-time check BEFORE the header reaches pickle.
            if not hmac.compare_digest(htag, want):
                logger.warning("rejecting unauthenticated raw frame from %s", self.peer_name)
                return False
        try:
            tup = pickle.loads(hdr)
            key, plen = tup[0], tup[1]
            flags = tup[2] if len(tup) > 2 else 0  # 2-tuple = v3 per-chunk frame
        except Exception:
            logger.warning("dropping peer %s: garbled raw header", self.peer_name)
            return False
        noptag = bool(flags & _RAW_F_NOPTAG)
        if pos + plen + (_TAG_LEN if (_frame_key and not noptag) else 0) != ln:
            logger.warning("dropping peer %s: raw frame length mismatch", self.peer_name)
            return False
        entry = self._raw_expect.pop(key, None)
        if entry is not None and len(entry[0]) == plen:
            dest, fut, whasher = entry
            claimed = True
        else:
            # Unclaimed or mis-sized chunk: stay framed by consuming the
            # payload into a throwaway buffer. (Window mode: the skipped
            # bytes never reach the shared window hasher, so the window tag
            # comparison fails and the whole window refetches per-chunk —
            # a mis-sized frame can't silently poison its windowmates.)
            if entry is not None:
                logger.warning(
                    "raw chunk %s from %s: size mismatch (got %d, expected %d)",
                    key.hex()[:8], self.peer_name, plen, len(entry[0]),
                )
            dest, fut, claimed = memoryview(bytearray(plen)), entry[1] if entry else None, False
            whasher = None
        hasher = None
        if _frame_key:
            if noptag:
                # Window mode: payload bytes stream into the window's shared
                # MAC (verified out of band over the whole window).
                hasher = whasher
            else:
                hasher = _raw_payload_hasher()
                hasher.update(hdr)
        try:
            await self._read_raw_into(dest, plen, hasher)
        except BaseException:
            if fut is not None and not fut.done():
                fut.set_result(False)
            raise
        if _frame_key and not noptag:
            ptag = await reader.readexactly(_TAG_LEN)
            if not hmac.compare_digest(ptag, hasher.digest()[:_TAG_LEN]):
                logger.warning("rejecting tampered raw payload from %s", self.peer_name)
                if fut is not None and not fut.done():
                    fut.set_result(False)
                return False
        if fut is not None and not fut.done():
            fut.set_result(claimed)
        return True

    async def _read_raw_into(self, dest: memoryview, n: int, hasher) -> None:
        """Receive exactly ``n`` payload bytes into ``dest`` with no
        intermediate bytes materialization: drain whatever the StreamReader
        already buffered via direct memoryview copies, then recv_into the
        destination through a dup'd fd while the transport is paused.
        Falls back to segmented readexactly copies when the private stream
        internals or the socket are unavailable."""
        reader = self.reader
        got = 0
        buf = getattr(reader, "_buffer", None)
        transport = getattr(reader, "_transport", None)
        sock = self.writer.get_extra_info("socket")
        if buf is None or transport is None or sock is None or not hasattr(self._loop, "sock_recv_into"):
            while got < n:
                seg = await reader.readexactly(min(1 << 18, n - got))
                dest[got : got + len(seg)] = seg
                if hasher is not None:
                    hasher.update(seg)
                got += len(seg)
            return
        transport.pause_reading()
        try:
            while got < n and buf:
                take = min(n - got, len(buf))
                mv = memoryview(buf)[:take]
                dest[got : got + take] = mv
                mv.release()
                del buf[:take]  # graftlint: disable=counted-trims  consuming received bytes into dest, not discarding data
                if hasher is not None:
                    hasher.update(dest[got : got + take])
                got += take
            if got < n:
                if self._raw_sock is None:
                    self._raw_sock = socket.socket(fileno=os.dup(sock.fileno()))
                    self._raw_sock.setblocking(False)
                while got < n:
                    k = await self._loop.sock_recv_into(self._raw_sock, dest[got:n])
                    if k == 0:
                        raise asyncio.IncompleteReadError(b"", n - got)
                    if hasher is not None:
                        hasher.update(dest[got : got + k])
                    got += k
        finally:
            # The reader's buffer is drained below its flow-control limit;
            # reflect that we own the resume (resume_reading is a guarded
            # no-op on a closing transport).
            try:
                reader._paused = False
                transport.resume_reading()
            except Exception:
                pass

    async def flush(self):
        """Flush the coalescing buffer now and await transport drain —
        backpressure for call_start senders (one flush per submission
        burst = one envelope per burst)."""
        if self._out and not self._closed:
            self._flush_out()
        async with self._send_lock:
            await self.writer.drain()

    async def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        msg_id = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send((_REQ, msg_id, method, payload))
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(msg_id, None)

    async def notify(self, method: str, payload: Any = None):
        if self._closed:
            raise ConnectionLost(f"connection to {self.peer_name} closed")
        await self._send((_NOTIFY, 0, method, payload))

    async def _read_loop(self):
        global _RECV_BYTES, _RAW_RECV_BYTES
        try:
            while True:
                hdr = await self.reader.readexactly(_HDR)
                ln = int.from_bytes(hdr, "little")
                if ln > _MAX_FRAME or ln < 1:
                    logger.warning("dropping peer %s: absurd frame length %d", self.peer_name, ln)
                    return
                first = (await self.reader.readexactly(1))[0]
                if first == _RAW_MARKER:
                    # Raw chunk lane: payload is recv'd straight into the
                    # registered destination buffer, never through pickle.
                    _RECV_BYTES += ln + _HDR
                    _RAW_RECV_BYTES += ln + _HDR
                    if not await self._read_raw_frame(ln):
                        return
                    continue
                # Version check BEFORE auth/unpickle: a frame from a build
                # with a different wire generation must never reach pickle.
                if first != WIRE_VERSION:
                    logger.error(
                        "refusing rpc frame from %s: wire-format version %s, this build speaks %d "
                        "— all hosts of a session must run the same ray_tpu_torch version; dropping peer",
                        self.peer_name, first, WIRE_VERSION,
                    )
                    return
                data = await self.reader.readexactly(ln - 1)
                _RECV_BYTES += ln + _HDR
                data = memoryview(data)
                if _frame_key:
                    # Constant-time per-frame MAC check BEFORE any
                    # unpickling; wrong/missing tag = unauthenticated or
                    # tampered frame, drop the peer.
                    body = data[_TAG_LEN:]
                    if len(data) < _TAG_LEN or not hmac.compare_digest(data[:_TAG_LEN], _tag(body)):
                        logger.warning("rejecting unauthenticated rpc frame from %s", self.peer_name)
                        return
                    data = body
                obj = pickle.loads(data)
                # Envelope decode: one frame carries either a single message
                # tuple or a list of them (coalesced batch). All replies in
                # a batch resolve inline in THIS wakeup — reply absorption
                # is amortized to one loop wakeup per envelope; requests/
                # notifies dispatch as tasks in wire order (ordering contract
                # for per-actor FIFO and stream registration is task-creation
                # order, which equals envelope order).
                msgs = obj if type(obj) is list else (obj,)
                fault = _chaos.maybe_inject("rpc.recv.dispatch", peer=self.peer_name)
                if fault is not None and fault.kind == "delay":
                    # Latency injection on the receive side (the send side is
                    # sync): everything in this envelope — replies included —
                    # lands late, exercising timeout/grace tolerances.
                    await asyncio.sleep(fault.delay_s)
                _RECV_BATCH_HIST[len(msgs)] += 1
                for kind, msg_id, method, payload in msgs:
                    if kind == _REP:
                        fut = self._pending.get(msg_id)
                        if fut is not None and not fut.done():
                            ok, result = method, payload
                            if ok == "ok":
                                fut.set_result(result)
                            else:
                                fut.set_exception(result if isinstance(result, BaseException) else RpcError(str(result)))
                    else:
                        _spawn_bg(self._dispatch_tasks, self._dispatch(kind, msg_id, method, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, OSError):
            pass
        except asyncio.CancelledError:
            return
        except Exception:
            logger.exception("rpc read loop error (peer=%s)", self.peer_name)
        finally:
            self._teardown()

    async def _dispatch(self, kind, msg_id, method, payload):
        try:
            fn = getattr(self.handler, "handle_" + method, None)
            if fn is None:
                raise RpcError(f"no handler for {method!r} on {type(self.handler).__name__}")
            result = fn(self, payload)
            if asyncio.iscoroutine(result):
                result = await result
            if kind == _REQ:
                # Reply fast path: enqueue only — reply volume is bounded by
                # the peer's in-flight requests, so per-reply drain is pure
                # overhead, and skipping it lets every reply completing this
                # tick coalesce into one envelope. Drain (backpressure) only
                # when the transport buffer is genuinely backed up.
                self._enqueue((_REP, msg_id, "ok", result))
                if self.writer.transport.get_write_buffer_size() > 1 << 20:
                    async with self._send_lock:
                        await self.writer.drain()
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            if kind == _REQ:
                try:
                    pickle.dumps(e)
                    err: Any = e
                except Exception:
                    err = RpcError(f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
                try:
                    await self._send((_REP, msg_id, "err", err))
                except Exception:
                    pass
            else:
                logger.exception("error in notify handler %s", method)

    def _teardown(self):
        if self._closed:
            return
        self._closed = True
        self._out.clear()  # unflushed messages die with their reply futures
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection to {self.peer_name} lost"))
                fut.add_done_callback(lambda f: f.exception())
        self._pending.clear()
        for entry in self._raw_expect.values():
            if not entry[1].done():
                entry[1].set_result(False)  # chunk never landed; puller retries elsewhere
        self._raw_expect.clear()
        for attr in ("_raw_sock", "_raw_send_sock"):
            s = getattr(self, attr)
            if s is not None:
                try:
                    s.close()
                except Exception:
                    pass
                setattr(self, attr, None)
        try:
            self.writer.close()
        except Exception:
            pass
        if self.on_close:
            cb, self.on_close = self.on_close, None
            try:
                cb(self)
            except Exception:
                if not self._loop.is_closed():
                    logger.debug("on_close callback failed", exc_info=True)

    @property
    def closed(self):
        return self._closed

    async def close(self):
        self._task.cancel()
        self._teardown()


class RpcServer:
    """Listens on tcp host:port (port=0 picks free) and/or a unix path."""

    def __init__(self, handler: Any, host: str = "127.0.0.1"):
        self.handler = handler
        self.host = host
        self.port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self.connections: set[Connection] = set()

    async def start(self, port: int = 0) -> str:
        self._server = await asyncio.start_server(self._on_client, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.address

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _on_client(self, reader, writer):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            _tune_peer_socket(sock)
        conn = Connection(reader, writer, self.handler, peer_name="client")
        self.connections.add(conn)
        conn.on_close = self.connections.discard
        cb = getattr(self.handler, "on_connection", None)
        if cb:
            cb(conn)

    async def close(self):
        if self._server:
            self._server.close()
        for conn in list(self.connections):
            await conn.close()
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except Exception:
                pass


class PersistentConnection:
    """A Connection that transparently redials on loss and replays a
    registration handshake (``on_reconnect``) after each redial.

    Used for the long-lived links to the controller: daemons/drivers survive a
    controller restart (reference: GCS fault tolerance — raylets reconnect on
    RayletNotifyGCSRestart, core_worker.proto:475; here reconnection is
    detected by the TCP close + retried dial). Calls that were in flight when
    the link dropped raise ConnectionLost to THEIR caller (no blind replay of
    possibly non-idempotent operations); subsequent calls redial.
    """

    def __init__(self, addr: str, handler: Any = None, on_reconnect=None,
                 dial_timeout: float = 5.0, give_up_after: float = 120.0):
        self.addr = addr
        self.handler = handler
        self.on_reconnect = on_reconnect
        self.dial_timeout = dial_timeout
        self.give_up_after = give_up_after
        self._conn: Connection | None = None
        self._lock = asyncio.Lock()
        self._closed = False
        self.meta: dict = {}

    async def _ensure(self) -> Connection:
        if self._closed:
            raise ConnectionLost(f"persistent connection to {self.addr} closed")
        if self._conn is not None and not self._conn.closed:
            return self._conn
        async with self._lock:
            if self._conn is not None and not self._conn.closed:
                return self._conn
            deadline = time.monotonic() + self.give_up_after
            attempt = 0
            while True:
                if self._closed:
                    raise ConnectionLost(f"persistent connection to {self.addr} closed")
                conn = None
                try:
                    conn = await connect(self.addr, handler=self.handler, timeout=self.dial_timeout, retry=False)
                    if self.on_reconnect is not None:
                        await self.on_reconnect(conn)
                    self._conn = conn
                    return conn
                except Exception as e:
                    if conn is not None:  # dialed but handshake failed: don't leak it
                        try:
                            await conn.close()
                        except Exception:
                            pass
                    attempt += 1
                    if time.monotonic() > deadline:
                        raise ConnectionLost(f"cannot re-establish {self.addr}: {e}") from e
                    await asyncio.sleep(min(0.05 * attempt, 1.0))

    async def ensure(self) -> Connection:
        """Dial (and run the handshake) now; returns the live Connection."""
        return await self._ensure()

    async def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        conn = await self._ensure()
        return await conn.call(method, payload, timeout)

    async def notify(self, method: str, payload: Any = None):
        conn = await self._ensure()
        await conn.notify(method, payload)

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self):
        self._closed = True
        if self._conn is not None:
            await self._conn.close()


async def connect(addr: str, handler: Any = None, timeout: float = 10.0, retry: bool = True) -> Connection:
    kind_parts = parse_addr(addr)
    deadline = time.monotonic() + timeout
    last_err: Exception | None = None
    while True:
        try:
            if kind_parts[0] == "unix":
                reader, writer = await asyncio.open_unix_connection(kind_parts[1])
            else:
                reader, writer = await asyncio.open_connection(kind_parts[1], kind_parts[2])
            sock = writer.get_extra_info("socket")
            if sock is not None:
                _tune_peer_socket(sock)
                if sock.family in (socket.AF_INET, socket.AF_INET6):
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return Connection(reader, writer, handler, peer_name=addr)
        except (ConnectionRefusedError, FileNotFoundError, OSError) as e:
            last_err = e
            if not retry or time.monotonic() > deadline:
                raise ConnectionLost(f"cannot connect to {addr}: {e}") from e
            await asyncio.sleep(0.05)
