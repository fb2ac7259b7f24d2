"""Ring collectives over peer-to-peer raw-frame RPC connections.

The coordinator actor (collective.py) keeps only membership/epoch/rendezvous
duty; tensor bytes flow rank -> successor over the PR-3 zero-pickle raw
frame lane (tiny pickled header + out-of-band payload, keyed-BLAKE2b header
tag + streamed HMAC payload tag when auth is on) on ordinary worker-to-worker
``Connection``s — the same transport the object-transfer plane trusts. No
tensor byte is ever pickled and none transits the coordinator (asserted by
the coordinator's own payload-byte counter, tests/test_collective_ring.py).

Topology: rank r dials rank (r+1) % W once per (group, epoch) and keeps the
link; the inbound link from (r-1) % W is recognized by a ``hello`` RPC. A
collective is then W-1 reduce-scatter steps + W-1 allgather steps (or a
src->...->dst line for broadcast/reduce) of keyed raw frames. The receiver
pre-registers EVERY landing buffer for the op and sends its predecessor one
``ready`` notify, so the steady state has zero per-step control round trips:
frame keys are pure functions of (group, epoch, op counter, phase, step,
part) and both ends derive them independently.

Ordering contract (the standard one): all ranks of a group must start the
same collectives in the same order — the per-ring op counter is the only
thing matching a frame to an op. Concurrent ops (the train plane's bucketed
overlap) interleave safely because every frame is keyed by its op counter.

Failure semantics: a missing/rejected frame surfaces within the step
timeout as a typed :class:`CollectiveError` — never a hang — and the
failing rank fans an ``abort`` notify both ways around the ring so every
blocked rank fails with the origin attributed. Chaos site
``collective.ring.send`` injects exactly these losses deterministically
(scenario ``ring_link_loss``).

Quantized mode (EQuARX, arxiv 2506.17615): ``quantization="int8"``
accumulates in fp32, quantizes each hop's chunk to int8 + per-block fp32
absmax scales (collective/quantize.py), and in the allgather phase forwards
the owner's encoding VERBATIM so every rank decodes byte-identical values —
an allreduce must agree everywhere, so the owner also replaces its own
chunk with the dequantized image of what it shipped.
"""
from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.collective import quantize as _quant
from ray_tpu_torch.util import dtypes as _dt
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

_RS, _AG = 0, 1  # phases (key domain separation)


class CollectiveError(RuntimeError):
    """Typed group failure: a ring collective that cannot complete (lost
    link, dead rank, metadata mismatch, abort fan-in). Never a bare hang —
    every wait in this module is bounded by the step timeout."""


_bytes_total = _metrics.Counter(
    "collective.bytes",
    "tensor payload bytes moved by ring collectives",
    tag_keys=("op", "side"),
)
_gbs_hist = _metrics.Histogram(
    "collective.allreduce.gb_s",
    "effective allreduce throughput (input GB / wall second)",
    boundaries=[0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
    tag_keys=("transport", "quant"),
)

# (group, boot, epoch) -> _Ring. Mutated on the worker IO loop; read (under
# the lock) by sync callers allocating op counters from executor threads.
_RINGS: dict = {}
# (group, boot, epoch) -> (rank, conn): hellos that arrived before this process
# built its ring object (the neighbor won the init race). Bounded by the
# number of live groups; adopted (and popped) during establish.
_PENDING_HELLOS: dict = {}
# (group, boot, epoch) -> {ctr: meta}: broadcast metas that arrived before
# this process built its ring. Unlike hellos there is NO retransmit — the
# sender's establish is not gated on its successor's, so a late first op on
# the receiving rank would otherwise park on the meta event until the step
# timeout and fail the whole broadcast. Adopted (and popped) during
# establish; reaped with the group's other stale keys.
_PENDING_METAS: dict = {}
_PENDING_META_CAP = 128  # per ring key; overflow counted, never silent
_LOCK = threading.Lock()

_pending_meta_dropped = _metrics.Counter(
    "collective.pending_meta.dropped",
    "broadcast metas discarded because the pre-establish stash overflowed",
)


def _key(group: str, boot: str, epoch: int, ctr: int, phase: int, step: int,
         part: int) -> bytes:
    # boot = the coordinator instance's id: a destroyed-and-recreated group
    # restarts its epochs, so (group, epoch) alone would let a surviving
    # old-gang peer land frames in a new incarnation's buffers.
    return hashlib.blake2b(
        b"%s:%s:%d:%d:%d:%d:%d" % (group.encode(), boot.encode(), epoch, ctr,
                                   phase, step, part),
        digest_size=12, person=b"raytpu-ring",
    ).digest()


def _split(n: int, w: int) -> tuple:
    base, rem = divmod(n, w)
    counts = [base + 1] * rem + [base] * (w - rem)
    offs, acc = [], 0
    for c in counts:
        offs.append(acc)
        acc += c
    return counts, offs


def _combine_into(seg, incoming, op: str) -> None:
    """``seg op= incoming`` in place. A bfloat16 segment is a CPU torch
    tensor: torch's in-place ops round each element to bfloat16 once per
    combine, as the reference's ml_dtypes arithmetic does."""
    if not isinstance(seg, np.ndarray):
        if op == "sum":
            seg.add_(incoming)
        elif op == "prod":
            seg.mul_(incoming)
        elif op == "max":
            seg.copy_(seg.maximum(incoming))
        elif op == "min":
            seg.copy_(seg.minimum(incoming))
        else:
            raise ValueError(f"unknown reduction op {op!r}")
        return
    if op == "sum":
        seg += incoming
    elif op == "prod":
        seg *= incoming
    elif op == "max":
        np.maximum(seg, incoming, out=seg)
    elif op == "min":
        np.minimum(seg, incoming, out=seg)
    else:
        raise ValueError(f"unknown reduction op {op!r}")


class _Ring:
    """Per-(group, epoch) ring state living on the worker IO loop."""

    def __init__(self, core, group: str, boot: str, epoch: int, rank: int,
                 world: int, addresses: dict):
        self.core = core
        self.group = group
        self.boot = boot
        self.epoch = epoch
        self.rank = rank
        self.world = world
        self.addresses = addresses
        self.succ = (rank + 1) % world
        self.pred = (rank - 1) % world
        self.succ_conn = None
        self.pred_conn = None
        self.pred_evt = asyncio.Event()
        self.established = False
        self._est_lock = asyncio.Lock()
        # Per-op-counter control state (created/consumed on the loop).
        self.ready_evts: dict = {}   # ctr -> asyncio.Event (succ armed)
        self.ready_meta: dict = {}   # ctr -> meta dict from succ's ready
        self.meta_evts: dict = {}    # ctr -> asyncio.Event (bcast meta landed)
        self.metas: dict = {}        # ctr -> meta dict from pred (broadcast)
        self.aborts: dict = {}       # ctr -> reason string
        self.abort_evts: dict = {}
        self._ctr = 0
        # Finished-op tracking: ops complete in roughly-allocated order, so a
        # contiguous-prefix watermark plus the out-of-order remainder stays
        # tiny. Late control notifies (a neighbor's abort/ready arriving
        # after _finish_op) must not repopulate per-op dicts forever.
        self._finished_mark = 0
        self._finished: set = set()
        # Overwritten from Config at establish.
        self.step_timeout = 30.0
        self.part_bytes = 8 << 20

    # -- sync side -------------------------------------------------------
    def next_ctr(self) -> int:
        with _LOCK:
            c = self._ctr
            self._ctr += 1
            return c

    def healthy(self) -> bool:
        return (self.established
                and self.succ_conn is not None and not self.succ_conn.closed
                and self.pred_conn is not None and not self.pred_conn.closed)

    # -- loop side -------------------------------------------------------
    def _abort_evt(self, ctr: int) -> "asyncio.Event":
        ev = self.abort_evts.get(ctr)
        if ev is None:
            ev = self.abort_evts[ctr] = asyncio.Event()
        return ev

    def _ready_evt(self, ctr: int) -> "asyncio.Event":
        ev = self.ready_evts.get(ctr)
        if ev is None:
            ev = self.ready_evts[ctr] = asyncio.Event()
        return ev

    def _meta_evt(self, ctr: int) -> "asyncio.Event":
        ev = self.meta_evts.get(ctr)
        if ev is None:
            ev = self.meta_evts[ctr] = asyncio.Event()
        return ev

    def _finish_op(self, ctr: int) -> None:
        for d in (self.ready_evts, self.ready_meta, self.meta_evts,
                  self.metas, self.abort_evts, self.aborts):
            d.pop(ctr, None)
        self._finished.add(ctr)
        while self._finished_mark in self._finished:
            self._finished.discard(self._finished_mark)
            self._finished_mark += 1

    def _is_finished(self, ctr: int) -> bool:
        return ctr < self._finished_mark or ctr in self._finished

    async def _wait_or_abort(self, ctr: int, awaitable, deadline: float,
                             still_waiting_msg: str) -> None:
        """Wait for one future/event-wait, racing the op's abort event,
        bounded by min(step timeout, op deadline). Raises the typed abort
        or ``still_waiting_msg`` timeout; returns when the awaitable won."""
        guard = asyncio.ensure_future(self._abort_evt(ctr).wait())
        waiter = asyncio.ensure_future(awaitable) if asyncio.iscoroutine(
            awaitable) else awaitable
        try:
            budget = min(self.step_timeout, deadline - time.monotonic())
            done, _pending = await asyncio.wait(
                {waiter, guard}, timeout=max(0.0, budget),
                return_when=asyncio.FIRST_COMPLETED)
        finally:
            guard.cancel()
            if waiter is not awaitable:
                waiter.cancel()
        if ctr in self.aborts:
            raise CollectiveError(
                f"collective aborted in group {self.group!r}: {self.aborts[ctr]}")
        if waiter not in done:
            raise CollectiveError(
                f"{still_waiting_msg} in group {self.group!r} "
                f"(step timeout {self.step_timeout}s)")

    async def _fan_abort(self, ctr: int, reason: str, origin: int,
                         direction: int) -> None:
        """Record the abort locally and forward it around the ring (both
        ways from the origin, stopping before it would circle back)."""
        if self._is_finished(ctr):
            return  # late fan-in for an op this rank already closed out
        if ctr not in self.aborts:
            self.aborts[ctr] = reason
            self._abort_evt(ctr).set()
            _tracing.event("collective.ring.abort", group=self.group,
                           ctr=ctr, origin=origin, reason=reason)
        payload = {"group": self.group, "boot": self.boot,
                   "epoch": self.epoch, "ctr": ctr,
                   "reason": reason, "origin": origin}
        targets = []
        if direction in (0, +1) and self.succ != origin and self.succ_conn is not None:
            targets.append((self.succ_conn, +1))
        if direction in (0, -1) and self.pred != origin and self.pred_conn is not None:
            targets.append((self.pred_conn, -1))
        for conn, d in targets:
            try:
                # Enqueue-only lane: a drain here would park behind every
                # in-flight raw payload byte (send_raw zeroes the write-
                # buffer limits, so drain waits for a fully-empty buffer).
                conn.notify_soon("collective_ring_abort", {**payload, "dir": d})
            except Exception:
                pass  # a dead link: that neighbor's own step timeout covers it

    # -- op plumbing -----------------------------------------------------
    def _register(self, ctr: int, phase: int, step: int, buf) -> list:
        """Pre-register one step's landing buffer on the inbound link,
        split into raw-lane parts; returns [(key, future), ...]."""
        part_bytes = self.part_bytes
        mv = memoryview(buf)
        out = []
        n = len(mv)
        nparts = max(1, (n + part_bytes - 1) // part_bytes)
        for pi in range(nparts):
            sl = mv[pi * part_bytes: min((pi + 1) * part_bytes, n)]
            k = _key(self.group, self.boot, self.epoch, ctr, phase, step, pi)
            out.append((k, self.pred_conn.expect_raw(k, sl)))
        return out

    async def _send_step(self, ctr: int, phase: int, step: int, payload,
                         opname: str) -> None:
        mv = memoryview(payload)
        part_bytes = self.part_bytes
        n = len(mv)
        nparts = max(1, (n + part_bytes - 1) // part_bytes)
        for pi in range(nparts):
            sl = mv[pi * part_bytes: min((pi + 1) * part_bytes, n)]
            k = _key(self.group, self.boot, self.epoch, ctr, phase, step, pi)
            fault = _chaos.maybe_inject(
                "collective.ring.send", group=self.group, rank=self.rank,
                op=opname, step=f"{phase}.{step}.{pi}")
            if fault is not None:
                if fault.kind == "drop":
                    # The frame never reaches the wire: the successor's step
                    # deadline trips and fans the typed group abort.
                    continue
                if fault.kind == "corrupt":
                    # Model an in-flight integrity failure: a real bit-flip
                    # is caught by the raw lane's payload MAC and the frame
                    # discarded with the connection — here the frame ships
                    # under a poisoned key, so the receiver discards it
                    # unclaimed and the loss surfaces the same typed way.
                    k = hashlib.blake2b(k, digest_size=12,
                                        person=b"raytpu-ring").digest()
                if fault.kind == "delay":
                    await asyncio.sleep(fault.delay_s)
            await self.succ_conn.send_raw(k, sl)
        _bytes_total.inc(n, tags={"op": opname, "side": "send"})

    async def _await_parts(self, ctr: int, parts: list, deadline: float,
                           what: str) -> None:
        """Wait for one step's frames, guarded by the op abort event, the
        step timeout, and the op deadline — a lost frame becomes a typed
        CollectiveError, never a hang."""
        for k, fut in parts:
            if fut.done() and fut.result():
                continue
            try:
                await self._wait_or_abort(
                    ctr, fut, deadline,
                    f"timed out waiting for {what} from rank {self.pred}")
            except CollectiveError:
                if not fut.done():
                    self.pred_conn.unexpect_raw(k)
                raise
            if not fut.result():
                raise CollectiveError(
                    f"inbound ring link from rank {self.pred} failed mid-{what} "
                    f"in group {self.group!r} (connection lost or frame rejected)")

    async def _handshake(self, ctr: int, meta: Optional[dict], sends: bool,
                         recvs: bool, deadline: float, opname: str) -> None:
        """Receiver -> predecessor 'armed' notify; sender awaits successor's.
        The ready carries the receiver's op metadata so a shape/dtype/quant
        mismatch fails loud here instead of as a size-mismatched frame."""
        if recvs:
            # notify_soon, NOT notify: with raw payloads in flight the
            # transport's write-buffer limits are zeroed and notify's drain
            # would wait for a fully-empty buffer — serializing bucket i+1's
            # handshake behind bucket i's tensor bytes (measured: the
            # bucketed-overlap bench went from 0.76x to >1x on this change).
            self.pred_conn.notify_soon("collective_ring_ready", {
                "group": self.group, "boot": self.boot, "epoch": self.epoch,
                "ctr": ctr, "rank": self.rank, "meta": meta})
        if sends:
            ev = self._ready_evt(ctr)
            await self._wait_or_abort(
                ctr, ev.wait(), deadline,
                f"rank {self.succ} never armed for {opname} ctr={ctr}")
            peer = self.ready_meta.get(ctr)
            if meta is not None and peer is not None and peer != meta:
                raise CollectiveError(
                    f"collective metadata mismatch in group {self.group!r}: "
                    f"rank {self.rank} {meta} vs rank {self.succ} {peer}")


# ---------------------------------------------------------------------------
# RPC handler entry points (CoreWorker delegates here; all run on the loop)
# ---------------------------------------------------------------------------


def _ring_key(p: dict) -> tuple:
    return (p["group"], p.get("boot", ""), p["epoch"])


def _on_hello(conn, p: dict) -> bool:
    key = _ring_key(p)
    with _LOCK:
        _PENDING_HELLOS[key] = (p["rank"], conn)
        ring = _RINGS.get(key)
    if ring is not None:
        if p["rank"] == ring.pred:
            ring.pred_conn = conn
            ring.pred_evt.set()
    return True


def _on_ready(p: dict) -> None:
    with _LOCK:
        ring = _RINGS.get(_ring_key(p))
    if ring is None:
        return  # late/stale: our side of this ring is gone
    ctr = p["ctr"]
    if ring._is_finished(ctr):
        return  # op already closed out; don't repopulate per-op state
    ring.ready_meta[ctr] = p.get("meta")
    ring._ready_evt(ctr).set()


def _on_meta(p: dict) -> None:
    with _LOCK:
        ring = _RINGS.get(_ring_key(p))
        if ring is None:
            # Receiver hasn't built its ring yet (late first op): stash for
            # adoption at establish — dropping a broadcast meta has no
            # recovery short of the step timeout.
            stash = _PENDING_METAS.setdefault(_ring_key(p), {})
            if len(stash) >= _PENDING_META_CAP:
                _pending_meta_dropped.inc(1)
            else:
                stash[p["ctr"]] = p["meta"]
            return
    ctr = p["ctr"]
    if ring._is_finished(ctr):
        return
    ring.metas[ctr] = p["meta"]
    ring._meta_evt(ctr).set()


def _on_abort(p: dict):
    with _LOCK:
        ring = _RINGS.get(_ring_key(p))
    if ring is None:
        return None
    return ring._fan_abort(p["ctr"], p["reason"], p["origin"], p.get("dir", 0))


def drop_group(group: str) -> None:
    """Forget every ring of ``group`` (destroy_collective_group)."""
    with _LOCK:
        for key in [k for k in _RINGS if k[0] == group]:
            _RINGS.pop(key, None)
        for key in [k for k in _PENDING_HELLOS if k[0] == group]:
            _PENDING_HELLOS.pop(key, None)
        for key in [k for k in _PENDING_METAS if k[0] == group]:
            _PENDING_METAS.pop(key, None)


# ---------------------------------------------------------------------------
# Establishment
# ---------------------------------------------------------------------------


def establish_sync(core, group: str, boot: str, epoch: int, rank: int,
                   world: int, addresses: dict, timeout: float) -> _Ring:
    """Build (or reuse) the ring for (group, boot, epoch) from a sync
    caller. ``boot`` is the coordinator instance id: a destroyed-and-
    recreated same-named group restarts its epochs, and keying on it keeps
    a stale ring (old gang, old conns, old op counter) from being reused."""
    with _LOCK:
        ring = _RINGS.get((group, boot, epoch))
    if ring is not None and ring.healthy():
        return ring
    fut = asyncio.run_coroutine_threadsafe(
        _establish(core, group, boot, epoch, rank, world, addresses, timeout),
        core.loop)
    return fut.result(timeout + 5.0)


async def _establish(core, group: str, boot: str, epoch: int, rank: int,
                     world: int, addresses: dict, timeout: float) -> _Ring:
    key = (group, boot, epoch)
    with _LOCK:
        ring = _RINGS.get(key)
        carry = None
        if ring is not None and not ring.healthy() and ring.established:
            # A link died since last use: rebuild, CARRYING the survivors.
            # The op counter must survive — every rank's counter is the only
            # frame<->op match, and the other ranks' rings (which never saw
            # the dead socket) keep theirs, so a reset would mismatch every
            # future frame key. A still-open inbound link must survive too:
            # the predecessor's outbound conn didn't die with ours, so it
            # will never re-dial/re-hello — without the carry, one dead
            # socket left the group unrecoverable for world >= 3.
            carry, ring = ring, None
            _RINGS.pop(key, None)
        if ring is None:
            ring = _Ring(core, group, boot, epoch, rank, world, addresses)
            if carry is not None:
                ring._ctr = carry._ctr
                ring._finished_mark = carry._finished_mark
                ring._finished = carry._finished
                # Per-op control state moves over BY REFERENCE: a neighbor
                # whose ring never died keeps launching ops, and its
                # ready/meta/abort notifies may have already landed on the
                # old object — dropping them would strand the very first
                # post-rebuild op in its handshake until the step timeout.
                ring.ready_evts = carry.ready_evts
                ring.ready_meta = carry.ready_meta
                ring.meta_evts = carry.meta_evts
                ring.metas = carry.metas
                ring.aborts = carry.aborts
                ring.abort_evts = carry.abort_evts
                if carry.pred_conn is not None and not carry.pred_conn.closed:
                    ring.pred_conn = carry.pred_conn
            _RINGS[key] = ring
        pend_metas = _PENDING_METAS.pop(key, None)
        # One live incarnation per group per process: older epochs and other
        # coordinator boots are dead gangs — reap them (an elastic group that
        # re-joins every resize would otherwise leak a _Ring, two conns, and
        # per-op dicts per incarnation for the life of the process).
        for k in [k for k in _RINGS if k[0] == group and k != key]:
            _RINGS.pop(k, None)
        for k in [k for k in _PENDING_HELLOS if k[0] == group and k != key]:
            _PENDING_HELLOS.pop(k, None)
        for k in [k for k in _PENDING_METAS if k[0] == group and k != key]:
            _PENDING_METAS.pop(k, None)
    if pend_metas:
        # Adopt broadcast metas that beat this ring into existence (we run
        # on the worker loop, same as _on_meta would have).
        for ctr, meta in pend_metas.items():
            if not ring._is_finished(ctr):
                ring.metas[ctr] = meta
                ring._meta_evt(ctr).set()
    # The ADOPTED cluster config, not get_config(): spawned workers only see
    # head-pushed knobs through core.config (the PR-8 qos lesson).
    cfg = core.config
    ring.step_timeout = cfg.collective_ring_step_timeout_s
    ring.part_bytes = cfg.collective_part_bytes
    async with ring._est_lock:
        if ring.healthy():
            return ring
        deadline = time.monotonic() + timeout
        ring.succ_conn = await core._peer_conn(addresses[ring.succ])
        await ring.succ_conn.call(
            "collective_ring_hello",
            {"group": group, "boot": boot, "epoch": epoch, "rank": rank},
            timeout=timeout)
        while ring.pred_conn is None or ring.pred_conn.closed:
            with _LOCK:
                pend = _PENDING_HELLOS.get(key)
            if pend is not None and pend[0] == ring.pred and not pend[1].closed:
                ring.pred_conn = pend[1]
                with _LOCK:
                    _PENDING_HELLOS.pop(key, None)
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CollectiveError(
                    f"ring link from rank {ring.pred} never arrived in group "
                    f"{group!r} (establish timeout {timeout}s)")
            try:
                await asyncio.wait_for(ring.pred_evt.wait(), remaining)
            except asyncio.TimeoutError:
                pass
            ring.pred_evt.clear()
        ring.established = True
        return ring


# ---------------------------------------------------------------------------
# Ops. Each is a coroutine on the worker loop operating on bytearray-backed
# buffers prepared by the sync wrapper (collective.py) in the caller thread.
# ---------------------------------------------------------------------------


async def _fail_loud(ring: _Ring, ctr: int, pending: list, coro):
    """Run the op body; on any failure unregister leftover expects, fan the
    abort both ways, and re-raise typed."""
    try:
        with _tracing.span("collective.ring", group=ring.group,
                           epoch=ring.epoch, ctr=ctr):
            return await coro
    except CollectiveError as e:
        for k, f in pending:
            if not f.done():
                ring.pred_conn.unexpect_raw(k)
        await ring._fan_abort(ctr, str(e), ring.rank, 0)
        raise
    except Exception as e:
        for k, f in pending:
            if not f.done():
                ring.pred_conn.unexpect_raw(k)
        err = CollectiveError(
            f"ring collective failed in group {ring.group!r}: "
            f"{type(e).__name__}: {e}")
        await ring._fan_abort(ctr, str(err), ring.rank, 0)
        raise err from e
    finally:
        ring._finish_op(ctr)


async def _allreduce(ring: _Ring, ctr: int, buf: bytearray, dtype, n: int,
                     op: str, quant: Optional[str], block: int,
                     timeout: float) -> bytearray:
    W, r = ring.world, ring.rank
    deadline = time.monotonic() + timeout
    counts, offs = _split(n, W)
    item = _dt.itemsize(dtype)
    acc = _dt.from_bytes(buf, dtype)
    pending: list = []

    async def body():
        # Pre-register every landing buffer (zero per-step control traffic).
        rs_bufs, steps = [], []
        for s in range(W - 1):
            rc = (r - s - 1) % W
            nb = _quant.quant_nbytes(counts[rc], block) if quant else counts[rc] * item
            b = bytearray(nb)
            rs_bufs.append(b)
            parts = ring._register(ctr, _RS, s, b)
            pending.extend(parts)
            steps.append(parts)
        ag_bufs = []
        for s in range(W - 1):
            rc = (r - s) % W
            if quant:
                b = bytearray(_quant.quant_nbytes(counts[rc], block))
            else:
                b = memoryview(buf)[offs[rc] * item:(offs[rc] + counts[rc]) * item]
            ag_bufs.append(b)
            parts = ring._register(ctr, _AG, s, b)
            pending.extend(parts)
            steps.append(parts)
        meta = {"op": "allreduce", "red": op, "dtype": dtype,
                "n": n, "quant": quant, "block": block if quant else 0}
        await ring._handshake(ctr, meta, sends=True, recvs=True,
                              deadline=deadline, opname="allreduce")
        scratch = bytearray(_quant.quant_nbytes(counts[0], block)) if quant else None
        # -- reduce-scatter: W-1 steps -------------------------------------
        for s in range(W - 1):
            sc = (r - s) % W
            seg = acc[offs[sc]:offs[sc] + counts[sc]]
            if quant:
                out = memoryview(scratch)[:_quant.quant_nbytes(counts[sc], block)]
                _quant.quantize_into(seg, out, block)
                await ring._send_step(ctr, _RS, s, out, "allreduce")
            else:
                await ring._send_step(
                    ctr, _RS, s,
                    memoryview(buf)[offs[sc] * item:(offs[sc] + counts[sc]) * item],
                    "allreduce")
            await ring._await_parts(ctr, steps[s], deadline, "reduce-scatter frame")
            rc = (r - s - 1) % W
            incoming = (_quant.dequantize(memoryview(rs_bufs[s]), counts[rc], block)
                        if quant else _dt.from_bytes(rs_bufs[s], dtype))
            _combine_into(acc[offs[rc]:offs[rc] + counts[rc]], incoming, op)
            _bytes_total.inc(len(rs_bufs[s]), tags={"op": "allreduce", "side": "recv"})
        # -- allgather: W-1 steps ------------------------------------------
        own_q = None
        for s in range(W - 1):
            sc = (r + 1 - s) % W
            if s == 0:
                if quant:
                    own_q = bytearray(_quant.quant_nbytes(counts[sc], block))
                    seg = acc[offs[sc]:offs[sc] + counts[sc]]
                    _quant.quantize_into(seg, memoryview(own_q), block)
                    # Every rank must end with the SAME values: replace the
                    # owner's chunk with the image of what it shipped.
                    seg[:] = _quant.dequantize(memoryview(own_q), counts[sc], block)
                    payload = own_q
                else:
                    payload = memoryview(buf)[offs[sc] * item:(offs[sc] + counts[sc]) * item]
            else:
                payload = ag_bufs[s - 1]  # forward last step's landing verbatim
            await ring._send_step(ctr, _AG, s, payload, "allreduce")
            await ring._await_parts(ctr, steps[W - 1 + s], deadline, "allgather frame")
            rc = (r - s) % W
            if quant:
                acc[offs[rc]:offs[rc] + counts[rc]] = _quant.dequantize(
                    memoryview(ag_bufs[s]), counts[rc], block)
            _bytes_total.inc(len(ag_bufs[s]), tags={"op": "allreduce", "side": "recv"})
        return buf

    return await _fail_loud(ring, ctr, pending, body())


async def _reducescatter(ring: _Ring, ctr: int, buf: bytearray, dtype,
                         n_per_slice: int, op: str, timeout: float) -> bytearray:
    """Ring reduce-scatter of a [W, ...] stack: chunk c of the ring carries
    stack slice (c-1) % W so rank r (which ends owning ring chunk
    (r+1) % W) finishes with its OWN slice r fully reduced."""
    W, r = ring.world, ring.rank
    deadline = time.monotonic() + timeout
    item = _dt.itemsize(dtype)
    acc = _dt.from_bytes(buf, dtype)
    pending: list = []

    def chunk_seg(c: int):
        sl = (c - 1) % W
        return acc[sl * n_per_slice:(sl + 1) * n_per_slice]

    def chunk_mv(c: int):
        sl = (c - 1) % W
        return memoryview(buf)[sl * n_per_slice * item:(sl + 1) * n_per_slice * item]

    async def body():
        rs_bufs, steps = [], []
        for s in range(W - 1):
            b = bytearray(n_per_slice * item)
            rs_bufs.append(b)
            parts = ring._register(ctr, _RS, s, b)
            pending.extend(parts)
            steps.append(parts)
        meta = {"op": "reducescatter", "red": op, "dtype": dtype,
                "n": n_per_slice}
        await ring._handshake(ctr, meta, sends=True, recvs=True,
                              deadline=deadline, opname="reducescatter")
        for s in range(W - 1):
            sc = (r - s) % W
            await ring._send_step(ctr, _RS, s, chunk_mv(sc), "reducescatter")
            await ring._await_parts(ctr, steps[s], deadline, "reduce-scatter frame")
            rc = (r - s - 1) % W
            incoming = _dt.from_bytes(rs_bufs[s], dtype)
            _combine_into(chunk_seg(rc), incoming, op)
            _bytes_total.inc(len(rs_bufs[s]), tags={"op": "reducescatter", "side": "recv"})
        return buf

    return await _fail_loud(ring, ctr, pending, body())


async def _allgather(ring: _Ring, ctr: int, buf: bytearray, dtype, n: int,
                     timeout: float) -> bytearray:
    """buf is W*n elements; this rank's slice [r] is filled in, the rest
    arrive around the ring (W-1 forwarding steps)."""
    W, r = ring.world, ring.rank
    deadline = time.monotonic() + timeout
    item = _dt.itemsize(dtype)
    pending: list = []

    def slice_mv(c: int):
        return memoryview(buf)[c * n * item:(c + 1) * n * item]

    async def body():
        steps = []
        for s in range(W - 1):
            rc = (r - s - 1) % W
            parts = ring._register(ctr, _AG, s, slice_mv(rc))
            pending.extend(parts)
            steps.append(parts)
        meta = {"op": "allgather", "dtype": dtype, "n": n}
        await ring._handshake(ctr, meta, sends=True, recvs=True,
                              deadline=deadline, opname="allgather")
        for s in range(W - 1):
            sc = (r - s) % W
            await ring._send_step(ctr, _AG, s, slice_mv(sc), "allgather")
            await ring._await_parts(ctr, steps[s], deadline, "allgather frame")
            _bytes_total.inc(n * item, tags={"op": "allgather", "side": "recv"})
        return buf

    return await _fail_loud(ring, ctr, pending, body())


async def _reduce_line(ring: _Ring, ctr: int, buf: bytearray, dtype, n: int,
                       op: str, dst: int, timeout: float) -> Optional[bytearray]:
    """Pipelined line reduction ending at dst: succ(dst) contributes first;
    each rank adds its own tensor to the arriving partial and forwards;
    dst absorbs the last hop. Non-dst ranks return None."""
    W, r = ring.world, ring.rank
    deadline = time.monotonic() + timeout
    item = _dt.itemsize(dtype)
    acc = _dt.from_bytes(buf, dtype)
    first = (dst + 1) % W
    receives = r != first
    sends = r != dst
    counts, offs = _split(n, min(W, max(1, n)))  # pipeline parts (reuse splitter)
    pending: list = []

    async def body():
        steps = []
        tmp = bytearray(n * item) if receives else None
        if receives:
            for s, c in enumerate(counts):
                mv = memoryview(tmp)[offs[s] * item:(offs[s] + c) * item]
                parts = ring._register(ctr, _RS, s, mv)
                pending.extend(parts)
                steps.append(parts)
        meta = {"op": "reduce", "red": op, "dtype": dtype, "n": n,
                "dst": dst}
        await ring._handshake(ctr, meta, sends=sends, recvs=receives,
                              deadline=deadline, opname="reduce")
        tarr = _dt.from_bytes(tmp, dtype) if receives else None
        for s, c in enumerate(counts):
            if receives:
                await ring._await_parts(ctr, steps[s], deadline, "reduce frame")
                _combine_into(acc[offs[s]:offs[s] + c],
                              tarr[offs[s]:offs[s] + c], op)
                _bytes_total.inc(c * item, tags={"op": "reduce", "side": "recv"})
            if sends:
                await ring._send_step(
                    ctr, _RS, s,
                    memoryview(buf)[offs[s] * item:(offs[s] + c) * item],
                    "reduce")
        return buf if r == dst else None

    return await _fail_loud(ring, ctr, pending, body())


async def _broadcast(ring: _Ring, ctr: int, buf: Optional[bytearray],
                     meta: Optional[dict], src: int,
                     timeout: float) -> tuple:
    """Pipelined line broadcast src -> ... -> pred(src). Non-src ranks learn
    (dtype, n) from a meta notify that flows down the chain ahead of the
    data. Returns (buf, meta) — non-src callers build their array from it."""
    W, r = ring.world, ring.rank
    deadline = time.monotonic() + timeout
    receives = r != src
    sends = ring.succ != src
    pending: list = []

    async def body():
        nonlocal buf, meta
        if receives:
            await ring._wait_or_abort(
                ctr, ring._meta_evt(ctr).wait(), deadline,
                f"broadcast metadata from rank {ring.pred} never arrived")
            meta = ring.metas[ctr]
            buf = bytearray(meta["nbytes"])
        item_counts, item_offs = _split(meta["nbytes"], min(W, max(1, meta["nbytes"])))
        steps = []
        if receives:
            for s, c in enumerate(item_counts):
                mv = memoryview(buf)[item_offs[s]:item_offs[s] + c]
                parts = ring._register(ctr, _AG, s, mv)
                pending.extend(parts)
                steps.append(parts)
        if sends:
            ring.succ_conn.notify_soon("collective_ring_meta", {
                "group": ring.group, "boot": ring.boot, "epoch": ring.epoch,
                "ctr": ctr, "meta": meta})
        await ring._handshake(ctr, None, sends=sends, recvs=receives,
                              deadline=deadline, opname="broadcast")
        for s, c in enumerate(item_counts):
            if receives:
                await ring._await_parts(ctr, steps[s], deadline, "broadcast frame")
                _bytes_total.inc(c, tags={"op": "broadcast", "side": "recv"})
            if sends:
                await ring._send_step(
                    ctr, _AG, s,
                    memoryview(buf)[item_offs[s]:item_offs[s] + c],
                    "broadcast")
        return buf, meta

    return await _fail_loud(ring, ctr, pending, body())
