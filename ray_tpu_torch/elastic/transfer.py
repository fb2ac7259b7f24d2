"""Live state transfer: reshard byte runs shipped host-to-host over the
raw-frame RPC lane.

The sending side parks a consistent snapshot of its live train state in a
process-local export table (``export_state``); receivers compute their
target rectangles, plan exact-once multi-source runs (elastic/plan.py) and
pull each run peer-to-peer with the SAME zero-pickle machinery the object-
transfer plane trusts: landing buffers pre-registered per chunk key
(``Connection.expect_raw``), payload written straight from the exporter's
array memoryview (``send_raw`` — never pickled, MAC'd on the wire when auth
is on), one tiny control RPC per (source, batch of runs). No blob store,
no disk, no coordinator in the data path.

Failure semantics: a dead/failing source fails only ITS runs — the puller
re-plans the uncovered byte intervals against the remaining sources
(replicated paths re-cover from any survivor; a sharded window whose only
holder died is a typed :class:`ElasticTransferError`, never a hang and
never zeros-as-weights). Chaos site ``elastic.reshard.transfer`` injects
exactly these losses deterministically (scenario ``elastic_preempt``).
"""
from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch import chaos as _chaos
from ray_tpu_torch.elastic import plan as _plan
from ray_tpu_torch.util import dtypes as _dt
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing


class ElasticTransferError(RuntimeError):
    """Typed live-reshard failure: uncoverable destination bytes, a lost
    source mid-transfer with no alternate, or a transfer deadline. Callers
    (train controller) fall back to the checkpoint-restore path."""


_mbs_gauge = _metrics.Gauge(
    "elastic.reshard.mb_s", "last live-reshard receive throughput (MB/s)")
_bytes_total = _metrics.Counter(
    "elastic.reshard.bytes", "live-reshard bytes moved",
    tag_keys=("side",))  # wire_in | wire_out | local
_failover_total = _metrics.Counter(
    "elastic.reshard.failover",
    "pull sources dropped mid-reshard (runs re-planned onto alternates)")
_exports_evicted = _metrics.Counter(
    "elastic.exports.evicted",
    "parked state exports evicted by the capacity cap before release")

# tid -> _Export. Bounded: a controller that crashes between export and
# release must not pin old gangs' snapshots forever.
_EXPORTS: dict = {}
_EXPORT_CAP = 8
_LOCK = threading.Lock()


class _Export:
    """One parked snapshot: contiguous byte views of every path, plus the
    wire-format metadata receivers plan against."""

    def __init__(self, rank: int, seq: int, arrays: dict, paths: dict,
                 meta: dict):
        self.rank = rank
        self.seq = seq
        self.arrays = arrays          # path -> contiguous host array (a private copy)
        self.views = {p: _dt.byte_view(a) for p, a in arrays.items()}
        self.paths = paths            # path -> {shape,dtype,kind,n,rect}
        self.meta = meta
        self.created = time.monotonic()


def _frame_key(tid: str, dst_rank: int, path: str, dst_off: int,
               part: int) -> bytes:
    # tid is a fresh uuid per resize attempt, so keys can never alias a
    # stale transfer; dst_off uniquely names the run (runs are disjoint in
    # destination byte space by the exact-once plan invariant).
    return hashlib.blake2b(
        b"%s:%d:%s:%d:%d" % (tid.encode(), dst_rank, path.encode(), dst_off,
                             part),
        digest_size=12, person=b"raytpu-elast").digest()


def export_state(tid: str, rank: int, replicated: dict,
                 sharded: Optional[dict] = None, *, seq: int = 0,
                 meta: Optional[dict] = None, copy: bool = True) -> dict:
    """Park a snapshot for transfer ``tid`` and return its wire metadata.

    ``replicated``: {path: array} — every rank holds the full array (rect =
    whole shape). ``sharded``: {path: (flat_1d_array, lo, n_total)} — this
    rank holds [lo, lo+len) of a logical length-``n_total`` flat array (the
    grad_sync optimizer windows).

    Leaves are numpy arrays or torch tensors (CPU or CUDA); a CUDA leaf
    crosses to the host here. Every leaf is parked as a private host copy,
    whatever ``copy`` says: torch updates train state in place, so a parked
    reference could be torn by the next step while receivers pull from it.
    ``copy=False`` keeps the reference's signature (there it parks
    references to immutable jax leaves, whose host transfer already yields
    a fresh buffer)."""
    arrays: dict = {}
    paths: dict = {}
    for path, a in (replicated or {}).items():
        arr = _private_host(a)
        shape = arr.shape  # BEFORE any ravel: 0-d stays 0-d
        arrays[path] = arr
        paths[path] = {"kind": "replicated", "shape": [int(d) for d in shape],
                       "dtype": _dt.dtype_name(arr.dtype),
                       "rect": [[0, int(d)] for d in shape]}
    for path, (a, lo, n) in (sharded or {}).items():
        arr = _private_host(a).reshape(-1)
        size = int(arr.shape[0])
        arrays[path] = arr
        paths[path] = {"kind": "window", "shape": [int(n)],
                       "dtype": _dt.dtype_name(arr.dtype), "n": int(n),
                       "rect": [[int(lo), int(lo) + size]]}
    exp = _Export(rank, seq, arrays, paths, dict(meta or {}))
    with _LOCK:
        _EXPORTS[tid] = exp
        while len(_EXPORTS) > _EXPORT_CAP:
            _EXPORTS.pop(next(iter(_EXPORTS)))
            _exports_evicted.inc(1)
    return {"rank": rank, "seq": seq, "paths": paths, "meta": exp.meta}


def _private_host(leaf):
    """A C-contiguous host copy of ``leaf`` that shares no memory with it:
    numpy, or a CPU torch tensor for bfloat16."""
    arr = _dt.host_array(leaf)
    if _dt.is_tensor(leaf) and leaf.device.type != "cpu":
        return arr  # the device-to-host copy is already private
    return arr.clone() if _dt.is_tensor(arr) else np.array(arr, copy=True)


def release(tid: str) -> bool:
    with _LOCK:
        return _EXPORTS.pop(tid, None) is not None


def local_export(tid: str) -> Optional[_Export]:
    with _LOCK:
        return _EXPORTS.get(tid)


# ---------------------------------------------------------------------------
# Source side: the worker RPC handler (runs on the worker IO loop)
# ---------------------------------------------------------------------------


async def fetch(core, conn, p: dict) -> dict:
    """Serve one receiver's batch of runs out of a parked export: slice the
    live array views and ship each run chunked over the raw lane. The reply
    lands after the last frame is on the wire, so a receiver whose frames
    all arrived sees its expect_raw futures resolve before the call does."""
    tid = p["tid"]
    dst = int(p["dst"])
    token = _tracing.activate(tuple(p["tc"])) if p.get("tc") else None
    try:
        return await _fetch_inner(core, conn, p, tid, dst)
    finally:
        _tracing.deactivate(token)


async def _fetch_inner(core, conn, p: dict, tid: str, dst: int) -> dict:
    with _LOCK:
        exp = _EXPORTS.get(tid)
    if exp is None:
        return {"ok": False, "error": f"unknown/released transfer {tid!r}"}
    part_bytes = max(1, int(core.config.elastic_part_bytes))
    sent = 0
    for item in p["items"]:
        view = exp.views.get(item["path"])
        if view is None:
            return {"ok": False,
                    "error": f"path {item['path']!r} not in export {tid!r}"}
        off, nbytes, dst_off = int(item["src_off"]), int(item["nbytes"]), int(
            item["dst_off"])
        if off < 0 or off + nbytes > len(view):
            return {"ok": False,
                    "error": f"run {off}+{nbytes} exceeds {item['path']!r} "
                             f"({len(view)} bytes)"}
        mv = view[off:off + nbytes]
        nparts = max(1, (nbytes + part_bytes - 1) // part_bytes)
        for pi in range(nparts):
            sl = mv[pi * part_bytes: min((pi + 1) * part_bytes, nbytes)]
            fault = _chaos.maybe_inject(
                "elastic.reshard.transfer", tid=tid[:8], path=item["path"],
                src=str(exp.rank), dst=str(dst), part=f"{dst_off}.{pi}")
            if fault is not None:
                if fault.kind == "drop":
                    # Frame never reaches the wire: the receiver's part
                    # deadline trips and it re-plans onto an alternate.
                    continue
                if fault.kind == "error":
                    return {"ok": False, "error": str(fault.error("mid-fetch"))}
                if fault.kind == "delay":
                    await asyncio.sleep(fault.delay_s)
            await conn.send_raw(
                _frame_key(tid, dst, item["path"], dst_off, pi), sl)
            sent += len(sl)
    _bytes_total.inc(sent, tags={"side": "wire_out"})
    return {"ok": True, "bytes": sent}


# ---------------------------------------------------------------------------
# Receiver side
# ---------------------------------------------------------------------------


def _dst_rect(info: dict, world: int, rank: int) -> list:
    if info["kind"] == "window":
        return _plan.window_rect(int(info["n"]), world, rank)
    return [[0, int(d)] for d in info["shape"]]


def _path_table(sources: list) -> dict:
    """Fold per-source metadata into {path: (info, {src_rank: rect})},
    failing loud on shape/dtype disagreement between sources."""
    table: dict = {}
    for src in sources:
        for path, info in src["paths"].items():
            ent = table.get(path)
            if ent is None:
                table[path] = (info, {src["rank"]: info["rect"]})
                continue
            base = ent[0]
            if (base["shape"] != info["shape"]
                    or base["dtype"] != info["dtype"]
                    or base["kind"] != info["kind"]):
                raise ElasticTransferError(
                    f"sources disagree on {path!r}: "
                    f"{base['shape']}/{base['dtype']} vs "
                    f"{info['shape']}/{info['dtype']}")
            ent[1][src["rank"]] = info["rect"]
    return table


async def _pull_from_source(core, addr: str, tid: str, dst_rank: int,
                            runs: list, bufs: dict, part_bytes: int,
                            timeout: float) -> int:
    """Pull one source's runs: register every landing slice, fire the fetch
    RPC, await the frames. Returns wire bytes received; raises on any loss
    (the caller re-plans the whole source's runs onto alternates)."""
    conn = await core._peer_conn(addr)
    pending: list = []
    # Same envelope as the control RPC's wait (timeout + grace): the frames
    # land concurrently with the call, so a source that answers inside the
    # grace window must not have its already-landed frames failed.
    deadline = time.monotonic() + timeout + 5.0
    try:
        for r in runs:
            mv = memoryview(bufs[r.path])[r.dst_off:r.dst_off + r.nbytes]
            nparts = max(1, (r.nbytes + part_bytes - 1) // part_bytes)
            for pi in range(nparts):
                sl = mv[pi * part_bytes: min((pi + 1) * part_bytes, r.nbytes)]
                k = _frame_key(tid, dst_rank, r.path, r.dst_off, pi)
                pending.append((k, conn.expect_raw(k, sl)))
        payload = {
            "tid": tid, "dst": dst_rank,
            "items": [{"path": r.path, "src_off": r.src_off,
                       "dst_off": r.dst_off, "nbytes": r.nbytes}
                      for r in runs],
        }
        tc = _tracing.current_trace()
        if tc is not None:
            payload["tc"] = tc  # source-side frames join the reshard trace
        reply = await asyncio.wait_for(
            conn.call("elastic_fetch", payload, timeout=timeout),
            timeout + 5.0)
        if not reply.get("ok"):
            raise ElasticTransferError(
                f"source {addr} failed fetch: {reply.get('error')}")
        for k, fut in pending:
            if fut.done():
                ok = fut.result()  # landed frames count even past deadline
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ElasticTransferError(
                        f"reshard pull from {addr} timed out ({timeout}s)")
                ok = await asyncio.wait_for(fut, remaining)
            if not ok:
                raise ElasticTransferError(
                    f"reshard frame from {addr} lost (connection dropped or "
                    "frame rejected)")
        return sum(r.nbytes for r in runs)
    except (asyncio.TimeoutError, ConnectionError, OSError) as e:
        raise ElasticTransferError(
            f"reshard pull from {addr} failed: {type(e).__name__}: {e}") from e
    finally:
        for k, fut in pending:
            if not fut.done():
                conn.unexpect_raw(k)


async def pull_state(core, tid: str, sources: list, world: int, rank: int,
                     *, self_rank: Optional[int] = None,
                     timeout: Optional[float] = None) -> dict:
    """Assemble this rank's slice of the parked state from every source's
    live export. ``sources``: export metadata dicts, each carrying ``rank``,
    ``addr`` and ``paths`` (see export_state). ``self_rank``: this worker's
    OLD rank when it holds its own export (those runs are local memcpys and
    never touch the wire).

    Returns {"state", "sharded", "meta", "seq", "stats"}; raises
    ElasticTransferError when the surviving sources cannot cover the
    destination."""
    timeout = (core.config.elastic_transfer_timeout_s
               if timeout is None else timeout)
    part_bytes = max(1, int(core.config.elastic_part_bytes))
    by_rank = {s["rank"]: s for s in sources}
    table = _path_table(sources)
    t0 = time.perf_counter()
    # Source preference: self first (free local copies), then peers rotated
    # by our rank so concurrent pullers hit different sources first.
    order: list = []
    if self_rank is not None and self_rank in by_rank:
        order.append(self_rank)
    order += [r for r in _plan.rotated(by_rank, rank) if r not in order]

    bufs: dict = {}
    rects: dict = {}
    pending_runs: dict = {}  # src_rank -> [Run]
    uncovered_by_path: dict = {}
    for path, (info, src_rects) in sorted(table.items()):
        rect = _dst_rect(info, world, rank)
        rects[path] = rect
        itemsize = _dt.itemsize(info["dtype"])
        bufs[path] = bytearray(_plan.rect_nbytes(rect, itemsize))
        uncovered_by_path[path] = None  # full region on the first plan pass
    alive = list(order)
    wire_in = local = 0
    failures: list = []
    with _tracing.span("elastic.reshard", tid=tid[:8], world=world, rank=rank):
        while True:
            pending_runs.clear()
            try:
                for path, (info, src_rects) in sorted(table.items()):
                    itemsize = _dt.itemsize(info["dtype"])
                    runs = _plan.plan_pull(
                        path, info["shape"] or None, itemsize,
                        {r: src_rects[r] for r in alive if r in src_rects},
                        rects[path], [r for r in alive],
                        uncovered=uncovered_by_path[path])
                    for r in runs:
                        pending_runs.setdefault(r.src_rank, []).append(r)
            except _plan.CoverageError as e:
                raise ElasticTransferError(
                    f"live reshard uncoverable after source failures "
                    f"{failures or ''}: {e}") from None
            # Local runs first (free), then one pull RPC per remote source.
            my_runs = pending_runs.pop(self_rank, []) if self_rank is not None else []
            exp = local_export(tid) if my_runs else None
            for r in my_runs:
                if exp is None or r.path not in exp.views:
                    # Our own export vanished (evicted): treat as failed src.
                    pending_runs.setdefault(r.src_rank, []).append(r)
                    continue
                memoryview(bufs[r.path])[r.dst_off:r.dst_off + r.nbytes] = \
                    exp.views[r.path][r.src_off:r.src_off + r.nbytes]
                local += r.nbytes
            failed: dict = {}

            async def one_source(src_rank: int, runs: list) -> int:
                addr = by_rank[src_rank].get("addr")
                if not addr:
                    raise ElasticTransferError(
                        f"source rank {src_rank} has no transport address")
                return await _pull_from_source(
                    core, addr, tid, rank, runs, bufs, part_bytes, timeout)

            # All sources stream concurrently (disjoint landing buffers by
            # the exact-once plan invariant); one failure only fails ITS
            # runs.
            items = list(pending_runs.items())
            results = await asyncio.gather(
                *(one_source(sr, runs) for sr, runs in items),
                return_exceptions=True)
            for (src_rank, runs), got in zip(items, results):
                if isinstance(got, ElasticTransferError):
                    failed[src_rank] = (runs, str(got))
                elif isinstance(got, BaseException):
                    raise got
                else:
                    wire_in += got
            if not failed:
                break
            # Re-plan every failed source's destination intervals against
            # the survivors (replication recovers; lost windows fail loud).
            # Paths with no failed runs this round are fully landed — an
            # empty interval list makes the next plan pass skip them.
            _failover_total.inc(len(failed))
            retry: dict = {path: [] for path in table}
            for src_rank, (runs, why) in failed.items():
                _tracing.event("elastic.reshard.failover", src=src_rank,
                               why=why[:120])
                failures.append(src_rank)
                alive = [r for r in alive if r != src_rank]
                for r in runs:
                    retry[r.path].append((r.dst_off, r.dst_off + r.nbytes))
            uncovered_by_path = retry
    elapsed = time.perf_counter() - t0
    total = wire_in + local
    if elapsed > 0:
        _mbs_gauge.set(total / 1e6 / elapsed)
    if wire_in:
        _bytes_total.inc(wire_in, tags={"side": "wire_in"})
    if local:
        _bytes_total.inc(local, tags={"side": "local"})
    state: dict = {}
    sharded: dict = {}
    for path, (info, _r) in table.items():
        # Zero-copy view over the landing buffer (read-only, like the old
        # bytes() path, but without doubling the resumed-state footprint at
        # the end of the reshard critical path — consumers copy anyway). A
        # bfloat16 path comes back as a CPU torch tensor over the buffer.
        if info["dtype"] == "bfloat16":
            arr = _dt.from_bytes(bufs[path], "bfloat16")
        else:
            arr = np.frombuffer(memoryview(bufs[path]).toreadonly(),
                                dtype=np.dtype(info["dtype"]))
        if info["kind"] == "window":
            lo, hi = rects[path][0]
            sharded[path] = (arr, int(lo), int(info["n"]))
        else:
            shape = tuple(info["shape"])
            state[path] = arr.reshape(shape) if shape else arr.reshape(())
    first = sources[0] if sources else {"meta": {}, "seq": 0}
    return {
        "state": state, "sharded": sharded, "meta": dict(first.get("meta") or {}),
        "seq": int(first.get("seq") or 0),
        "stats": {"bytes": total, "wire_bytes": wire_in, "local_bytes": local,
                  "elapsed_s": elapsed,
                  "mb_s": (total / 1e6 / elapsed) if elapsed > 0 else 0.0,
                  "failovers": len(failures)},
    }
