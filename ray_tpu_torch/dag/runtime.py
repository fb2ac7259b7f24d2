"""Worker-side compiled-DAG runtime: stage tables + push-driven execution.

Reference: the per-actor exec loops of compiled graphs
(compiled_dag_node.py:186 ``do_exec_tasks`` + shared-memory/NCCL channels).
Redesign: instead of a blocking loop per actor reading channels, arrival of
the LAST input for (stage, seq) schedules the stage's method on the actor's
executor; the result is pushed straight to the downstream workers (or the
driver). Values move as serialized blobs over the direct worker-to-worker
connections — never through the object store or the driver.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.util import tracing as _tracing


def resolve_actor_addr(core, actor_handle) -> str:
    """Worker address hosting an actor (blocks until ALIVE)."""
    info = core._run(core.controller.call("wait_actor_alive", {"actor_id": actor_handle._actor_id.binary()}))
    if info is None or info["state"] == "DEAD":
        raise RuntimeError(f"actor {actor_handle._actor_id.hex()[:8]} is not alive")
    return info["worker_addr"]


def dag_result(core, p):
    """Driver-side: resolve the future for (dag_id, seq) (delegated from
    CoreWorker.handle_dag_result)."""
    dag = getattr(core, "_dags", {}).get(p["dag_id"])
    if dag is not None:
        value = serialization.deserialize(p["blob"])
        dag._deliver(p["seq"], value)
    return True


def register_dag(core, dag):
    if not hasattr(core, "_dags"):
        core._dags = {}
    core._dags[dag.dag_id] = dag


class _StageState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.pending: dict[int, dict[int, Any]] = {}  # seq -> slot -> value/err
        self.trace: dict[int, tuple] = {}  # seq -> propagated (trace_id, span_id)


def _dag_tables(core):
    if not hasattr(core, "_dag_stages"):
        core._dag_stages = {}
    return core._dag_stages


def dag_setup(core, spec: dict):
    _dag_tables(core)[(spec["dag_id"], spec["stage_id"])] = _StageState(spec)
    return True


def dag_teardown(core, p):
    stages = _dag_tables(core)
    for key in [k for k in stages if k[0] == p["dag_id"]]:
        del stages[key]
    # Unacked zero-copy edge values of this dag: drop producer pins, reap.
    from ray_tpu_torch.core.ids import ObjectID

    out = _shm_out(core)
    for oid_b in [o for o, e in out.items() if e["dag_id"] == p["dag_id"]]:
        entry = out.pop(oid_b)
        entry["buffer"] = None
        oid = ObjectID(oid_b)
        if core.store is not None and not core.store.reap(oid):
            core._shm_garbage.append(oid)
    return True


async def dag_push(core, conn, p):
    """An upstream value (or error) arrived for (stage, seq, slot)."""
    stages = _dag_tables(core)
    st = stages.get((p["dag_id"], p["stage_id"]))
    if st is None:
        return False  # torn down
    seq = p["seq"]
    slot_map = st.pending.setdefault(seq, {})
    if "tc" in p:
        # Fan-in stages may receive one context per input; keep the first
        # (stable within a run) rather than last-writer-wins re-parenting.
        st.trace.setdefault(seq, p["tc"])
    if "shm_oid" in p:
        slot_map[p["slot"]] = (_ShmValue(p["shm_oid"], conn), p["is_error"])
    else:
        slot_map[p["slot"]] = (p["blob"], p["is_error"])
    if len(slot_map) < st.spec["n_inputs"]:
        return True
    del st.pending[seq]
    # Strong ref until the stage completes: a GC cycle mid-await would kill
    # an unreferenced stage task — its seq never emits downstream and the
    # whole DAG run wedges (bg-strong-ref; core's registry holds it).
    core._spawn_bg(_run_stage(core, st.spec, seq, slot_map, st.trace.pop(seq, None)))
    return True


class _ShmValue:
    """Marker for an input riding the shared arena: oid + the producer conn
    to ack on once the stage has consumed it."""

    __slots__ = ("oid", "conn")

    def __init__(self, oid: bytes, conn):
        self.oid = oid
        self.conn = conn


async def _run_stage(core, spec: dict, seq: int, slot_map: dict, tc=None):
    # Error propagation: any errored input short-circuits the stage — but
    # shm-riding inputs must still be acked or their producer pins leak.
    err_blob = next((blob for blob, is_err in slot_map.values() if is_err), None)
    if err_blob is not None:
        for blob, _ in slot_map.values():
            if isinstance(blob, _ShmValue):
                try:
                    await blob.conn.notify("dag_shm_ack", {"oid": blob.oid})
                except Exception:
                    pass
        await _emit(core, spec, seq, err_blob, is_error=True, tc=tc)
        return
    exec_ctx = None
    t_start = 0.0
    if tc is not None:
        # One span per stage execution, child of the upstream context; its
        # id propagates downstream so the chain stays parent-linked. The
        # span event is recorded in the finally below (the stage method runs
        # on a pool thread; exec_ctx is activated inside that thread).
        exec_ctx = (tc[0], _tracing.new_span_id())
        t_start = time.time()
    runtime = core._actor_runtime
    acks: list[_ShmValue] = []
    try:
        if runtime is None or runtime.spec.actor_id != ActorID(spec["actor_id"]):
            raise RuntimeError("dag stage actor is not hosted on this worker")
        from ray_tpu_torch.core.ids import ObjectID

        # Register ALL shm inputs for acking up front: if one slot's read or
        # deserialize fails, the others' producer pins must still be released
        # (an unacked pin survives until dag teardown otherwise).
        acks.extend(b for b, _ in slot_map.values() if isinstance(b, _ShmValue))
        values = {}
        for slot, (blob, _) in slot_map.items():
            if isinstance(blob, _ShmValue):
                pinned = core.store.get_pinned(ObjectID(blob.oid))
                if pinned is None:
                    raise RuntimeError("dag shm value lost before consumption")
                values[slot] = serialization.deserialize(pinned)
            else:
                values[slot] = serialization.deserialize(blob)
        args = [values[a[1]] if a[0] == "slot" else a[1] for a in spec["arg_layout"]]
        method = getattr(runtime.instance, spec["method"])
        loop = asyncio.get_running_loop()
        if asyncio.iscoroutinefunction(method):
            # Same max_concurrency gate as ActorRuntime.execute — pipelined
            # seqs must not exceed the actor's declared concurrency.
            async with runtime.sem:
                token = _tracing.activate(exec_ctx)
                try:
                    result = await method(*args)
                finally:
                    _tracing.deactivate(token)
        else:
            # The actor's own pool: respects its max_concurrency semantics.
            def _call():
                token = _tracing.activate(exec_ctx)
                try:
                    return method(*args)
                finally:
                    _tracing.deactivate(token)

            result = await loop.run_in_executor(runtime.pool, _call)
        blob, _ = serialization.serialize(result)
        await _emit(core, spec, seq, blob, is_error=False, tc=exec_ctx)
    except BaseException as e:  # noqa: BLE001 — ships to the driver
        err = serialization.RemoteError.from_exception(e, where=f"dag stage {spec['method']}")
        blob, _ = serialization.serialize(err.cause if err.cause is not None else err)
        await _emit(core, spec, seq, blob, is_error=True, tc=exec_ctx)
    finally:
        if exec_ctx is not None:
            core._event("span", name=f"dag.{spec['method']}", trace_id=exec_ctx[0],
                        span_id=exec_ctx[1], parent_id=tc[1], ts=t_start,
                        dur=time.time() - t_start)
        for sv in acks:
            try:
                await sv.conn.notify("dag_shm_ack", {"oid": sv.oid})
            except Exception:
                pass


async def _same_arena(core, addr: str) -> bool:
    """True when the peer worker maps the same shm arena (same node) —
    cached per address. Positive answers cache forever (arena identity is
    stable); a failed probe caches negative only briefly, so a transient
    startup race cannot disable the zero-copy path for the process
    lifetime."""
    import time as _time

    cache = getattr(core, "_same_store_cache", None)
    if cache is None:
        cache = core._same_store_cache = {}
    hit = cache.get(addr)
    if hit is not None:
        same, expires = hit
        if same or expires is None or _time.monotonic() < expires:
            return same
    if core.store is None:
        cache[addr] = (False, None)  # no arena at all: permanent
        return False
    try:
        conn = await core._peer_conn(addr)
        peer_path = await conn.call("store_path", {})
        same = bool(peer_path) and peer_path == core.store.path
        cache[addr] = (same, None)  # definitive answer from the peer
    except Exception:
        same = False
        cache[addr] = (False, _time.monotonic() + 15.0)  # re-probe later
    return same


async def _emit(core, spec: dict, seq: int, blob: bytes, is_error: bool, tc=None):
    """Ship a stage output downstream. Same-node edges with large payloads
    ride the shared-memory arena zero-copy (the mutable-plasma channel
    equivalent — reference: experimental/channel/shared_memory_channel.py):
    one scatter-write into shm by the producer, consumers deserialize
    ndarrays directly over the pinned pages; the producer holds a pin until
    the consumer acks, then the transient object is deleted (deferred while
    consumer views keep it pinned). Cross-node / small payloads ship inline
    in the notify frame."""
    from ray_tpu_torch.core.ids import ObjectID

    # One arena write serves every same-node consumer (fan-out of k shares a
    # single object; the producer pin drops after k acks) — duplicating the
    # payload per edge would multiply both the memcpy and capacity pressure.
    shm_targets = []
    if not is_error and core.store is not None and len(blob) > core.config.max_inline_object_size:
        for tgt in spec["downstream"]:
            if await _same_arena(core, tgt[0]):
                shm_targets.append(tgt)
    shm_oid = None
    if shm_targets:
        oid = ObjectID.from_put()
        try:
            buf, evicted = core.store.create_autoevict(oid, len(blob))
            buf[:] = blob
            del buf
            # Atomic seal+pin: no unpinned window in which a concurrent
            # arena client's eviction could reap the value before consumers
            # read it (the producer pin survives until the last ack).
            pinned = core.store.seal_pinned(oid)
            if evicted:
                await core._report_evicted(evicted)
            if pinned is not None:
                _shm_out(core)[oid.binary()] = {
                    "dag_id": spec["dag_id"],
                    "buffer": pinned,
                    "acks_left": len(shm_targets),
                }
                shm_oid = oid.binary()
                _shm_edge_counter().inc(len(shm_targets))
        except Exception:
            shm_oid = None  # arena full: everything falls back to frames

    for addr, stage, slot in spec["downstream"]:
        conn = await core._peer_conn(addr)
        msg = {"dag_id": spec["dag_id"], "stage_id": stage, "seq": seq, "slot": slot, "is_error": is_error}
        if tc is not None:
            msg["tc"] = tc
        if shm_oid is not None and (addr, stage, slot) in shm_targets:
            msg["shm_oid"] = shm_oid
        else:
            msg["blob"] = blob
        await conn.notify("dag_push", msg)
    if spec["to_driver"]:
        conn = await core._peer_conn(spec["to_driver"])
        await conn.notify("dag_result", {"dag_id": spec["dag_id"], "seq": seq, "blob": blob})


_shm_edges = None


def _shm_edge_counter():
    global _shm_edges
    if _shm_edges is None:
        from ray_tpu_torch.util.metrics import Counter

        _shm_edges = Counter("dag_shm_edges", "dag values shipped via the shared arena")
    return _shm_edges


def _shm_out(core) -> dict:
    if not hasattr(core, "_dag_shm_out"):
        core._dag_shm_out = {}
    return core._dag_shm_out


def dag_shm_ack(core, p):
    """Producer side: a consumer finished its stage. The last ack drops the
    producer pin and reaps the transient object (deferred to the reaper
    while consumer value-views still pin it; reap() distinguishes pinned
    from already-gone, so late/duplicate acks cannot loop forever)."""
    out = _shm_out(core)
    entry = out.get(p["oid"])
    if entry is not None:
        entry["acks_left"] -= 1
        if entry["acks_left"] > 0:
            return True
        del out[p["oid"]]
        entry["buffer"] = None  # drop the producer pin
    from ray_tpu_torch.core.ids import ObjectID

    oid = ObjectID(p["oid"])
    if core.store is not None and not core.store.reap(oid):
        core._shm_garbage.append(oid)
    return True
