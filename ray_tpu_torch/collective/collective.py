"""Host-plane collectives: ring data path + named coordinator rendezvous.

Each group is a detached named actor (`raytpu_collective:<name>`) holding
per-round mailboxes; ranks rendezvous by name (reference: GroupManager +
named-actor rendezvous, collective.py:71). Ops are synchronous and round-
numbered per (group, op) so repeated calls pipeline correctly.

Two transports:

* ``ring`` (the default for world > 1): tensor bytes move rank-to-rank over
  peer worker RPC connections on the zero-pickle raw-frame lane — ring
  reduce-scatter + allgather, optional EQuARX-style int8 block quantization
  (see ring.py / quantize.py). The coordinator actor carries ONLY
  membership/epoch/rendezvous traffic; its own payload-byte counter
  (``get_stats``) proves no tensor byte transits it.
* ``coordinator`` (legacy/fallback, and always the rendezvous plane):
  values ride the pickled actor-call lane through the coordinator's
  mailboxes. O(world^2 * bytes) through one process — fine for barriers
  and small objects, wrong for gradient sync.

Reductions run on host memory: numpy, as in ``ray_tpu``, and CPU torch ops
for bfloat16, which numpy lacks (each add rounds to bfloat16, as ml_dtypes'
does in the reference). A torch input crosses to the host and its result
comes back as a tensor on the input's device.
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.util import dtypes as _dt

_GROUP_PREFIX = "raytpu_collective:"
# Reaped-round guard memory in the coordinator (see _GroupCoordinator
# ._consumed): enough to cover any realistic lost-reply retry window while
# keeping a step-per-second gang's footprint flat over unbounded epochs.
_CONSUMED_CAP = 4096
# Process-scoped registry (reference: GroupManager, collective.py:71). Actor
# methods may run on different pool threads, so thread-local scope would lose
# the group between calls.
_process_groups: dict = {}


def _payload_nbytes(v: Any) -> int:
    """Tensor-payload accounting for the coordinator shim: how many bulk
    bytes a mailbox value carries. Control scalars/strings count zero."""
    if isinstance(v, np.ndarray):
        return v.nbytes
    if isinstance(v, (bytes, bytearray, memoryview)):
        return len(v)
    if _dt.is_tensor(v):
        return v.numel() * v.element_size()
    return 0


class _GroupCoordinator:
    """Named actor: mailbox per (op, round). ALL methods are async so state
    access is single-threaded on the actor loop, and waiters park on
    asyncio.Events server-side — one RPC per rank per collective, no client
    polling (reference keeps data on NCCL and the actor for rendezvous only;
    here the ring transport keeps data on peer links the same way, and this
    actor counts every payload byte it is asked to carry so the zero-bytes
    invariant of the ring path is checkable at runtime)."""

    def __init__(self, world_size: int):
        import uuid

        # Instance id: rings key on it so a destroyed-and-recreated group
        # (whose epochs restart at 1) can never alias a stale ring.
        self.boot = uuid.uuid4().hex
        self.world_size = world_size
        self.rounds: dict[str, dict[int, Any]] = {}
        self.done: dict[str, Any] = {}
        self.acks: dict[str, set] = {}
        self._events: dict[str, "asyncio.Event"] = {}  # key -> completion event
        # Gang incarnation: an epoch is assigned only when world_size DISTINCT
        # ranks have entered the lobby (full-gang rendezvous), so all members
        # of a gang always agree on it and a restarted gang never reads
        # mailboxes left over from a dead one. A re-joining rank replaces its
        # stale lobby entry (the old process is presumed dead).
        self.epoch = 0
        self._lobby: dict[int, tuple] = {}  # rank -> (join id, worker addr)
        self._assigned: dict[str, int] = {}  # join id -> epoch
        self._join_event = asyncio.Event()
        # Worker RPC addresses of the current epoch's gang (ring rendezvous).
        self.ring_addrs: dict[int, Optional[str]] = {}
        # Payload-byte counting shim: bulk bytes contributed to (in) and
        # served from (out) this actor's mailboxes. The ring path must keep
        # both flat — asserted by tests, exposed for operators.
        self.stats = {"payload_in": 0, "payload_out": 0}
        # Keys whose mailbox was fully served and reaped (collect: dst
        # fetched; exchange/publish: every rank acked). A rank re-arming one
        # of these after a lost reply must not recreate a ghost box nobody
        # will ever complete — collect re-acks non-dst ranks, exchange/
        # publish fail loud (the values are gone). Insertion-ordered and
        # CAPPED (an epoch is unbounded in time — a gang calling barrier()
        # every step for 1M steps must not pin 1M keys in this detached
        # actor); evicting a key merely narrows the lost-reply guard to the
        # last _CONSUMED_CAP rounds, far beyond any reply-retry window.
        self._consumed: dict = {}  # key -> None (ordered-set semantics)
        self.consumed_evicted = 0

    async def get_world_size(self) -> int:
        return self.world_size

    async def get_stats(self) -> dict:
        return dict(self.stats)

    async def join_begin(self, rank: int, join_id: str,
                         address: Optional[str] = None) -> None:
        self._lobby[rank] = (join_id, address)
        if len(self._lobby) == self.world_size:
            self.epoch += 1
            # Clear mailboxes BEFORE publishing the epoch: once a rank can
            # observe it, its contributions must never be wiped.
            self.rounds.clear()
            self.done.clear()
            self.acks.clear()
            self._events.clear()
            self._consumed.clear()
            self.ring_addrs = {r: a for r, (_j, a) in self._lobby.items()}
            for jid, _addr in self._lobby.values():
                self._assigned[jid] = self.epoch
            self._lobby.clear()
            self._join_event.set()
            self._join_event = asyncio.Event()

    async def wait_epoch(self, join_id: str, timeout: float = 30.0) -> Optional[int]:
        """Park until the full gang has joined (or timeout); returns the
        epoch assigned to this join, or None to let the caller re-arm."""
        if join_id in self._assigned:
            return self._assigned[join_id]
        ev = self._join_event
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        return self._assigned.get(join_id)

    async def get_ring_info(self, epoch: int) -> Optional[dict]:
        """Ring rendezvous: the gang's worker addresses for ``epoch``.
        Returns None when the epoch is stale (a newer gang joined)."""
        if epoch != self.epoch:
            return None
        return {"addresses": dict(self.ring_addrs), "boot": self.boot}

    def _ev(self, key: str) -> "asyncio.Event":
        ev = self._events.get(key)
        if ev is None:
            ev = self._events[key] = asyncio.Event()
        return ev

    def _raise_reaped(self, key: str) -> None:
        """One fail-loud shape for every reaped-round re-arm: the values
        are gone, so parking the caller to its deadline (or busy re-arming)
        only delays the same outcome untyped."""
        from ray_tpu_torch.collective.ring import CollectiveError

        raise CollectiveError(
            f"collective round {key} already completed and was reaped; "
            "the reply to this rank was lost and cannot be recovered")

    def _mark_consumed(self, key: str) -> None:
        self._consumed[key] = None
        while len(self._consumed) > _CONSUMED_CAP:
            self._consumed.pop(next(iter(self._consumed)))
            self.consumed_evicted += 1

    def _contribute(self, key: str, rank: int, value: Any) -> dict:
        box = self.rounds.setdefault(key, {})
        if rank not in box:
            box[rank] = value
            self.stats["payload_in"] += _payload_nbytes(value)
        return box

    def _count_out(self, result: Any) -> None:
        if isinstance(result, dict):
            for v in result.values():
                self.stats["payload_out"] += _payload_nbytes(v)
        else:
            self.stats["payload_out"] += _payload_nbytes(result)

    async def exchange(self, key: str, rank: int, value: Any, timeout: float = 30.0) -> Optional[dict]:
        """Contribute and park until every rank has; returns the full box (or
        None on timeout — callers re-arm until their own deadline). The box
        is garbage-collected once all ranks have fetched it."""
        if key in self._consumed:
            # Every rank already fetched and the box was reaped: a re-armed
            # rank lost its reply for good — the values are gone. Fail loud
            # now (typed, immediate) instead of recreating a ghost
            # rounds[key] that parks this rank to its deadline and counts
            # ghost payload_in bytes.
            self._raise_reaped(key)
        if key not in self.done:
            # Not complete yet: contribute (idempotent under re-arm) and park.
            # The done-check guards re-arms AFTER completion from re-creating
            # a ghost rounds[key] that would never be collected.
            box = self._contribute(key, rank, value)
            ev = self._ev(key)
            if len(box) == self.world_size:
                self.done[key] = self.rounds.pop(key)
                ev.set()
            else:
                try:
                    await asyncio.wait_for(ev.wait(), timeout)
                except asyncio.TimeoutError:
                    return None
        result = self.done.get(key)
        if result is None:
            return None
        acked = self.acks.setdefault(key, set())
        if rank not in acked:
            # First fetch only: a re-arm whose reply was lost (box not yet
            # fully reaped) replays the value without inflating the
            # operator-facing payload counters.
            acked.add(rank)
            self._count_out(result)
        if len(acked) == self.world_size:
            self.done.pop(key, None)
            self.acks.pop(key, None)
            self._events.pop(key, None)
            self.rounds.pop(key, None)
            self._mark_consumed(key)
        return result

    async def collect(self, key: str, rank: int, value: Any, dst_rank: int,
                      timeout: float = 30.0) -> Optional[dict]:
        """All ranks contribute; ONLY ``dst_rank`` receives the box (and
        pays its transfer) — non-dst ranks get a tiny ack without parking
        for completion. Replaces exchange() for reduce(): the legacy shape
        shipped the full all-ranks box to every rank that then returned
        None."""
        if key in self._consumed:
            # dst already fetched and the box is gone: a re-armed non-dst
            # contribution (lost ack reply) must not recreate a ghost box
            # nobody will complete — or count ghost payload bytes. A
            # re-armed dst lost its reply for good: fail typed NOW (a None
            # would make _rearm busy-spin RPCs until the full deadline).
            if rank != dst_rank:
                return {"ok": True}
            self._raise_reaped(key)
        if key not in self.done:
            box = self._contribute(key, rank, value)
            if len(box) == self.world_size:
                self.done[key] = self.rounds.pop(key)
                self._ev(key).set()
            elif rank != dst_rank:
                return {"ok": True}
            else:
                try:
                    await asyncio.wait_for(self._ev(key).wait(), timeout)
                except asyncio.TimeoutError:
                    return None
        if rank != dst_rank:
            return {"ok": True}
        result = self.done.get(key)
        if result is None:
            return None
        self._count_out(result)
        # Single consumer: GC as soon as dst has fetched.
        self.done.pop(key, None)
        self._events.pop(key, None)
        self._mark_consumed(key)
        return result

    async def publish(self, key: str, rank: int, value: Any, src_rank: int,
                      timeout: float = 30.0) -> Optional[dict]:
        """``src_rank`` publishes one value; every rank receives exactly it
        (no all-ranks box, no parking on non-src contributions). Replaces
        exchange() for broadcast(): completion needs only src's arrival, and
        non-src ranks no longer occupy mailbox slots with Nones."""
        if key in self._consumed:
            # All ranks acked and the value was reaped: a re-armed rank lost
            # its reply for good (and a re-armed src must not republish a
            # ghost entry nobody will ever GC). Same shape as collect()'s
            # guard — fail loud now, not at the caller's deadline.
            self._raise_reaped(key)
        if rank == src_rank and key not in self.done and key not in self.acks:
            self.stats["payload_in"] += _payload_nbytes(value)
            self.done[key] = {"v": value}
            self._ev(key).set()
        if key not in self.done:
            try:
                await asyncio.wait_for(self._ev(key).wait(), timeout)
            except asyncio.TimeoutError:
                return None
        entry = self.done.get(key)
        if entry is None:
            return None
        acked = self.acks.setdefault(key, set())
        if rank not in acked:
            # First fetch only (same lost-reply replay shape as exchange).
            acked.add(rank)
            self.stats["payload_out"] += _payload_nbytes(entry["v"])
        if len(acked) == self.world_size:
            self.done.pop(key, None)
            self.acks.pop(key, None)
            self._events.pop(key, None)
            self._mark_consumed(key)
        return entry

    # point-to-point
    async def put_p2p(self, key: str, value: Any) -> None:
        self.stats["payload_in"] += _payload_nbytes(value)
        self.done[key] = {"v": value}
        self._ev(key).set()

    async def take_p2p(self, key: str, timeout: float = 30.0) -> Optional[dict]:
        if key not in self.done:
            try:
                await asyncio.wait_for(self._ev(key).wait(), timeout)
            except asyncio.TimeoutError:
                return None
        self._events.pop(key, None)
        entry = self.done.pop(key, None)
        if entry is not None:
            self.stats["payload_out"] += _payload_nbytes(entry["v"])
        return entry


class _GroupHandle:
    def __init__(self, name: str, actor, world_size: int, rank: int, join_id: str):
        self.name = name
        self.actor = actor
        self.world_size = world_size
        self.rank = rank
        self.join_id = join_id
        self.epoch: Optional[int] = None  # resolved at first collective
        self.counters: dict[str, int] = {}
        self._ring = None  # lazily-established ring transport

    def ensure_epoch(self, timeout: float = 120.0) -> int:
        """Block until the whole gang has joined and an epoch is assigned.

        Deferred to the first collective op (init stays non-blocking, like
        the reference where NCCL rendezvous happens lazily)."""
        import ray_tpu_torch as rt

        if self.epoch is not None:
            return self.epoch
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"group {self.name}: gang never fully joined "
                    f"(world_size={self.world_size})"
                )
            # Server-side park (event-driven); short windows so an abandoned
            # wait never orphans an hour-long handler on the coordinator.
            epoch = rt.get(
                self.actor.wait_epoch.remote(self.join_id, min(remaining, 30.0)),
                timeout=min(remaining, 30.0) + 30,
            )
            if epoch is not None:
                self.epoch = epoch
                return epoch

    def ensure_ring(self, timeout: float = 60.0):
        """Establish (or reuse) the peer-to-peer ring for this group's
        current epoch. Addresses come from the coordinator — its only duty
        on the ring path."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.collective import ring as _ring
        from ray_tpu_torch.core import api as _api

        if self._ring is not None and self._ring.healthy():
            return self._ring
        epoch = self.ensure_epoch()
        core = _api._require_worker()
        info = rt.get(self.actor.get_ring_info.remote(epoch), timeout=30)
        if info is None:
            raise _ring.CollectiveError(
                f"group {self.name!r}: epoch {epoch} is stale (a newer gang "
                "joined); re-init the collective group")
        addrs = {int(r): a for r, a in info["addresses"].items()}
        missing = [r for r, a in addrs.items() if not a]
        if missing:
            raise _ring.CollectiveError(
                f"group {self.name!r}: ranks {missing} joined without a "
                "worker transport address; ring transport unavailable")
        self._ring = _ring.establish_sync(
            core, self.name, info.get("boot", ""), epoch, self.rank,
            self.world_size, addrs, timeout)
        return self._ring

    def next_key(self, op: str) -> str:
        epoch = self.ensure_epoch()
        c = self.counters.get(op, 0)
        self.counters[op] = c + 1
        return f"e{epoch}:{op}:{c}"

    def _rearm(self, method: str, op: str, args: tuple, timeout: float) -> dict:
        """Common client loop: short server-side parks re-armed until the
        caller's own deadline."""
        import ray_tpu_torch as rt

        key = self.next_key(op)
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"collective {op} timed out in group {self.name}")
            box = rt.get(
                getattr(self.actor, method).remote(
                    key, self.rank, *args, min(remaining, 30.0)),
                timeout=min(remaining, 30.0) + 30,
            )
            if box is not None:
                return box

    def exchange(self, op: str, value: Any, timeout: float = 120.0) -> dict:
        """All ranks contribute; returns {rank: value} for all ranks. One
        round trip in the common case: the coordinator parks the call until
        the box is complete (re-contribution on re-arm is idempotent)."""
        return self._rearm("exchange", op, (value,), timeout)

    def collect(self, op: str, value: Any, dst_rank: int, timeout: float = 120.0) -> dict:
        """All contribute, only dst receives the box (see coordinator)."""
        return self._rearm("collect", op, (value, dst_rank), timeout)

    def publish(self, op: str, value: Any, src_rank: int, timeout: float = 120.0) -> dict:
        """src publishes, every rank receives {'v': value}."""
        return self._rearm("publish", op, (value, src_rank), timeout)


def _groups() -> dict:
    return _process_groups


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default") -> None:
    """Join (creating if needed) the named group from this process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as _api

    if backend not in ("host", "xla"):
        raise ValueError(f"unknown backend {backend!r}; host (this module) or "
                         "xla (the name ray_tpu gives in-program collectives; "
                         "the host plane serves it here too)")
    name = _GROUP_PREFIX + group_name
    Coordinator = rt.remote(_GroupCoordinator)
    try:
        actor = rt.get_actor(name)
    except ValueError:
        try:
            # Waiters PARK inside async methods holding concurrency slots:
            # budget for every rank in an exchange + p2p + epoch wait at once.
            actor = Coordinator.options(
                name=name, lifetime="detached", max_concurrency=max(16, world_size * 4)
            ).remote(world_size)
        except Exception:
            actor = rt.get_actor(name)
    existing = rt.get(actor.get_world_size.remote(), timeout=30)
    if existing != world_size:
        raise ValueError(
            f"collective group {group_name!r} already exists with world_size="
            f"{existing} (asked for {world_size}); destroy_collective_group() "
            "the stale group first"
        )
    import uuid

    join_id = uuid.uuid4().hex
    # This process's worker RPC address is the ring-transport endpoint the
    # gang's neighbors will dial (raw-frame lane, worker-to-worker).
    address = _api._require_worker().address
    rt.get(actor.join_begin.remote(rank, join_id, address), timeout=30)
    _groups()[group_name] = _GroupHandle(name, actor, world_size, rank, join_id)


class CollectiveActorMixin:
    """Inherit in an actor class to make it joinable via
    create_collective_group (driver-side declarative API)."""

    def raytpu_join_collective(self, world_size: int, rank: int,
                               backend: str, group_name: str) -> bool:
        init_collective_group(world_size, rank, backend, group_name)
        return True


def create_collective_group(actors: list, world_size: int, ranks: list[int],
                            backend: str = "host",
                            group_name: str = "default") -> None:
    """Driver-side declaration (reference: create_collective_group:211):
    tells each actor (a CollectiveActorMixin subclass) to join with its rank."""
    import ray_tpu_torch as rt

    rt.get([
        a.raytpu_join_collective.remote(world_size, r, backend, group_name)
        for a, r in zip(actors, ranks)
    ], timeout=60)


def destroy_collective_group(group_name: str = "default") -> None:
    import ray_tpu_torch as rt
    from ray_tpu_torch.collective import ring as _ring

    g = _groups().pop(group_name, None)
    _ring.drop_group(_GROUP_PREFIX + group_name)
    if g is not None:
        actor = g.actor
    else:
        # Caller (e.g. the driver after create_collective_group) never joined
        # locally — the detached coordinator still must die, or re-creating
        # the group with a different world_size stays blocked forever.
        try:
            actor = rt.get_actor(_GROUP_PREFIX + group_name)
        except ValueError:
            return
    try:
        rt.kill(actor)
    except Exception:
        pass


def _group(group_name: str) -> _GroupHandle:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this process; "
            "call init_collective_group(world_size, rank, group_name=...)"
        )
    return g


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def _check_rank(g: _GroupHandle, rank: int, what: str) -> None:
    """An out-of-range peer rank must fail loud at entry: on the ring path
    it would silently make every rank return None (reduce) or hang the
    line (broadcast); on the coordinator path it leaks the completed box
    (nobody consumes/GCs it) until the next epoch."""
    if not 0 <= rank < g.world_size:
        raise ValueError(
            f"{what}={rank} out of range for world_size={g.world_size} "
            f"in group {g.name!r}")


# Hoisted to util.dtypes so every plane shares one predicate (graftlint's
# dtype-kind rule machine-enforces that); the old name stays importable.
from ray_tpu_torch.util.dtypes import is_float_dtype as _is_float_dtype  # noqa: E402


def _to_np(x):
    """The host array of a collective's input: numpy as given, a torch
    tensor (CPU or CUDA) copied to the host — numpy where numpy has the
    dtype, a CPU tensor for bfloat16 (see util.dtypes.host_array)."""
    if _dt.is_tensor(x):
        return _dt.host_array(x)
    return np.asarray(x)


def _host(x):
    """``_to_np`` made C-contiguous and at least 1-d, as
    ``np.ascontiguousarray`` makes a numpy input."""
    if _dt.is_tensor(x):
        a = _dt.host_array(x)
        return a.reshape(1) if a.ndim == 0 else a
    return np.ascontiguousarray(np.asarray(x))


def _dname(a) -> str:
    return _dt.dtype_name(a.dtype)


def _copy(a):
    return a.clone() if _dt.is_tensor(a) else a.copy()


def _backing(arr) -> bytearray:
    """One-copy mutable byte backing for a C-contiguous host array.
    ``bytearray(arr.tobytes())`` would copy twice; a uint8 reinterpret view
    works for any itemsize, bfloat16 tensors included."""
    return bytearray(_dt.byte_view(arr))


def _reduce(op: str, arrs: list):
    """Coordinator-path reduction in rank order: numpy as the reference
    reduces; bfloat16 tensors one rank at a time with torch ops, each step
    rounded to bfloat16 as ml_dtypes' per-element loops round it."""
    if not _dt.is_tensor(arrs[0]):
        return _REDUCERS[op](arrs)
    import torch

    fn = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
          "min": torch.minimum}[op]
    out = arrs[0]
    for a in arrs[1:]:
        out = fn(out, a)
    return out


_REDUCERS = {
    "sum": lambda arrs: sum(arrs[1:], start=arrs[0]),
    "prod": lambda arrs: np.prod(np.stack(arrs), axis=0),
    "max": lambda arrs: np.max(np.stack(arrs), axis=0),
    "min": lambda arrs: np.min(np.stack(arrs), axis=0),
}


# ---------------------------------------------------------------------------
# Async work handles (ring transport)
# ---------------------------------------------------------------------------


class CollectiveWork:
    """A collective in flight on the ring transport. ``result()`` blocks
    until the op completes and returns the op's output; exceptions from the
    ring (typed CollectiveError) re-raise there. The train plane's bucketed
    overlap holds a list of these while packing the next bucket."""

    def __init__(self, fut, post, op_timeout: float):
        self._fut = fut
        self._post = post
        self._op_timeout = op_timeout
        self._resolved = False
        self._value = None

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        """Block for the op. With no ``timeout`` the wait is bounded by the
        OP's timeout plus grace — never unbounded: the coroutine enforces
        its own deadline, so an overrun here means the worker IO loop died
        mid-op and the never-a-hang contract still owes a typed error. An
        explicit shorter ``timeout`` is a poll: it raises TimeoutError and
        the op may still complete later."""
        if not self._resolved:
            import concurrent.futures

            bound = self._op_timeout + 5.0
            eff = bound if timeout is None else min(timeout, bound)
            try:
                out = self._fut.result(eff)
            except (concurrent.futures.TimeoutError, TimeoutError):
                if timeout is not None and timeout < bound:
                    # The caller's own poll deadline; op still running. The
                    # BUILTIN TimeoutError: on 3.10 concurrent.futures'
                    # is a distinct class, and the documented poll contract
                    # (and the coordinator transport) use the builtin.
                    raise TimeoutError(
                        f"collective op still in flight after {timeout}s"
                    ) from None
                from ray_tpu_torch.collective import ring as _ring

                raise _ring.CollectiveError(
                    f"ring collective produced no result within "
                    f"{self._op_timeout}s + grace (worker IO loop stalled "
                    "or gone)") from None
            self._value = self._post(out) if self._post is not None else out
            self._resolved = True
            # Drop the future and the post closure: they pin the op's input
            # copies (backing bytearray, source array) — dead weight once
            # the result exists, and a caller holding many resolved handles
            # (a step's bucket list) would otherwise hold ~2x tensor bytes
            # per bucket for the handle's lifetime.
            self._fut = None
            self._post = None
        return self._value


class _DoneWork(CollectiveWork):
    def __init__(self, value):
        self._resolved = True
        self._value = value

    def done(self) -> bool:
        return True

    def result(self, timeout: Optional[float] = None):
        return self._value


def _use_ring(g: _GroupHandle, transport: str) -> bool:
    if transport not in ("auto", "ring", "coordinator"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(auto | ring | coordinator)")
    return transport != "coordinator" and g.world_size > 1


def _observe_gbs(nbytes: int, elapsed: float, transport: str,
                 quantization: Optional[str]) -> None:
    from ray_tpu_torch.collective import ring as _ring

    if elapsed > 0:
        _ring._gbs_hist.observe(
            nbytes / elapsed / 1e9,
            tags={"transport": transport, "quant": quantization or "none"})


def _launch(g: _GroupHandle, coro_factory, post, op_timeout: float):
    """Allocate the op counter (caller thread, deterministic order) and run
    the op coroutine on the worker IO loop."""
    rng = g.ensure_ring()
    ctr = rng.next_ctr()
    fut = asyncio.run_coroutine_threadsafe(coro_factory(rng, ctr), rng.core.loop)
    return CollectiveWork(fut, post, op_timeout)


def allreduce_async(tensor, op: str = "sum", group_name: str = "default", *,
                    quantization: Optional[str] = None,
                    timeout: float = 120.0) -> CollectiveWork:
    """Ring allreduce, asynchronously: returns a :class:`CollectiveWork`
    whose ``result()`` is the reduced array (dtype matches the input, even
    with ``quantization="int8"``). All ranks must launch their collectives
    in the same order — the op counter is the only frame<->op match. A
    torch input (CPU or CUDA) crosses to the host here and its result comes
    back as a tensor on the input's device."""
    from ray_tpu_torch.core import api as _api

    g = _group(group_name)
    back = _dt.backer(tensor)
    arr = _host(tensor)
    if quantization not in (None, "int8"):
        raise ValueError(f"unknown quantization {quantization!r} (int8 or None)")
    if quantization == "int8":
        if op != "sum":
            raise ValueError("int8 quantization supports op='sum' only")
        if not _is_float_dtype(arr.dtype):
            raise ValueError("int8 quantization needs a floating-point input")
    orig_dtype, shape = _dname(arr), tuple(arr.shape)
    if g.world_size == 1:
        return _DoneWork(back(_copy(arr)))
    acc_dtype = "float32" if quantization else orig_dtype
    src = _dt.to_float32(arr) if quantization and orig_dtype != acc_dtype else arr
    buf = _backing(src)
    # Adopted cluster config (NOT get_config()): the block size is part of
    # the wire contract — every rank must quantize with the same one, and
    # spawned workers only see head-pushed knobs through core.config.
    block = _api._require_worker().config.collective_quant_block
    t0 = time.perf_counter()
    n = _dt.numel(arr)
    nbytes = _dt.nbytes(arr)

    def factory(rng, ctr):
        from ray_tpu_torch.collective import ring as _ring

        return _ring._allreduce(rng, ctr, buf, acc_dtype, n, op,
                                quantization, block, timeout)

    def post(outbuf):
        out = _dt.from_bytes(outbuf, acc_dtype, shape)
        if quantization and orig_dtype != acc_dtype:
            out = _dt.from_float32(out, orig_dtype)
        _observe_gbs(nbytes, time.perf_counter() - t0, "ring", quantization)
        return back(out)

    return _launch(g, factory, post, timeout)


def allreduce(tensor, op: str = "sum", group_name: str = "default", *,
              quantization: Optional[str] = None, transport: str = "auto",
              timeout: float = 120.0):
    g = _group(group_name)
    if _use_ring(g, transport):
        return allreduce_async(tensor, op, group_name,
                               quantization=quantization,
                               timeout=timeout).result()
    if quantization is not None and g.world_size > 1:
        raise ValueError("quantization requires the ring transport")
    t0 = time.perf_counter()
    back = _dt.backer(tensor)
    arr = _to_np(tensor)
    box = g.exchange("allreduce", arr, timeout=timeout)
    arrs = [box[r] for r in sorted(box)]
    out = _reduce(op, arrs)
    _observe_gbs(_dt.nbytes(arr), time.perf_counter() - t0,
                 "coordinator", None)
    return back(out)


def reduce(tensor, dst_rank: int = 0, op: str = "sum",
           group_name: str = "default", *, transport: str = "auto",
           timeout: float = 120.0):
    g = _group(group_name)
    _check_rank(g, dst_rank, "dst_rank")
    back = _dt.backer(tensor)
    arr = _host(tensor)
    if _use_ring(g, transport):
        dtype, shape, n = _dname(arr), tuple(arr.shape), _dt.numel(arr)
        buf = _backing(arr)

        def factory(rng, ctr):
            from ray_tpu_torch.collective import ring as _ring

            return _ring._reduce_line(rng, ctr, buf, dtype, n, op,
                                      dst_rank, timeout)

        def post(outbuf):
            if outbuf is None:
                return None
            return back(_dt.from_bytes(outbuf, dtype, shape))

        return _launch(g, factory, post, timeout).result()
    # Legacy path: all contribute, ONLY dst receives the box (collect);
    # non-dst ranks no longer download the full all-ranks box to return None.
    box = g.collect("reduce", arr, dst_rank, timeout=timeout)
    if g.rank != dst_rank:
        return None
    arrs = [box[r] for r in sorted(box)]
    return back(_reduce(op, arrs))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default", *,
              transport: str = "auto", timeout: float = 120.0):
    g = _group(group_name)
    _check_rank(g, src_rank, "src_rank")
    if _use_ring(g, transport):
        if g.rank == src_rank:
            arr = _host(tensor)
            meta = {"dtype": _dname(arr), "shape": tuple(arr.shape),
                    "nbytes": _dt.nbytes(arr), "torch": _dt.is_tensor(tensor)}
            buf = _backing(arr)
        else:
            arr, meta, buf = None, None, None

        def factory(rng, ctr):
            from ray_tpu_torch.collective import ring as _ring

            return _ring._broadcast(rng, ctr, buf, meta, src_rank, timeout)

        def post(out):
            outbuf, ometa = out
            got = _dt.from_bytes(outbuf, ometa["dtype"], ometa["shape"])
            return _backer_for(tensor, ometa.get("torch"))(got)

        return _launch(g, factory, post, timeout).result()
    # Legacy path: src publishes once; non-src ranks neither contribute a
    # mailbox slot nor wait on anything but src's arrival (publish).
    payload = _to_np(tensor) if g.rank == src_rank else None
    got = g.publish("broadcast", payload, src_rank, timeout=timeout)
    return _backer_for(tensor, _dt.is_tensor(got["v"]))(got["v"])


def _backer_for(tensor, src_was_torch: bool):
    """A receiving rank's result kind: its own input's when that is a
    tensor (its device), else a CPU tensor when the source sent one, else
    numpy."""
    if _dt.is_tensor(tensor):
        return _dt.backer(tensor)
    if src_was_torch:
        import torch

        return lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    return lambda a: a


def allgather(tensor, group_name: str = "default", *, transport: str = "auto",
              timeout: float = 120.0) -> list:
    g = _group(group_name)
    if _use_ring(g, transport):
        return allgather_async(tensor, group_name, timeout=timeout).result()
    back = _dt.backer(tensor)
    arr = _host(tensor)
    box = g.exchange("allgather", arr, timeout=timeout)
    return [back(box[r]) for r in sorted(box)]


def allgather_async(tensor, group_name: str = "default", *,
                    timeout: float = 120.0) -> CollectiveWork:
    """Ring allgather: result() is the list of every rank's array, rank
    order. World 1 completes immediately."""
    g = _group(group_name)
    back = _dt.backer(tensor)
    arr = _host(tensor)
    if g.world_size == 1:
        return _DoneWork([back(_copy(arr))])
    dtype, shape, n = _dname(arr), tuple(arr.shape), _dt.numel(arr)
    W, r = g.world_size, g.rank
    nb = _dt.nbytes(arr)
    buf = bytearray(W * nb)
    buf[r * nb:(r + 1) * nb] = _dt.byte_view(arr)

    def factory(rng, ctr):
        from ray_tpu_torch.collective import ring as _ring

        return _ring._allgather(rng, ctr, buf, dtype, n, timeout)

    def post(outbuf):
        flat = _dt.from_bytes(outbuf, dtype)
        return [back(flat[c * n:(c + 1) * n].reshape(shape)) for c in range(W)]

    return _launch(g, factory, post, timeout)


def reducescatter(tensor, op: str = "sum", group_name: str = "default", *,
                  transport: str = "auto", timeout: float = 120.0):
    """Each rank contributes a [world, ...] stack; rank r gets the reduction
    of everyone's r-th shard."""
    g = _group(group_name)
    shape = tuple(getattr(tensor, "shape", None) or np.shape(tensor))
    if not shape or shape[0] != g.world_size:
        raise ValueError(
            f"reducescatter input leading dim {shape[0] if shape else None} "
            f"!= world {g.world_size}"
        )
    if _use_ring(g, transport):
        return reducescatter_async(tensor, op, group_name,
                                   timeout=timeout).result()
    back = _dt.backer(tensor)
    t = _host(tensor)
    box = g.exchange("reducescatter", t, timeout=timeout)
    arrs = [box[r][g.rank] for r in sorted(box)]
    return back(_reduce(op, arrs))


def reducescatter_async(tensor, op: str = "sum",
                        group_name: str = "default", *,
                        timeout: float = 120.0) -> CollectiveWork:
    g = _group(group_name)
    back = _dt.backer(tensor)
    t = _host(tensor)
    if t.shape[0] != g.world_size:
        raise ValueError(
            f"reducescatter input leading dim {t.shape[0]} != world {g.world_size}"
        )
    if g.world_size == 1:
        return _DoneWork(back(_copy(t[0])))
    dtype = _dname(t)
    slice_shape = tuple(t.shape[1:])
    n_per = _dt.numel(t[0])
    r = g.rank
    buf = _backing(t)

    def factory(rng, ctr):
        from ray_tpu_torch.collective import ring as _ring

        return _ring._reducescatter(rng, ctr, buf, dtype, n_per, op, timeout)

    def post(outbuf):
        flat = _dt.from_bytes(outbuf, dtype)
        return back(_copy(flat[r * n_per:(r + 1) * n_per].reshape(slice_shape)))

    return _launch(g, factory, post, timeout)


def barrier(group_name: str = "default") -> None:
    _group(group_name).exchange("barrier", None)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    import ray_tpu_torch as rt

    g = _group(group_name)
    _check_rank(g, dst_rank, "dst_rank")
    chan = f"p2p:{g.rank}->{dst_rank}"
    key = f"{chan}:{g.next_key(chan)}"
    rt.get(g.actor.put_p2p.remote(key, _to_np(tensor)), timeout=60)


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0):
    import ray_tpu_torch as rt

    g = _group(group_name)
    _check_rank(g, src_rank, "src_rank")
    chan = f"p2p:{src_rank}->{g.rank}"
    key = f"{chan}:{g.next_key(chan)}"
    # ONE event-waited server-side park honoring the caller's full timeout
    # (the old shape re-issued take_p2p in 30s slices and padded the
    # enclosing rt.get by +30s — a missing sender cost timeout+30 to fail).
    got = rt.get(
        g.actor.take_p2p.remote(key, timeout),
        timeout=timeout + 5.0,
    )
    if got is None:
        raise TimeoutError(f"recv from {src_rank} timed out")
    return got["v"]
