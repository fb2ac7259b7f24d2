"""Serialization surface: cloudpickle-based, protocol 5, ObjectRef-aware.

Equivalent in role to the reference's serialization layer
(python/ray/_private/serialization.py and
python/ray/includes/serialization.pxi): values are pickled with out-of-band
buffer support; ``ObjectRef``s contained inside a value are recorded during
serialization (for distributed refcounting / dependency resolution) and
re-registered on deserialization (borrower bookkeeping).
"""
from __future__ import annotations

import io
import pickle
import sys
import traceback
from typing import Any, Callable

import cloudpickle

_PROTOCOL = 5


class SerializationContext:
    """Process-wide hooks used while (de)serializing ObjectRefs."""

    def __init__(self):
        self.on_ref_serialized: Callable | None = None
        self.on_ref_deserialized: Callable | None = None


_context = SerializationContext()


def get_serialization_context() -> SerializationContext:
    return _context


class DeviceUnavailableError(RuntimeError):
    """A tensor that lived on a CUDA device reached a process that sees no
    CUDA device. It is never restored onto the CPU instead."""


def _restore_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    device: str, param: bool):
    """Rebuild a tensor from its raw bytes (one out-of-band buffer).

    ``buf`` is a view into the object store when the value came out of
    shared memory, and the store's objects are sealed and shared by every
    reader: torch tensors are mutable, so the result always owns its memory.
    A CPU tensor is one copy out of the buffer; a CUDA tensor is one H2D copy
    from it onto this process's current CUDA device."""
    import warnings

    import torch

    dt = getattr(torch, dtype)
    n = memoryview(buf).nbytes
    if device != "cpu":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"a tensor that lived on {device} was restored in a process "
                "that sees no CUDA device"
            )
        target = torch.device("cuda", torch.cuda.current_device())
    if n == 0:
        raw = torch.empty(0, dtype=torch.uint8)
    else:
        with warnings.catch_warnings():
            # A read-only view: it is copied below and never written.
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(buf, dtype=torch.uint8)
    raw = raw.clone() if device == "cpu" else raw.to(target)
    t = raw.view(dt).reshape(shape)
    if param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(obj):
    """The out-of-band reduce of a dense ``torch.Tensor`` / ``nn.Parameter``:
    one buffer holding the tensor's raw bytes (made contiguous first; a CUDA
    tensor comes over in one synchronous D2H copy, complete before its bytes
    reach the store), with dtype, shape, ``requires_grad`` and the device in
    the pickle body. bf16 has no numpy dtype, so the bytes travel as a uint8
    view and the dtype by its name. Returns None for the layouts torch's own
    reduce must handle (sparse, quantized, meta)."""
    import torch

    if type(obj) not in (torch.Tensor, torch.nn.Parameter):
        return None
    if obj.layout != torch.strided or obj.is_quantized or obj.is_meta:
        return None
    t = obj.detach().resolve_conj().resolve_neg().contiguous()
    raw = t.reshape(-1).view(torch.uint8)
    if raw.device.type != "cpu":
        raw = raw.cpu()
    buf = pickle.PickleBuffer(raw.numpy())
    return (
        _restore_tensor,
        (buf, str(t.dtype).removeprefix("torch."), tuple(t.shape),
         bool(obj.requires_grad), str(obj.device),
         type(obj) is torch.nn.Parameter),
    )


def _reduce_sharded(obj):
    """The out-of-band reduce of a ``ray_tpu_torch.parallel.ShardedTensor``:
    one buffer per UNIQUE shard (a block that several slots replicate
    travels once), each shard's bytes taken from its own slot (one D2H copy
    per shard, never a gather of the whole array), with the global shape,
    the dtype, the mesh's axis names and shape, the spec and each slot's
    buffer in the pickle body."""
    hosts, indices, slot_to_host = [], [], []
    seen: dict = {}
    for s, t in enumerate(obj.locals):
        key = obj.block(s)
        k = seen.get(key)
        if k is None:
            k = seen[key] = len(hosts)
            raw = t.detach().contiguous().reshape(-1).view(__import__("torch").uint8)
            hosts.append(pickle.PickleBuffer((raw.cpu() if raw.device.type != "cpu" else raw).numpy()))
            indices.append(key)
        slot_to_host.append(k)
    mesh = obj.mesh
    return (
        _restore_sharded,
        (hosts, indices, slot_to_host, tuple(obj.shape), str(obj.dtype).removeprefix("torch."),
         tuple(mesh.axis_names), tuple(mesh.devices.shape), tuple(obj.spec),
         mesh.slot_devices[0].type, bool(obj.locals[0].requires_grad)),
    )


def _restore_sharded(hosts, indices, slot_to_host, shape, dtype, axis_names, mesh_shape, spec, kind,
                     requires_grad):
    """Reassembles a ShardedTensor shard by shard onto an equivalent mesh
    (same axis names and shape) of this process's ``devices()`` of the
    sender's kind: one copy (CPU) or one H2D copy (CUDA) per unique shard
    and device, slots of one device sharing a replicated block. A shard
    that lived on a CUDA device never lands on the CPU: with too few cards
    this raises ``DeviceUnavailableError`` (CPU slots are always enough)."""
    import math
    import warnings

    import numpy as np
    import torch

    from ray_tpu_torch.parallel.mesh import Mesh, devices
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec, ShardedTensor

    n = math.prod(mesh_shape)
    devs = devices("cpu" if kind == "cpu" else None)
    if len(devs) < n:
        if kind != "cpu":
            raise DeviceUnavailableError(
                f"a tensor sharded over {n} slots of {kind} was restored in a process with {len(devs)}")
        devs = [torch.device("cpu")] * n
    arr = np.empty(n, dtype=object)
    arr[:] = list(devs[:n])
    mesh = Mesh(arr.reshape(mesh_shape), axis_names)
    dt = getattr(torch, dtype)
    made: dict = {}
    locals_ = []
    for s, k in enumerate(slot_to_host):
        dev = arr[s]
        key = (k, str(dev))
        if key not in made:
            shp = tuple(hi - lo for lo, hi in indices[k])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # a read-only view, copied below
                raw = torch.frombuffer(hosts[k], dtype=torch.uint8) if memoryview(hosts[k]).nbytes else \
                    torch.empty(0, dtype=torch.uint8)
            t = (raw.clone() if dev.type == "cpu" else raw.to(dev)).view(dt).reshape(shp)
            made[key] = t.requires_grad_(requires_grad) if requires_grad else t
        locals_.append(made[key])
    return ShardedTensor(locals_, NamedSharding(mesh, PartitionSpec(*spec)), shape)


class _RefAwarePickler(cloudpickle.CloudPickler):
    def __init__(self, file, protocol=_PROTOCOL, buffer_callback=None):
        super().__init__(file, protocol=protocol, buffer_callback=buffer_callback)
        self.contained_refs = []

    def persistent_id(self, obj):
        # Only used for tracking; refs are still pickled by value via reduce.
        return None

    def reducer_override(self, obj):
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            self.contained_refs.append(obj)
            if _context.on_ref_serialized is not None:
                _context.on_ref_serialized(obj)
            return obj.__reduce__()
        # Device-tensor transport (reference: gpu_object_manager,
        # gpu_object_manager.py:55-75 — tensors bypass the generic pickle
        # path). torch.Tensor's own reduce embeds its storage INSIDE the
        # pickle stream (an extra copy each way); here a dense tensor's bytes
        # ride the protocol-5 out-of-band path — scatter-written straight
        # into shared memory with no intermediate join — and are restored
        # with one copy (CPU) or one H2D copy (CUDA) on the consuming
        # process (_reduce_tensor / _restore_tensor). Gated on torch being
        # imported already: serialization never imports it.
        if "torch" in sys.modules and type(obj).__module__.startswith("torch"):
            rv = _reduce_tensor(obj)
            if rv is not None:
                return rv
        # A sharded tensor ships one buffer per unique shard (the TP weight
        # handoff through the object store): _reduce_sharded / _restore_sharded.
        if type(obj).__name__ == "ShardedTensor" and type(obj).__module__ == "ray_tpu_torch.parallel.sharding":
            return _reduce_sharded(obj)
        # Delegate to CloudPickler's override — that's where by-value
        # pickling of local functions/classes lives; returning
        # NotImplemented here would silently drop it.
        return super().reducer_override(obj)


def serialize_parts(value: Any) -> tuple[list, list, int]:
    """Serialize ``value`` -> (payload parts, contained ObjectRefs, total
    bytes). Parts are bytes/memoryviews in wire order; out-of-band pickle-5
    buffers (ndarray payloads etc.) stay as zero-copy views so callers can
    scatter-write them straight into shared memory without an intermediate
    join (one memcpy for a large array put instead of two)."""
    if type(value) in _ATOMIC_TYPES:  # see serialize(): no refs possible.
        # Two parts, preserving the zero-extra-copy contract: a large bytes
        # payload must not pay a concat before the scatter-write.
        body = pickle.dumps(value, protocol=_PROTOCOL)
        return [b"P", body], [], 1 + len(body)
    buffers: list[pickle.PickleBuffer] = []
    f = io.BytesIO()
    p = _RefAwarePickler(f, buffer_callback=buffers.append)
    p.dump(value)
    body = f.getvalue()
    if buffers:
        parts: list = [b"B" + len(buffers).to_bytes(4, "little")]
        for b in buffers:
            raw = b.raw()
            parts.append(len(raw).to_bytes(8, "little"))
            parts.append(raw)
        parts.append(body)
    else:
        parts = [b"P", body]
    return parts, p.contained_refs, sum(len(x) for x in parts)


# Types that cannot contain ObjectRefs, device arrays, or anything else the
# ref-aware pickler exists for: plain pickle.dumps (the C fast path, no
# CloudPickler construction) produces a byte-compatible "P" body.
_ATOMIC_TYPES = frozenset({bytes, str, int, float, bool, type(None)})


def serialize(value: Any) -> tuple[bytes, list]:
    """Serialize ``value`` -> (payload bytes, contained ObjectRefs)."""
    if type(value) in _ATOMIC_TYPES:
        # Tiny-reply/put fast path: building a _RefAwarePickler costs more
        # than pickling these values; ~every actor-call reply is one.
        return b"P" + pickle.dumps(value, protocol=_PROTOCOL), []
    parts, refs, _total = serialize_parts(value)
    return b"".join(parts), refs


_EMPTY_ARGS_BLOB: bytes | None = None


def serialize_args(args: tuple, kwargs: dict) -> tuple[bytes, list]:
    """``serialize((args, kwargs))`` with a constant-blob fast path for the
    empty call — the hot case for no-arg actor pings, where building a
    CloudPickler per call costs more than the rest of the submission."""
    if not args and not kwargs:
        global _EMPTY_ARGS_BLOB
        if _EMPTY_ARGS_BLOB is None:
            _EMPTY_ARGS_BLOB = serialize(((), {}))[0]
        return _EMPTY_ARGS_BLOB, []
    return serialize((args, kwargs))


def deserialize(data: bytes | memoryview) -> Any:
    try:
        data = memoryview(data)
    except TypeError:
        # A PinnedBuffer on a pre-PEP-688 interpreter (Python < 3.12):
        # memoryview() cannot see its __buffer__ export, so zero-copy
        # deserialization is impossible to do safely (derived views would
        # not hold the eviction pin). Degrade to a copy — correctness over
        # zero-copy on old interpreters.
        if hasattr(data, "tobytes"):
            data = memoryview(data.tobytes())
        else:
            raise
    tag = bytes(data[:1])
    if tag == b"P":
        return pickle.loads(data[1:])
    if tag == b"B":
        off = 1
        nbuf = int.from_bytes(data[off : off + 4], "little")
        off += 4
        buffers = []
        for _ in range(nbuf):
            ln = int.from_bytes(data[off : off + 8], "little")
            off += 8
            buffers.append(data[off : off + ln])
            off += ln
        return pickle.loads(data[off:], buffers=buffers)
    raise ValueError(f"bad serialization tag {tag!r}")


def dumps_function(fn) -> bytes:
    return cloudpickle.dumps(fn, protocol=_PROTOCOL)


def loads_function(data: bytes):
    return cloudpickle.loads(data)


class RemoteError(Exception):
    """An exception raised inside a remote task/actor, re-raised at the caller.

    Mirrors RayTaskError (python/ray/exceptions.py): carries the
    remote traceback text and the original exception when picklable.
    """

    def __init__(self, message: str, cause: BaseException | None = None):
        super().__init__(message)
        self.cause = cause

    @classmethod
    def from_exception(cls, exc: BaseException, where: str = "") -> "RemoteError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        try:
            cloudpickle.dumps(exc)
            cause = exc
        except Exception:
            cause = None
        return cls(f"Error in remote {where}:\n{tb}", cause)
