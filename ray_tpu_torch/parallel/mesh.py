"""Device meshes of slots: the port's counterpart of ``ray_tpu/parallel/mesh.py``.

The reference is a single-controller program: one process drives every
local chip through a ``jax.sharding.Mesh`` and its tests run on an 8-device
virtual CPU mesh in one process. The port keeps that design. A ``Mesh`` here
is an array of *device slots* (``torch.device`` objects) with named axes, in
the canonical order

    ("replica", "data", "fsdp", "stage", "expert", "seq", "tensor")

and one process computes every slot's shard (``parallel/_shard_map.py``).
``devices()`` is the counterpart of ``jax.devices()``: the visible cards
``cuda:0..n-1`` by default, CPU slots only when asked. The environment
variable ``RAY_TPU_TORCH_DEVICE_SLOTS=n`` (the counterpart of
``--xla_force_host_platform_device_count``) makes ``devices()`` list n slots
of ONE physical device: 8 CPU slots in the tests, 2 or 4 slots of ``cuda:0``
to run the sharded code paths on one card. Slots that share a card check the
sharded path's numerics and kernel launches; they do not make it faster.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np

AXIS_ORDER = ("replica", "data", "fsdp", "stage", "expert", "seq", "tensor")
SLOTS_ENV = "RAY_TPU_TORCH_DEVICE_SLOTS"

_MESH_STACK: list = []


def devices(kind: Optional[str] = None) -> list:
    """The device slots of this process. ``kind`` None is the visible
    cards, raising ``DeviceUnavailableError`` when there is none; "cpu" is
    the CPU. With ``RAY_TPU_TORCH_DEVICE_SLOTS=n`` set, n slots of the first
    such device."""
    import torch

    if kind == "cpu":
        base = [torch.device("cpu")]
    elif kind is None:
        if not torch.cuda.is_available():
            from ray_tpu_torch.core.serialization import DeviceUnavailableError

            raise DeviceUnavailableError(
                "devices() lists the CUDA devices and none is visible; pass kind='cpu' for CPU slots")
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"unknown device kind {kind!r} (None for the cards, or 'cpu')")
    n = int(os.environ.get(SLOTS_ENV, "0") or 0)
    return [base[0]] * n if n > 0 else base


class Mesh:
    """Named axes over an object array of device slots.

    ``shape`` is an ordered dict axis -> size (as jax's), ``devices`` the
    slot array, and a slot is known by its flat position. ``with mesh:``
    makes it the ambient mesh of the calling code."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names, devices.shape))
        self._coords = [dict(zip(self.axis_names, (int(i) for i in np.unravel_index(s, devices.shape))))
                        for s in range(devices.size)]
        self._slots = tuple(devices.flat)
        self._key = (self.axis_names, devices.shape, tuple(str(d) for d in self._slots))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slot_devices(self) -> tuple:
        """The slots' devices in flat order."""
        return self._slots

    def coords(self, slot: int) -> dict:
        """Axis -> index of a flat slot position (do not mutate it)."""
        return self._coords[slot]

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __enter__(self):
        _MESH_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _MESH_STACK.pop()

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, {sorted({str(d) for d in self.slot_devices})})"


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. -1 on exactly one axis means "infer".

    Example::

        MeshSpec(data=-1, tensor=4).build()   # DP over all but 4-way TP
    """

    replica: int = 1
    data: int = 1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolved_sizes(self, n_devices: int) -> dict[str, int]:
        sizes = self.sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {known}")
            sizes[unknown[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(f"mesh spec {sizes} needs {known} devices, have {n_devices}")
        return sizes

    def build(self, devices: Optional[Sequence] = None) -> Mesh:
        """A Mesh over ``devices`` (default: ``devices()``) in enumeration
        order, inner axes varying fastest."""
        if devices is None:
            devices = globals()["devices"]()
        sizes = self.resolved_sizes(len(devices))
        arr = np.empty(len(devices), dtype=object)
        arr[:] = list(devices)
        return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_ORDER)), AXIS_ORDER)

    def replace_inferred(self, n_devices: int) -> "MeshSpec":
        return MeshSpec(**self.resolved_sizes(n_devices))

    @property
    def n_required(self) -> int:
        """Device count if fully specified; raises if any axis is -1."""
        sizes = self.sizes()
        if any(s == -1 for s in sizes.values()):
            raise ValueError("mesh spec has an inferred axis; pass n_devices")
        return math.prod(sizes.values())


def mesh_shape_for(n_devices: int, *, tensor: int = 1, fsdp: int = 1, stage: int = 1, seq: int = 1,
                   expert: int = 1, replica: int = 1) -> MeshSpec:
    """Convenience: fix the model-parallel axes, infer the data axis."""
    return MeshSpec(replica=replica, data=-1, fsdp=fsdp, stage=stage, expert=expert, seq=seq,
                    tensor=tensor).replace_inferred(n_devices)


def create_mesh(n_devices: Optional[int] = None, kind: Optional[str] = None, **axis_sizes) -> Mesh:
    """One-call mesh: create_mesh(tensor=4) -> DP x TP mesh over all slots."""
    devs = devices(kind)
    if n_devices is not None:
        devs = devs[:n_devices]
    if "data" not in axis_sizes and not any(axis_sizes.get(a, 1) == -1 for a in AXIS_ORDER):
        axis_sizes["data"] = -1
    return MeshSpec(**axis_sizes).build(devs)


def local_mesh(kind: Optional[str] = None) -> Mesh:
    """Trivial mesh: every local slot on the data axis."""
    return MeshSpec(data=-1).build(devices(kind))
