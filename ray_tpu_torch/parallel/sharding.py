"""Sharding strategies and sharded tensors: the port's counterpart of
``ray_tpu/parallel/sharding.py``.

A ``ShardingStrategy`` maps *logical* array axes (``"batch"``, ``"embed"``,
``"heads"``, ...) to mesh axes, and every strategy (DP, FSDP/ZeRO-3,
Megatron TP, sequence parallelism, expert parallelism, pipeline stages) is a
rule set applied to the same parameter tree. The presets, ``|``, ``named``
and ``spec`` are the reference's, and ``spec`` returns the port's own
``PartitionSpec`` (a tuple with jax's equality).

Where jax places a global array's shards on devices and XLA inserts the
collectives, the port holds a ``ShardedTensor``: one local tensor per slot of
a ``Mesh``, each shard its own contiguous allocation (slots on one device
that hold the same replicated block share it), with the global ``shape``,
``dtype`` and ``sharding`` of the array it stands for. ``full()`` gathers
it. ``with_logical_constraint`` reshards a ShardedTensor to the layout the
active strategy gives its logical axes (gathering or slicing per slot); on a
plain tensor, and outside a strategy, it is a no-op, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence, Union

from ray_tpu_torch.parallel.mesh import Mesh, ambient_mesh

# Canonical logical axis vocabulary used by ray_tpu_torch.models.
LOGICAL_AXES = (
    "batch",      # per-example batch dim
    "seq",        # sequence/context dim of activations
    "embed",      # model (residual) dim
    "mlp",        # FFN hidden dim
    "heads",      # attention heads
    "kv_heads",   # KV heads (GQA)
    "head_dim",   # per-head dim
    "vocab",      # vocabulary dim
    "experts",    # MoE experts
    "expert_mlp", # per-expert FFN hidden
    "layers",     # stacked layer dim
    "stage",      # pipeline stage dim
)

class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: None (replicated), an axis name,
    or a tuple of axis names (the dim split over their product, the first
    axis outermost). Equal when the entries are equal, as jax's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and tuple(self) == tuple(other)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(("PartitionSpec", tuple(self)))

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block_index(mesh: Mesh, coords: dict, axes: tuple) -> tuple[int, int]:
    """(index, count) of a slot's block along a dim split over ``axes``."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + int(coords[a])
        n *= mesh.shape[a]
    return idx, n


def slot_blocks(mesh: Mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """Each slot's block of a global array: a tuple of (lo, hi) per dim."""
    return _slot_blocks(mesh, tuple(spec), tuple(int(n) for n in shape))


@functools.lru_cache(maxsize=4096)
def _slot_blocks(mesh: Mesh, spec: tuple, shape: tuple) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array's {len(shape)} dims")
    for e in spec:
        for a in entry_axes(e):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the mesh {tuple(mesh.shape)}")
    out = []
    for s in range(mesh.size):
        c = mesh.coords(s)
        blk = []
        for d, e in enumerate(spec):
            i, n = _block_index(mesh, c, entry_axes(e))
            if shape[d] % n:
                raise ValueError(f"dim {d} of size {shape[d]} is not divisible by its {n} shards (spec {spec})")
            bs = shape[d] // n
            blk.append((i * bs, (i + 1) * bs))
        out.append(tuple(blk))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the port's ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass
class Shard:
    """One slot's shard: its local tensor, device, flat slot position and
    global index (a tuple of slices)."""

    data: Any
    device: Any
    slot: int
    index: tuple


class ShardedTensor:
    """A global array held as one local tensor per mesh slot.

    ``locals[s]`` is slot s's block (``sharding.spec`` over
    ``sharding.mesh``). Slots on one device that hold the same block share
    one tensor; slots on other devices hold their own copy. The first slot
    of each block holds its *master* shard: the one an optimizer steps."""

    def __init__(self, locals_: list, sharding: NamedSharding, shape: Sequence[int]):
        if len(locals_) != sharding.mesh.size:
            raise ValueError(f"{len(locals_)} locals for a mesh of {sharding.mesh.size} slots")
        self.locals = list(locals_)
        self.sharding = sharding
        self.shape = tuple(int(d) for d in shape)
        self._blocks = slot_blocks(sharding.mesh, sharding.spec, self.shape)

    # -- jax.Array's surface ------------------------------------------------
    @property
    def dtype(self):
        return self.locals[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def addressable_shards(self) -> list:
        devs = self.mesh.slot_devices
        return [Shard(t, devs[s], s, tuple(slice(lo, hi) for lo, hi in self._blocks[s]))
                for s, t in enumerate(self.locals)]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.locals[0].element_size()

    def __repr__(self):
        return f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, spec={self.spec})"

    # -- blocks and masters -------------------------------------------------
    def block(self, slot: int) -> tuple:
        return self._blocks[slot]

    def master_slots(self) -> list:
        """The first slot of each distinct block, in slot order."""
        seen, out = set(), []
        for s, b in enumerate(self._blocks):
            if b not in seen:
                seen.add(b)
                out.append(s)
        return out

    def master_of(self, slot: int) -> int:
        if not hasattr(self, "_master"):
            first: dict = {}
            self._master = [first.setdefault(b, s) for s, b in enumerate(self._blocks)]
        return self._master[slot]

    def masters(self) -> list:
        """The unique shards (one tensor per distinct block)."""
        return [self.locals[s] for s in self.master_slots()]

    def slot_param(self, slot: int):
        """Slot ``slot``'s view of its master shard, differentiable back to
        the master: the master itself on the master's device, else a copy."""
        return self.locals[self.master_of(slot)].to(self.mesh.slot_devices[slot])

    def param_locals(self) -> list:
        """Every slot's ``slot_param``: slots of one device holding one
        block share one object."""
        cache: dict = {}
        out = []
        for s in range(len(self.locals)):
            key = (self.master_of(s), str(self.mesh.slot_devices[s]))
            if key not in cache:
                cache[key] = self.slot_param(s)
            out.append(cache[key])
        return out

    def sync_replicas(self) -> None:
        """After an in-place update of the masters: refresh the copies that
        slots on other devices hold."""
        import torch

        with torch.no_grad():
            for s, t in enumerate(self.locals):
                m = self.locals[self.master_of(s)]
                if t is not m:
                    t.copy_(m)

    # -- layout -------------------------------------------------------------
    def full(self, device=None):
        """The global array as one tensor (on slot 0's device unless
        ``device``); differentiable."""
        from ray_tpu_torch.parallel._shard_map import assemble

        device = self.mesh.slot_devices[0] if device is None else device
        return assemble(self.locals, self._blocks, tuple((0, n) for n in self.shape), device)

    def reshard(self, spec, mesh: Optional[Mesh] = None) -> "ShardedTensor":
        """This array under another spec (and mesh of the same slots)."""
        from ray_tpu_torch.parallel._shard_map import reshard

        spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        mesh = mesh or self.mesh
        if mesh == self.mesh and _norm(spec, self.ndim) == _norm(self.spec, self.ndim):
            return self
        if mesh.size != self.mesh.size:
            raise ValueError("reshard keeps the slots: meshes of different sizes")
        return ShardedTensor(reshard(self.locals, self.mesh, self.spec, spec, self.shape, mesh),
                             NamedSharding(mesh, spec), self.shape)

    def map(self, fn, *others) -> "ShardedTensor":
        """``fn`` on every slot's local (and the other ShardedTensors' locals
        at the same slot), keeping the spec; the global shape follows the
        locals."""
        outs = [fn(t, *(o.locals[s] for o in others)) for s, t in enumerate(self.locals)]
        return from_locals(outs, self.mesh, self.spec)

    def detach(self) -> "ShardedTensor":
        return ShardedTensor(_dedup([t.detach() for t in self.locals], self.locals), self.sharding, self.shape)


def _dedup(new: list, old: list) -> list:
    """Keep the sharing of ``old`` (same object at two slots) in ``new``."""
    first: dict = {}
    out = []
    for t_new, t_old in zip(new, old):
        k = id(t_old)
        if k in first:
            out.append(first[k])
        else:
            first[k] = t_new
            out.append(t_new)
    return out


def _norm(spec, ndim: int) -> tuple:
    spec = tuple(entry_axes(e) for e in spec)
    return spec + ((),) * (ndim - len(spec))


def from_locals(locals_: list, mesh: Mesh, spec) -> ShardedTensor:
    """A ShardedTensor from per-slot locals; the global shape is the local
    shape times each dim's shard count."""
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    local = locals_[0].shape
    shape = []
    for d, n in enumerate(local):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        shape.append(n * math.prod(mesh.shape[a] for a in axes))
    return ShardedTensor(locals_, NamedSharding(mesh, spec), shape)


def device_put(x, sharding: NamedSharding, dtype=None) -> ShardedTensor:
    """Places a tensor (or reshards a ShardedTensor) per ``sharding``: each
    slot gets its block as its own contiguous tensor on its device (cast to
    ``dtype`` on the way, when given); slots of one device holding the same
    block share it. A placed tensor is detached (``requires_grad`` kept on
    a leaf that had it), as a placement is new data."""
    import torch

    if isinstance(x, ShardedTensor):
        st = x.reshard(sharding.spec, sharding.mesh)
        if dtype is None or st.dtype == dtype:
            return st
        return ShardedTensor(_dedup([t.detach().to(dtype) for t in st.locals], st.locals), st.sharding, st.shape)
    x = torch.as_tensor(x)
    blocks = slot_blocks(sharding.mesh, sharding.spec, tuple(x.shape))
    cache: dict = {}
    locals_ = []
    for s, dev in enumerate(sharding.mesh.slot_devices):
        key = (blocks[s], str(dev))
        t = cache.get(key)
        if t is None:
            # Its own allocation, never a view of the caller's tensor.
            t = x.detach()[tuple(slice(lo, hi) for lo, hi in blocks[s])].to(
                device=dev, dtype=dtype or x.dtype, copy=True).contiguous()
            t.requires_grad_(x.requires_grad and x.is_leaf)
            cache[key] = t
        locals_.append(t)
    return ShardedTensor(locals_, sharding, tuple(x.shape))


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    """A named rule set: logical axis -> mesh axis (or tuple of mesh axes).

    Compose with ``|``: ``ShardingStrategy.fsdp() | ShardingStrategy.tp()``.
    """

    name: str
    rules: dict = dataclasses.field(default_factory=dict)

    def __or__(self, other: "ShardingStrategy") -> "ShardingStrategy":
        merged = dict(self.rules)
        for k, v in other.rules.items():
            if k in merged and merged[k] not in (None, v):
                a = merged[k] if isinstance(merged[k], tuple) else (merged[k],)
                b = v if isinstance(v, tuple) else ((v,) if v else ())
                merged[k] = tuple(dict.fromkeys(a + b))
            else:
                merged[k] = v
        return ShardingStrategy(f"{self.name}+{other.name}", merged)

    # ---- presets ---------------------------------------------------------
    @staticmethod
    def dp() -> "ShardingStrategy":
        """Pure data parallelism: batch over (replica, data, fsdp)."""
        return ShardingStrategy("dp", {"batch": ("replica", "data", "fsdp")})

    @staticmethod
    def fsdp() -> "ShardingStrategy":
        """ZeRO-3: params/opt-state sharded over the fsdp axis along embed;
        batch over (replica, data, fsdp). Weights are all-gathered per layer."""
        return ShardingStrategy("fsdp", {"batch": ("replica", "data", "fsdp"), "embed": "fsdp"})

    @staticmethod
    def tp() -> "ShardingStrategy":
        """Megatron tensor parallelism: heads/FFN-hidden/vocab over tensor.
        Column-parallel in_proj (mlp, heads sharded), row-parallel out_proj
        (contraction over the sharded axis, then a psum)."""
        return ShardingStrategy("tp", {"heads": "tensor", "kv_heads": "tensor", "mlp": "tensor",
                                       "expert_mlp": "tensor", "vocab": "tensor"})

    @staticmethod
    def sp() -> "ShardingStrategy":
        """Sequence/context parallelism: activation seq dim over the seq axis,
        full-sequence attention by ring or Ulysses attention over it."""
        return ShardingStrategy("sp", {"seq": "seq"})

    @staticmethod
    def ep() -> "ShardingStrategy":
        """Expert parallelism: experts over the expert axis."""
        return ShardingStrategy("ep", {"experts": "expert"})

    @staticmethod
    def pp() -> "ShardingStrategy":
        """Pipeline parallelism: the stacked layers are split over the stage
        axis; ray_tpu_torch.parallel.pipeline runs the microbatch schedule."""
        return ShardingStrategy("pp", {"stage": "stage", "layers": "stage"})

    @staticmethod
    def none() -> "ShardingStrategy":
        return ShardingStrategy("replicated", {})

    @staticmethod
    def named(name: str) -> "ShardingStrategy":
        """Look up a preset or '+'-composition, e.g. 'fsdp+tp+sp'."""
        presets = {
            "dp": ShardingStrategy.dp, "ddp": ShardingStrategy.dp,
            "fsdp": ShardingStrategy.fsdp, "zero3": ShardingStrategy.fsdp,
            "tp": ShardingStrategy.tp, "megatron": ShardingStrategy.tp,
            "sp": ShardingStrategy.sp, "cp": ShardingStrategy.sp, "ring": ShardingStrategy.sp,
            "ep": ShardingStrategy.ep, "moe": ShardingStrategy.ep,
            "pp": ShardingStrategy.pp,
            "none": ShardingStrategy.none, "replicated": ShardingStrategy.none,
        }
        parts = [p.strip() for p in name.split("+") if p.strip()]
        if not parts:
            return ShardingStrategy.none()
        out = presets[parts[0]]()
        for p in parts[1:]:
            out = out | presets[p]()
        return out

    # ---- application -----------------------------------------------------
    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """PartitionSpec for an array whose dims carry these logical axes
        (a mesh axis is used by the first dim that asks for it only)."""
        used: set = set()
        entries = []
        for ax in logical_axes:
            target = self.rules.get(ax) if ax is not None else None
            if target is None:
                entries.append(None)
                continue
            taxes = target if isinstance(target, tuple) else (target,)
            taxes = tuple(t for t in taxes if t not in used)
            used.update(taxes)
            if not taxes:
                entries.append(None)
            elif len(taxes) == 1:
                entries.append(taxes[0])
            else:
                entries.append(taxes)
        return PartitionSpec(*entries)

    def sharding(self, mesh: Mesh, logical_axes: Sequence[Optional[str]]) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        a is None or isinstance(a, str) for a in x)


def logical_sharding(mesh: Mesh, strategy: ShardingStrategy, axes_tree: Any):
    """Map a tree of logical-axis tuples to a tree of NamedShardings."""
    if _is_axes(axes_tree):
        return strategy.sharding(mesh, axes_tree)
    if isinstance(axes_tree, dict):
        return {k: logical_sharding(mesh, strategy, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(logical_sharding(mesh, strategy, v) for v in axes_tree)
    return axes_tree


def shard_pytree(tree: Any, axes_tree: Any, mesh: Mesh, strategy: ShardingStrategy):
    """Places a tree per its logical axis annotations: every tensor leaf
    becomes a ShardedTensor. A ``torch.optim.Optimizer`` in the tree (the
    train state's "opt", whose axes ``state_logical_axes`` gives as
    {"exp_avg": p_axes, "exp_avg_sq": p_axes, "step": ()}) is rebuilt over
    the unique shards of the parameters placed in the same call, its
    per-parameter state sliced the same way."""
    placed: dict = {}  # id(tensor) -> ShardedTensor, for the optimizer

    def walk(node, axes):
        import torch

        if isinstance(node, torch.optim.Optimizer):
            return _shard_optimizer(node, placed)
        if isinstance(node, torch.Tensor):
            st = device_put(node, strategy.sharding(mesh, axes))
            placed[id(node)] = st
            return st
        if isinstance(node, ShardedTensor):
            return node.reshard(strategy.spec(axes), mesh)
        if isinstance(node, dict):
            return {k: walk(v, axes[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not _is_axes(axes):
            return type(node)(walk(v, a) for v, a in zip(node, axes))
        return node

    return walk(tree, axes_tree)


def _shard_optimizer(opt, placed: dict):
    """The optimizer over the unique shards of the placed parameters."""
    import torch

    groups, state = [], {}
    for g in opt.param_groups:
        params = []
        for p in g["params"]:
            st = placed.get(id(p))
            if st is None:
                raise ValueError("shard_pytree: the optimizer steps a tensor that was not placed in the same call")
            for s in st.master_slots():
                m = st.locals[s]
                params.append(m)
                old = opt.state.get(p)
                if old:
                    idx = tuple(slice(lo, hi) for lo, hi in st.block(s))
                    state[m] = {k: (v.detach()[idx].to(m.device).clone()
                                    if isinstance(v, torch.Tensor) and v.shape == p.shape else
                                    (v.clone() if isinstance(v, torch.Tensor) else v))
                                for k, v in old.items()}
        groups.append(dict({k: v for k, v in g.items() if k != "params"}, params=params))
    import inspect

    accepted = inspect.signature(type(opt).__init__).parameters
    new = type(opt)(groups, **{k: v for k, v in opt.defaults.items() if k in accepted})
    for m, s in state.items():
        new.state[m] = s
    return new


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]], mesh: Optional[Mesh] = None,
                            strategy: Optional[ShardingStrategy] = None):
    """Reshards a ShardedTensor to the layout the strategy (the active one
    unless given) assigns these logical axes; a no-op outside a strategy
    and on plain tensors."""
    strategy = strategy or _current_strategy()
    if strategy is None or not isinstance(x, ShardedTensor):
        return x
    return x.reshard(strategy.spec(logical_axes), mesh or x.mesh)


def _ambient_mesh() -> Optional[Mesh]:
    """The mesh from an enclosing ``with mesh:`` block, or None."""
    return ambient_mesh()


# A dynamic "current strategy" so model code can annotate activations without
# threading the strategy through every call.
_STRATEGY_STACK: list = []


class use_strategy:
    def __init__(self, strategy: Union[str, ShardingStrategy]):
        self.strategy = ShardingStrategy.named(strategy) if isinstance(strategy, str) else strategy

    def __enter__(self):
        _STRATEGY_STACK.append(self.strategy)
        return self.strategy

    def __exit__(self, *exc):
        _STRATEGY_STACK.pop()


def _current_strategy() -> Optional[ShardingStrategy]:
    return _STRATEGY_STACK[-1] if _STRATEGY_STACK else None
