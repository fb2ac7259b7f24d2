"""The port's SPMD executor and collectives over the slots of a mesh.

``shard_map(f, mesh=, in_specs=, out_specs=)`` hands ``f`` the per-slot
local values: each argument becomes a list with one entry per slot (a
tensor, or the local pytree of a pytree argument), in flat slot order.
``f`` runs ONCE and returns per-slot lists; a body that needs a collective
partway through is written as phases over all slots (compute on every slot,
then the collective, then compute), never one thread per slot.

The collectives are the ones the reference's bodies use (``axis_index``,
``psum``, ``all_gather``, ``all_to_all``, ``ppermute``), written as
differentiable torch ops over the group of slots along one mesh axis (or a
tuple of axes): ``torch.cat``, sums in fixed slot order, ``.to(device)``.
All slots live in one autograd graph, so ``backward()`` yields their
transposes (ppermute's reverse hop, all_gather's reduce-scatter, a
broadcast's sum) with no hand-written backward. This is PyTorch's own
single-process multi-device idiom (``torch.nn.parallel``'s replicate,
scatter and gather); there is no NCCL and no ``torch.distributed``. Slots
of one group on one device share a collective's result (one tensor).
"""
from __future__ import annotations

import functools
from typing import Any, Optional

from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import PartitionSpec, ShardedTensor, entry_axes, from_locals, slot_blocks

_SHARD_MAP_STACK: list = []


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None:
        return mesh
    if not _SHARD_MAP_STACK:
        raise RuntimeError("a collective outside shard_map needs mesh=")
    return _SHARD_MAP_STACK[-1]


def _axes(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def groups(mesh: Mesh, axis_name) -> tuple:
    """For each slot: its group along ``axis_name`` (the slots that differ
    from it only on those axes), ordered by position on them, and its own
    position in that group."""
    return _groups(mesh, _axes(axis_name))


@functools.lru_cache(maxsize=1024)
def _groups(mesh: Mesh, axes: tuple) -> tuple:
    by_key: dict = {}
    pos = []
    for s in range(mesh.size):
        c = mesh.coords(s)
        key = tuple(v for a, v in c.items() if a not in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + int(c[a])
        by_key.setdefault(key, {})[idx] = s
        pos.append((key, idx))
    out = []
    for key, idx in pos:
        g = by_key[key]
        out.append((tuple(g[i] for i in sorted(g)), idx))
    return tuple(out)


def per_slot(fn, *lists) -> list:
    """``fn`` at every slot, on the slot's entry of each list; slots whose
    arguments are the same objects (the replicated values of one device)
    share one result, so replicated work runs once per device."""
    memo: dict = {}
    out = []
    for s in range(len(lists[0])):
        args = tuple(lst[s] for lst in lists)
        key = tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def axis_index(axis_name, mesh: Optional[Mesh] = None) -> list:
    """Each slot's position along ``axis_name``."""
    return [idx for _g, idx in groups(_mesh(mesh), axis_name)]


def _per_device(mesh: Mesh, axis_name, make):
    """Runs ``make(members, device)`` once per (group, device) and hands
    every slot the result for its group and device."""
    devs = mesh.slot_devices
    cache: dict = {}
    out = []
    for s, (members, _idx) in enumerate(groups(mesh, axis_name)):
        key = (tuple(members), str(devs[s]))
        if key not in cache:
            cache[key] = make(members, devs[s])
        out.append(cache[key])
    return out


def psum(xs: list, axis_name, mesh: Optional[Mesh] = None) -> list:
    """Sum over the group, in fp32 and in slot order (bitwise repeatable
    whatever the devices), cast back to the input dtype."""
    import torch

    mesh = _mesh(mesh)

    def make(members, dev):
        if len(members) == 1:
            return xs[members[0]].to(dev)
        dt = xs[members[0]].dtype
        acc = xs[members[0]].to(dev).to(torch.float32)
        for m in members[1:]:
            acc = acc + xs[m].to(dev).to(torch.float32)
        return acc.to(dt)

    return _per_device(mesh, axis_name, make)


def all_gather(xs: list, axis_name, axis: int = 0, tiled: bool = True, mesh: Optional[Mesh] = None) -> list:
    """The group's locals concatenated along ``axis`` (stacked on a new
    leading axis when not ``tiled``)."""
    import torch

    mesh = _mesh(mesh)

    def make(members, dev):
        parts = [xs[m].to(dev) for m in members]
        if len(parts) == 1:
            return parts[0] if tiled else parts[0].unsqueeze(axis)
        return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)

    return _per_device(mesh, axis_name, make)


def all_to_all(xs: list, axis_name, split_axis: int, concat_axis: int, tiled: bool = True,
               mesh: Optional[Mesh] = None) -> list:
    """Member j receives chunk j of every member's local (split along
    ``split_axis``), concatenated along ``concat_axis`` in member order."""
    import torch

    if not tiled:
        raise NotImplementedError("all_to_all(tiled=False)")
    mesh = _mesh(mesh)
    devs = mesh.slot_devices
    out = []
    for s, (members, j) in enumerate(groups(mesh, axis_name)):
        n = len(members)
        parts = [xs[m].chunk(n, dim=split_axis)[j].to(devs[s]) for m in members]
        out.append(parts[0].contiguous() if n == 1 else torch.cat(parts, dim=concat_axis))
    return out


def ppermute(xs: list, axis_name, perm, mesh: Optional[Mesh] = None) -> list:
    """Member dst receives member src's local for each (src, dst) in
    ``perm``; a member that is no one's destination receives zeros."""
    import torch

    mesh = _mesh(mesh)
    devs = mesh.slot_devices
    src_of = {d: s for s, d in perm}
    out = []
    for s, (members, j) in enumerate(groups(mesh, axis_name)):
        if j in src_of:
            out.append(xs[members[src_of[j]]].to(devs[s]))
        else:
            out.append(torch.zeros_like(xs[s]))
    return out


def assemble(locals_: list, blocks: list, box: tuple, device, prefer: Optional[int] = None):
    """The region ``box`` (a (lo, hi) per dim) of a global array whose slot
    s holds block ``blocks[s]``, as one tensor on ``device``: the pieces
    come from the holders of the blocks it crosses (``prefer``, then a
    holder on ``device``, then the first) and are concatenated dim by dim.
    Differentiable."""
    import torch

    ndim = len(box)
    holders: dict = {}
    for s, b in enumerate(blocks):
        holders.setdefault(b, []).append(s)
    any_block = blocks[0]
    sizes = [hi - lo for lo, hi in any_block]
    cuts = []
    for d in range(ndim):
        lo, hi = box[d]
        bs = sizes[d]
        if bs == 0 or hi <= lo:
            cuts.append([(0, lo, hi)])
            continue
        cuts.append([(j, max(lo, j * bs), min(hi, (j + 1) * bs)) for j in range(lo // bs, (hi - 1) // bs + 1)])

    def piece(combo):
        blk = tuple((j * sizes[d], (j + 1) * sizes[d]) for d, (j, _a, _b) in enumerate(combo))
        hs = holders[blk]
        h = prefer if prefer in hs else next(
            (x for x in hs if str(locals_[x].device) == str(device)), hs[0])
        t = locals_[h]
        idx = tuple(slice(a - blk[d][0], b - blk[d][0]) for d, (_j, a, b) in enumerate(combo))
        whole = all(a == blk[d][0] and b == blk[d][1] for d, (_j, a, b) in enumerate(combo))
        return (t if whole else t[idx]).to(device)

    def build(d, prefix):
        if d == ndim:
            return piece(prefix)
        parts = [build(d + 1, prefix + (c,)) for c in cuts[d]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return build(0, ())


def reshard(xs: list, mesh: Mesh, src_spec, dst_spec, shape, dst_mesh: Optional[Mesh] = None) -> list:
    """Per-slot locals of a global array under ``src_spec`` -> its locals
    under ``dst_spec``: each slot slices or gathers what its new block
    needs; slots of one device that need the same block share it."""
    dst_mesh = dst_mesh or mesh
    if dst_mesh is mesh and _same(src_spec, dst_spec, len(shape)):
        return list(xs)
    src = slot_blocks(mesh, src_spec, shape)
    dst = slot_blocks(dst_mesh, dst_spec, shape)
    devs = dst_mesh.slot_devices
    cache: dict = {}
    out = []
    for t in range(dst_mesh.size):
        key = (dst[t], str(devs[t]))
        if key not in cache:
            cache[key] = assemble(xs, src, dst[t], devs[t], prefer=t)
        out.append(cache[key])
    return out


def _same(a, b, ndim: int) -> bool:
    def norm(spec):
        spec = tuple(entry_axes(e) for e in spec)
        return spec + ((),) * (ndim - len(spec))

    return norm(a) == norm(b)


def _split(x, mesh: Mesh, spec) -> list:
    """A global tensor's per-slot locals (differentiable slices)."""
    blocks = slot_blocks(mesh, spec, tuple(x.shape))
    devs = mesh.slot_devices
    cache: dict = {}
    out = []
    for s in range(mesh.size):
        key = (blocks[s], str(devs[s]))
        if key not in cache:
            cache[key] = x[tuple(slice(lo, hi) for lo, hi in blocks[s])].to(devs[s]).contiguous()
        out.append(cache[key])
    return out


def _is_spec(x) -> bool:
    return x is None or isinstance(x, PartitionSpec)


def _to_locals(value: Any, spec: Any, mesh: Mesh, seen: list) -> list:
    """One argument -> its list of per-slot local values."""
    import torch

    if isinstance(value, ShardedTensor):
        # Through the master shards (slot_param), so gradients reach them
        # whatever device a replica sits on.
        seen.append(True)
        sp = spec if spec is not None else PartitionSpec()
        if value.mesh != mesh:
            raise ValueError("shard_map over a ShardedTensor of another mesh")
        return reshard(value.param_locals(), mesh, value.spec, sp, value.shape)
    if isinstance(value, torch.Tensor):
        return _split(value, mesh, spec if spec is not None else PartitionSpec())
    if isinstance(value, dict):
        per = {k: _to_locals(v, spec[k] if isinstance(spec, dict) else spec, mesh, seen) for k, v in value.items()}
        return [{k: per[k][s] for k in per} for s in range(mesh.size)]
    if isinstance(value, (list, tuple)):
        specs = spec if isinstance(spec, (list, tuple)) and not _is_spec(spec) else [spec] * len(value)
        per = [_to_locals(v, sp, mesh, seen) for v, sp in zip(value, specs)]
        return [type(value)(p[s] for p in per) for s in range(mesh.size)]
    return [value] * mesh.size


def shard_map(f, *, mesh: Mesh, in_specs, out_specs):
    """SPMD over the slots of ``mesh``: ``f`` takes one list of per-slot
    locals per argument (split per ``in_specs``; a ShardedTensor argument is
    resharded to its spec) and returns a list of per-slot locals (a tuple of
    lists for a tuple of ``out_specs``). The outputs are ShardedTensors when
    any input was one, else gathered tensors, as jax's global arrays."""

    def wrapped(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) and not _is_spec(in_specs) else (in_specs,)
        seen: list = []
        local_args = [_to_locals(a, sp, mesh, seen) for a, sp in zip(args, specs)]
        _SHARD_MAP_STACK.append(mesh)
        try:
            outs = f(*local_args)
        finally:
            _SHARD_MAP_STACK.pop()

        def out(locals_, sp):
            st = from_locals(list(locals_), mesh, sp if sp is not None else PartitionSpec())
            return st if seen else st.full()

        if _is_spec(out_specs):
            return out(outs, out_specs)
        return type(out_specs)(out(o, sp) for o, sp in zip(outs, out_specs))

    return wrapped
