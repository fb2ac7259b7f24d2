"""The sharded training loss: the transformer computed per slot of a mesh.

The reference trains beyond one chip by compiling its one ``train_step``
under ``in_shardings`` (GSPMD inserts the collectives). The port's
counterpart is this SPMD program, run by ``make_train_step``'s step when the
state's parameters are ShardedTensors (``shard_pytree``) and by
``make_pipeline_train_step``. Every slot computes its own part, in phases
over all slots with the collectives of ``parallel/_shard_map.py`` between
them; autograd through the one graph gives the gradients:

- batch rows: the slot's block of the batch (``replica`` / ``data`` /
  ``fsdp``), and its sequence chunk (``seq``, attention by ring or Ulysses
  attention over that axis, RoPE at global positions);
- ``tensor`` (Megatron): the slot's heads, KV heads and FFN columns
  (column-parallel ``wq/wk/wv/w_gate/w_up``, row-parallel ``wo/w_down``
  each followed by a psum), its slice of the vocabulary (a masked embedding
  lookup plus a psum; the logits gathered over the vocab shards for the
  cross-entropy);
- ``expert``: the slot's experts, their outputs combined and psum'd;
- ``fsdp`` (ZeRO-3): weights sharded along ``embed`` are all-gathered per
  layer (autograd's transpose is the reduce-scatter of their gradients).

The activation layouts between layers are the ones the reference's model
pins with ``with_logical_constraint``: the residual stream (batch, seq,
embed), q/k/v and the attention output (batch, seq, heads, head_dim), the
FFN hidden (batch, seq, mlp). Work that slots of one device would repeat on
the same inputs (the replicated parts of a tensor-parallel layer) runs once
and is shared (``_per_slot``). The loss is the global mean over the tokens;
each slot's contribution is counted once.
"""
from __future__ import annotations

import warnings

import torch

from ray_tpu_torch.parallel._shard_map import _same, _split, psum, reshard
from ray_tpu_torch.parallel._shard_map import per_slot as _per_slot
from ray_tpu_torch.parallel.sharding import (
    PartitionSpec,
    ShardedTensor,
    _current_strategy,
    entry_axes,
    from_locals,
    slot_blocks,
)


def _leaf_locals(leaf, mesh, spec) -> list:
    """Per-slot views of a parameter leaf under ``spec``: a ShardedTensor's
    master shards (differentiable back to them), or slices of a plain
    tensor. Slots of one device holding one block get one object."""
    if isinstance(leaf, ShardedTensor):
        if not _same(leaf.spec, spec, leaf.ndim):
            raise ValueError(f"parameter layout {leaf.spec} where the step expects {spec}")
        return leaf.param_locals()
    return _split(leaf, mesh, spec)


def batch_locals(x, mesh, spec) -> list:
    """A batch tensor (plain or ShardedTensor) as per-slot locals under ``spec``."""
    if isinstance(x, ShardedTensor):
        return list(x.reshard(spec, mesh).locals)
    return _split(torch.as_tensor(x), mesh, spec)


class Layout:
    """Which mesh axes shard what, read off the parameters' specs and the
    active strategy (or the batch's spec)."""

    def __init__(self, params: dict, cfg, mesh, tokens):
        from ray_tpu_torch.models.transformer import param_logical_axes

        self.mesh = mesh
        self.axes = param_logical_axes(cfg)
        self.specs = {"embed": _spec_of(params["embed"]), "final_norm": _spec_of(params["final_norm"]),
                      "lm_head": _spec_of(params["lm_head"]),
                      "layers": {k: _spec_of(v) for k, v in params["layers"].items()}}
        strategy = _current_strategy()
        if strategy is not None:
            act = strategy.spec(("batch", "seq", "embed"))
            b_entry, s_entry = act[0], act[1]
        else:
            tspec = tokens.spec if isinstance(tokens, ShardedTensor) else PartitionSpec()
            b_entry, s_entry = (tuple(tspec) + (None,))[0], None
        live = {a for a, n in mesh.shape.items() if n > 1}
        self.batch_axes = tuple(a for a in entry_axes(b_entry) if a in live)
        self.seq_axes = tuple(a for a in entry_axes(s_entry) if a in live)
        if len(self.seq_axes) > 1:
            raise NotImplementedError(f"the sequence over several mesh axes {self.seq_axes}")
        self.tok_spec = PartitionSpec(self.batch_axes or None, None)
        self.act2 = PartitionSpec(self.batch_axes or None, self.seq_axes[0] if self.seq_axes else None)
        # Compute layouts: dims along "embed" gathered (ZeRO-3), the others as stored.
        self.cspec = {"embed": self._compute(self.specs["embed"], self.axes["embed"]),
                      "final_norm": self._compute(self.specs["final_norm"], self.axes["final_norm"]),
                      "lm_head": self._compute(self.specs["lm_head"], self.axes["lm_head"]),
                      "layers": {k: self._compute(v, self.axes["layers"][k])
                                 for k, v in self.specs["layers"].items()}}
        ls = self.cspec["layers"]
        if entry_axes(ls["attn_norm"][0]):
            raise NotImplementedError("layers sharded over a mesh axis: use make_pipeline_train_step")

        def ax(spec, dim):
            return tuple(a for a in entry_axes(tuple(spec)[dim] if dim < len(spec) else None) if a in live)

        self.head_axes = ax(ls["wq"], 2)
        if ax(ls["wk"], 2) != self.head_axes or ax(ls["wo"], 1) != self.head_axes:
            raise NotImplementedError("heads, kv_heads and wo's heads must be sharded alike")
        self.vocab_axes = ax(self.cspec["embed"], 0)
        if ax(self.cspec["lm_head"], 1) != self.vocab_axes:
            raise NotImplementedError("embed and lm_head must shard the vocabulary alike")
        if cfg.n_experts:
            self.expert_axes = ax(ls["w_gate"], 1)
            self.mlp_axes = ax(ls["w_gate"], 3)
            reduce = self.expert_axes + self.mlp_axes
        else:
            self.expert_axes = ()
            self.mlp_axes = ax(ls["w_gate"], 2)
            reduce = self.mlp_axes
        self.ffn_axes = reduce
        rows = set(self.batch_axes) | set(self.seq_axes)
        for name, axes in (("heads", self.head_axes), ("ffn", reduce), ("vocab", self.vocab_axes)):
            if rows & set(axes):
                raise NotImplementedError(f"{name} and the batch/sequence share mesh axes {rows & set(axes)}")
        # One slot per (batch block, sequence block) counts its tokens' loss.
        self.reps = [s for s in range(mesh.size)
                     if all(int(v) == 0 for a, v in mesh.coords(s).items() if a not in rows)]

    def _compute(self, spec, logical):
        spec = tuple(spec) + (None,) * (len(logical) - len(spec))
        return PartitionSpec(*(None if lg == "embed" else e for e, lg in zip(spec, logical)))


def _spec_of(leaf):
    return leaf.spec if isinstance(leaf, ShardedTensor) else PartitionSpec()


class SpmdModel:
    """The per-slot forward and loss of one step, over a Layout."""

    def __init__(self, params: dict, cfg, layout: Layout):
        self.cfg, self.lo, self.mesh = cfg, layout, layout.mesh
        self.params = params
        self.loc = {"embed": _leaf_locals(params["embed"], self.mesh, layout.specs["embed"]),
                    "final_norm": _leaf_locals(params["final_norm"], self.mesh, layout.specs["final_norm"]),
                    "lm_head": _leaf_locals(params["lm_head"], self.mesh, layout.specs["lm_head"]),
                    "layers": {k: _leaf_locals(v, self.mesh, layout.specs["layers"][k])
                               for k, v in params["layers"].items()}}

    def gathered(self, name):
        """A non-layer leaf's per-slot locals in its compute layout."""
        leaf = self.params[name]
        return reshard(self.loc[name], self.mesh, self.lo.specs[name], self.lo.cspec[name], tuple(leaf.shape))

    def layer(self, i) -> list:
        """Layer i's per-slot parameter dicts in their compute layouts (the
        per-layer all-gather of ZeRO-3)."""
        out = [dict() for _ in range(self.mesh.size)]
        for k, base in self.loc["layers"].items():
            leaf = self.params["layers"][k]
            views = _per_slot(lambda t: t[i], base)
            src = PartitionSpec(*tuple(self.lo.specs["layers"][k])[1:])
            dst = PartitionSpec(*tuple(self.lo.cspec["layers"][k])[1:])
            got = reshard(views, self.mesh, src, dst, tuple(leaf.shape)[1:])
            for s in range(self.mesh.size):
                out[s][k] = got[s]
        # Slots holding the same tensors share one dict, so _per_slot
        # computes their (replicated) work once.
        shared: dict = {}
        return [shared.setdefault(tuple(id(v) for v in d.values()), d) for d in out]

    def embed(self, toks: list) -> list:
        dt = self.cfg.dtype
        table = self.gathered("embed")
        if not self.lo.vocab_axes:
            return _per_slot(lambda w, t: w.to(dt)[t.long()], table, toks)
        blocks = slot_blocks(self.mesh, self.lo.cspec["embed"], tuple(self.params["embed"].shape))
        v0s = [blocks[s][0][0] for s in range(self.mesh.size)]
        return vocab_lookup(table, toks, v0s, self.lo.vocab_axes, self.mesh, dt)


def vocab_lookup(tables: list, toks: list, v0s: list, axes, mesh, dtype) -> list:
    """Token ids -> embedding rows at every slot, the vocabulary sharded
    over ``axes``: each slot looks up the ids inside its block of rows
    [v0, v0 + n) (zero elsewhere), then the psum."""
    def lookup(w, t, v0):
        n = w.shape[0]
        inside = (t >= v0) & (t < v0 + n)
        rows = w.to(dtype)[(t.long() - v0).clamp(0, n - 1)]
        return rows * inside[..., None].to(dtype)

    return psum(_per_slot(lookup, tables, toks, v0s), axes, mesh=mesh)


def add_psum(xs: list, parts: list, axes, mesh) -> list:
    """x + the row-parallel partials summed over ``axes`` (fp32, in slot
    order) at every slot; with no axes each slot adds its own."""
    if axes:
        parts = psum(parts, axes, mesh=mesh)
    return _per_slot(lambda x, p: x + p, xs, parts)


def _attend(cfg, lo: Layout, qs, ks, vs, segs):
    """Attention per slot, or over the sequence axis."""
    from ray_tpu_torch.models.transformer import _attention
    from ray_tpu_torch.ops.attention import mha_reference
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    impl = cfg.attention_impl
    if not lo.seq_axes:
        if impl in ("ring", "ulysses"):  # a trivial axis: the dense reference, as the reference falls back
            if impl == "ring" and segs[0] is not None:
                raise NotImplementedError("ring attention does not support segment_ids")
            return _per_slot(lambda q, k, v, sg: mha_reference(q, k, v, causal=True, segment_ids=sg), qs, ks, vs, segs)
        return _per_slot(lambda q, k, v, sg: _attention(q, k, v, cfg, sg), qs, ks, vs, segs)
    mesh, axis = lo.mesh, lo.seq_axes[0]
    spec = PartitionSpec(lo.batch_axes or None, axis, lo.head_axes or None, None)
    q, k, v = (from_locals(x, mesh, spec) for x in (qs, ks, vs))
    sg = None if segs[0] is None else from_locals(segs, mesh, lo.act2)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, axis_name=axis, causal=True, segment_ids=sg).locals
    if impl == "ring":
        if sg is not None:
            raise NotImplementedError("ring attention does not support segment_ids")
        return ring_attention(q, k, v, axis_name=axis, causal=True).locals
    # Any other attention over a sharded sequence: gather it, attend per slot, split it back.
    whole = PartitionSpec(lo.batch_axes or None, None, lo.head_axes or None, None)
    qg, kg, vg = (x.reshard(whole).locals for x in (q, k, v))
    sgg = [None] * mesh.size if sg is None else sg.reshard(PartitionSpec(lo.batch_axes or None, None)).locals
    o = _per_slot(lambda a, b, c, d: _attention(a, b, c, cfg, d), qg, kg, vg, sgg)
    return from_locals(o, mesh, whole).reshard(spec).locals


def _layer_spmd(xs, lps, pos, segs, *, cfg, lo: Layout, blocks_e):
    """One decoder block on every slot -> (xs, per-slot MoE aux)."""
    from ray_tpu_torch.models.transformer import attn_proj, out_proj, rms_norm, rope

    mesh = lo.mesh
    ln = [lp["attn_norm"] for lp in lps]
    h = _per_slot(rms_norm, xs, ln)
    qkv = _per_slot(lambda hh, lp: attn_proj(hh, lp), h, lps)
    qs = _per_slot(lambda t, p: rope(t[0], p, cfg.rope_theta), qkv, pos)
    ks = _per_slot(lambda t, p: rope(t[1], p, cfg.rope_theta), qkv, pos)
    vs = [t[2] for t in qkv]
    o = _attend(cfg, lo, qs, ks, vs, segs)
    xs = add_psum(xs, _per_slot(lambda oo, lp: out_proj(oo, lp["wo"]), o, lps), lo.head_axes, mesh)
    h = _per_slot(rms_norm, xs, [lp["ffn_norm"] for lp in lps])
    if cfg.n_experts:
        return _moe_spmd(xs, h, lps, cfg=cfg, lo=lo, blocks_e=blocks_e)
    from ray_tpu_torch.models.transformer import dense_ffn

    zero = [torch.zeros((), dtype=torch.float32, device=d) for d in mesh.slot_devices]
    return add_psum(xs, _per_slot(dense_ffn, h, lps), lo.ffn_axes, mesh), zero


def _moe_spmd(xs, h, lps, *, cfg, lo: Layout, blocks_e):
    """Top-k routed MoE on every slot's experts; the Switch aux loss from
    batch-wide means (sums psum'd over the batch and sequence axes)."""
    from ray_tpu_torch.models.transformer import linear

    mesh = lo.mesh
    E, K = cfg.n_experts, cfg.expert_top_k

    def route(x, lp):
        weights = torch.softmax(linear(x, lp["router"]).float(), dim=-1)
        top_w, top_idx = torch.topk(weights, K, dim=-1)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        r = (torch.nn.functional.one_hot(top_idx, E).float() * top_w[..., None]).sum(dim=2).to(x.dtype)
        return weights, top_idx, r

    routed = _per_slot(route, h, lps)

    def experts(x, lp, rt, e0):
        dt = x.dtype
        gate = torch.einsum("bsd,edf->ebsf", x, lp["w_gate"].to(dt))
        up = torch.einsum("bsd,edf->ebsf", x, lp["w_up"].to(dt))
        hh = torch.nn.functional.silu(gate) * up
        out = torch.einsum("ebsf,efd->ebsd", hh, lp["w_down"].to(dt))
        n = out.shape[0]
        return torch.einsum("ebsd,bse->bsd", out, rt[2][..., e0:e0 + n])

    part = _per_slot(experts, h, lps, routed, [blocks_e[s] for s in range(mesh.size)])
    xs = add_psum(xs, part, lo.ffn_axes, mesh)
    sums = _per_slot(lambda rt: torch.stack([
        rt[0].sum(dim=(0, 1)),
        torch.nn.functional.one_hot(rt[1][..., 0], E).float().sum(dim=(0, 1)),
        torch.full((E,), float(rt[1].shape[0] * rt[1].shape[1]), device=rt[0].device)]), routed)
    rows = lo.batch_axes + lo.seq_axes
    tot = psum(sums, rows, mesh=mesh) if rows else sums
    aux = _per_slot(lambda t: E * ((t[0] / t[2]) * (t[1] / t[2])).sum(), tot)
    return xs, aux


def _ce_sum(hs: list, heads: list, targets, mask, chunk: int):
    """(sum of nll * mask, sum of mask) of one (batch, sequence) block from
    the vocab shards' hidden states and head columns: each shard's logits
    on its own device, gathered along the vocabulary on the targets'."""
    from ray_tpu_torch.models.transformer import _nll, linear
    from torch.utils.checkpoint import checkpoint

    dev = targets.device

    def chunk_sum(hh, hd, t, m):
        parts = [linear(x, w).to(dev) for x, w in zip(hh, hd)]
        logits = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return (_nll(logits, t) * m).sum(), m.sum()

    S = targets.shape[1]
    if not chunk or S % chunk:
        return chunk_sum(hs, heads, targets, mask)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        s_i, c_i = checkpoint(chunk_sum, [x[:, sl] for x in hs], heads, targets[:, sl], mask[:, sl],
                              use_reentrant=False)
        tot = tot + s_i
        cnt = cnt + c_i
    return tot, cnt


def _rows(batch, key, lo: Layout):
    """A [B, S+1] batch entry as per-slot locals in the tokens' layout."""
    x = batch.get(key)
    return None if x is None else batch_locals(x, lo.mesh, lo.tok_spec)


def sharded_loss(params: dict, batch: dict, cfg):
    """The training loss of ``cross_entropy_loss`` over ShardedTensor
    parameters, computed per slot; a scalar on slot 0's device."""
    from ray_tpu_torch.models.transformer import _layer_body_fn, rms_norm

    mesh = params["embed"].mesh
    lo = Layout(params, cfg, mesh, batch["tokens"])
    model = SpmdModel(params, cfg, lo)
    n = mesh.size
    toks = _rows(batch, "tokens", lo)
    B, S1 = batch["tokens"].shape
    S = S1 - 1
    segs_t, pos_t, mask_t = _rows(batch, "segment_ids", lo), _rows(batch, "positions", lo), _rows(batch, "mask", lo)

    def cut(xs, sl):
        return None if xs is None else _per_slot(lambda t: t[:, sl].contiguous(), xs)

    inputs, targets = cut(toks, slice(None, -1)), cut(toks, slice(1, None))
    mask = None if mask_t is None else _per_slot(lambda t: t[:, 1:].float(), mask_t)
    if segs_t is not None:
        boundary = _per_slot(lambda t: (t[:, 1:] == t[:, :-1]).float(), segs_t)
        mask = boundary if mask is None else _per_slot(lambda a, b: a * b, mask, boundary)
    if mask is None:
        mask = _per_slot(lambda t: torch.ones(t.shape, dtype=torch.float32, device=t.device), targets)
    # The residual stream's layout (batch, seq): the reference's constraint
    # on the embedded tokens. Positions are global under seq sharding.
    shape2 = (B, S)
    inputs, targets, mask = (reshard(x, mesh, lo.tok_spec, lo.act2, shape2) for x in (inputs, targets, mask))
    segs = [None] * n if segs_t is None else reshard(cut(segs_t, slice(None, -1)), mesh, lo.tok_spec, lo.act2, shape2)
    if pos_t is not None:
        pos = reshard(cut(pos_t, slice(None, -1)), mesh, lo.tok_spec, lo.act2, shape2)
    else:
        blocks = slot_blocks(mesh, lo.act2, shape2)
        pos = _per_slot(lambda t, s0: (s0 + torch.arange(t.shape[1], dtype=torch.int32, device=t.device)).expand(t.shape),
                        inputs, [blocks[s][1][0] for s in range(n)])
    if cfg.ce_chunk and S % cfg.ce_chunk:
        warnings.warn(
            f"ce_chunk={cfg.ce_chunk} does not divide the train seq length {S}; falling back to MATERIALIZED "
            f"logits ([B,S,V] on the device) - a run sized around chunked CE may OOM here", stacklevel=3)
    xs = model.embed(inputs)
    blocks_e = None
    if cfg.n_experts:
        wg = params["layers"]["w_gate"]
        eb = slot_blocks(mesh, PartitionSpec(*tuple(lo.cspec["layers"]["w_gate"])[1:]), tuple(wg.shape)[1:])
        blocks_e = [eb[s][0][0] for s in range(n)]
    body = _layer_body_fn(cfg, _layer_spmd)
    aux = [torch.zeros((), dtype=torch.float32, device=d) for d in mesh.slot_devices]
    for i in range(cfg.n_layers):
        xs, a = body(xs, model.layer(i), pos, segs, cfg=cfg, lo=lo, blocks_e=blocks_e)
        aux = _per_slot(lambda x, y: x + y, aux, a)
    hs = _per_slot(rms_norm, xs, model.gathered("final_norm"))
    heads = [h.to(cfg.dtype) for h in model.gathered("lm_head")]
    chunk = cfg.ce_chunk if (cfg.ce_chunk and S % cfg.ce_chunk == 0) else 0
    from ray_tpu_torch.parallel._shard_map import groups

    vgroups = groups(mesh, lo.vocab_axes) if lo.vocab_axes else [([s], 0) for s in range(n)]
    dev0 = mesh.slot_devices[0]
    tot = torch.zeros((), dtype=torch.float32, device=dev0)
    cnt = torch.zeros((), dtype=torch.float32, device=dev0)
    for r in lo.reps:
        members = vgroups[r][0]
        s_r, c_r = _ce_sum([hs[m] for m in members], [heads[m] for m in members], targets[r], mask[r],
                           chunk if chunk and targets[r].shape[1] % chunk == 0 else 0)
        tot = tot + s_r.to(dev0)
        cnt = cnt + c_r.to(dev0)
    return tot / cnt.clamp(min=1.0) + 0.01 * aux[0].to(dev0)


def unique_leaves(params: dict) -> list:
    """The tensors an optimizer steps: every ShardedTensor's master shards,
    plain leaves as they are, in the tree's leaf order."""
    from ray_tpu_torch.models.transformer import leaves

    out = []
    for leaf in leaves(params):
        out.extend(leaf.masters() if isinstance(leaf, ShardedTensor) else [leaf])
    return out


def global_norm(tensors: list):
    """sqrt of the sum of squares of the tensors' gradients (each unique
    shard once), on the first one's device."""
    dev = tensors[0].device
    sq = [torch.linalg.vector_norm(t.grad.float()).to(dev) ** 2 for t in tensors if t.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def sync_replicas(params: dict) -> None:
    from ray_tpu_torch.models.transformer import leaves

    for leaf in leaves(params):
        if isinstance(leaf, ShardedTensor):
            leaf.sync_replicas()
