"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``. The sequence dim of Q, K
and V is sharded over the ``seq`` axis of a mesh of slots; K/V chunks rotate
around the ring with ``ppermute`` while each slot folds every chunk into a
flash-style online-softmax carry (running max m, normaliser l, fp32
accumulator), so no slot ever holds the S x S scores. The ring has no TPU
kernel (the reference's body is blockwise jnp), so this plain torch body is
the port: einsum scores in fp32, the global-position causal mask (slot i's
queries see chunks of slots < i whole, their own causally, later ones not
at all).

One departure that changes no value: under the causal mask a chunk from a
later slot is skipped instead of folded in with every score masked (its
probabilities are exactly 0 and its rescale factor exactly 1, so the carry
is bitwise the same). Dims other than the sequence keep the layout the
inputs have (a batch- or head-sharded ShardedTensor stays so).
"""
from __future__ import annotations

import math
from typing import Optional

NEG_INF = -1e30


def _ring_body(qs, ks, vs, *, axis_name: str, causal: bool, scale: float, n_ring: int):
    """Per-slot lists of local chunks q: [B, S_loc, H, D], k, v: [B, S_loc,
    KV, D] (KV dividing H; the chunks rotate with their KV heads and each
    serves H/KV query heads)."""
    import torch

    from ray_tpu_torch.parallel._shard_map import axis_index, ppermute

    my = axis_index(axis_name)
    n = len(qs)
    state = []
    for s in range(n):
        B, S_loc, H, D = qs[s].shape
        dev = qs[s].device
        state.append([qs[s].float(),
                      torch.full((B, H, S_loc), NEG_INF, dtype=torch.float32, device=dev),
                      torch.zeros((B, H, S_loc), dtype=torch.float32, device=dev),
                      torch.zeros((B, S_loc, H, D), dtype=torch.float32, device=dev)])
    perm = [(j, (j + 1) % n_ring) for j in range(n_ring)]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n_ring):
        for s in range(n):
            src = (my[s] - t) % n_ring  # whose chunk slot s holds at step t
            if causal and src > my[s]:
                continue  # every score masked: the carry would not change
            qf, m, l, acc = state[s]
            S_loc, H = qf.shape[1], qf.shape[2]
            kf, vf = k_cur[s].float(), v_cur[s].float()
            if kf.shape[2] != H:
                kf, vf = (x.repeat_interleave(H // x.shape[2], dim=2) for x in (kf, vf))
            sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
            if causal:
                q_pos = my[s] * S_loc + torch.arange(S_loc, device=qf.device)[:, None]
                k_pos = src * S_loc + torch.arange(S_loc, device=qf.device)[None, :]
                sc = sc.masked_fill(~(q_pos >= k_pos)[None, None], NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, vf)
            acc = acc * alpha.transpose(1, 2)[..., None] + pv
            state[s] = [qf, m_new, l, acc]
        if t < n_ring - 1:
            k_cur = ppermute(k_cur, axis_name, perm)
            v_cur = ppermute(v_cur, axis_name, perm)
    out = []
    for s in range(n):
        _qf, _m, l, acc = state[s]
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out.append((acc / l_safe.transpose(1, 2)[..., None]).to(qs[s].dtype))
    return out


def seq_spec(x, axis_name: str, seq_dim: int = 1):
    """The spec of ``x`` (a ShardedTensor, else replicated) with its
    sequence dim over ``axis_name`` and its other dims as they are."""
    from ray_tpu_torch.parallel.sharding import PartitionSpec, ShardedTensor

    ndim = len(x.shape)
    base = list(x.spec) + [None] * (ndim - len(x.spec)) if isinstance(x, ShardedTensor) else [None] * ndim
    base[seq_dim] = axis_name
    return PartitionSpec(*base)


def _mesh_of(mesh, *xs):
    from ray_tpu_torch.parallel.sharding import ShardedTensor, _ambient_mesh

    if mesh is not None:
        return mesh
    for x in xs:
        if isinstance(x, ShardedTensor):
            return x.mesh
    return _ambient_mesh()


def dense_fallback(fn, q, *args):
    """``fn`` on the gathered inputs; a ShardedTensor ``q`` gets its
    result back in its own layout."""
    from ray_tpu_torch.parallel._shard_map import _split
    from ray_tpu_torch.parallel.sharding import ShardedTensor

    full = [a.full() if isinstance(a, ShardedTensor) else a for a in (q, *args)]
    out = fn(*full)
    if isinstance(q, ShardedTensor):
        return ShardedTensor(_split(out, q.mesh, q.spec), q.sharding, q.shape)
    return out


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = True, scale: Optional[float] = None,
                   mesh=None):
    """Exact attention with Q/K/V sequence-sharded over ``axis_name``.

    q: global [B, S, H, D], k/v: [B, S, KV, D] with KV dividing H (grouped
    K/V as they are), tensors or ShardedTensors, S divisible by the axis
    size. Falls back to the dense reference when the axis is absent or
    trivial."""
    import functools

    from ray_tpu_torch.ops.attention import mha_reference
    from ray_tpu_torch.parallel._shard_map import shard_map

    D = q.shape[-1]
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} not divisible by kv_heads {k.shape[2]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    mesh = _mesh_of(mesh, q, k, v)
    if mesh is None or axis_name not in mesh.shape or mesh.shape[axis_name] == 1:
        return dense_fallback(lambda a, b, c: mha_reference(a, b, c, causal=causal, scale=scale), q, k, v)
    n_ring = mesh.shape[axis_name]
    body = functools.partial(_ring_body, axis_name=axis_name, causal=causal, scale=scale, n_ring=n_ring)
    spec = seq_spec(q, axis_name)
    return shard_map(body, mesh=mesh, in_specs=(spec, seq_spec(k, axis_name), seq_spec(v, axis_name)),
                     out_specs=spec)(q, k, v)
