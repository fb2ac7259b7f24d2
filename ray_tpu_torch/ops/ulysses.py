"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head resharding.

Counterpart of ``ray_tpu/ops/ulysses.py``. Activations arrive sequence-
sharded [B, S/n, H, D]; one ``all_to_all`` per tensor swaps the sharded dim
from sequence to heads [B, S, H/n, D] (K/V keep their KV heads: native GQA),
the segment ids are all-gathered, each slot runs the port's
``flash_attention`` over the full sequence for its head group (kernel K1
forward, K3/K2 backward on CUDA tensors; the plain version on the CPU), and
a final ``all_to_all`` restores sequence sharding. The dispatch is the
reference's: the dense reference off the mesh; ring attention when H or KV
is not divisible by the axis size; the dense reference for packed segments
in that case (the ring has no segment mask).
"""
from __future__ import annotations

import math
from typing import Optional


def _ulysses_body(qs, ks, vs, segs, *, axis_name: str, causal: bool, scale: float):
    """Per-slot lists. q: [B, S_loc, H, D]; k/v: [B, S_loc, KV, D]; seg:
    [B, S_loc] or None."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel._shard_map import all_gather, all_to_all

    # Scatter heads, gather sequence: [B, S/n, H, D] -> [B, S, H/n, D].
    qg, kg, vg = (all_to_all(x, axis_name, split_axis=2, concat_axis=1) for x in (qs, ks, vs))
    seg_g = all_gather(segs, axis_name, axis=1) if segs is not None else [None] * len(qs)
    o = [flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=sg)
         for q, k, v, sg in zip(qg, kg, vg, seg_g)]
    # Back: scatter sequence, gather heads: [B, S, H/n, D] -> [B, S/n, H, D].
    return all_to_all(o, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, axis_name: str = "seq", causal: bool = True, scale: Optional[float] = None,
                      mesh=None, segment_ids=None):
    """Exact attention with Q/K/V sequence-sharded over ``axis_name``.

    q: global [B, S, H, D]; k/v: [B, S, KV, D] (KV heads never repeated on
    this path); segment_ids: optional [B, S]. Plain tensors or
    ShardedTensors. Both H and KV must be divisible by the axis size;
    otherwise this falls back to ring attention (or, with segments, the
    dense reference)."""
    import functools

    from ray_tpu_torch.ops.attention import mha_reference
    from ray_tpu_torch.ops.ring_attention import _mesh_of, dense_fallback, ring_attention, seq_spec
    from ray_tpu_torch.parallel._shard_map import shard_map

    H, D = q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    mesh = _mesh_of(mesh, q, k, v, segment_ids)

    def dense(a, b, c, sg=None):
        return mha_reference(a, b, c, causal=causal, scale=scale, segment_ids=sg)

    if mesh is None or axis_name not in mesh.shape or mesh.shape[axis_name] == 1:
        return dense_fallback(dense, q, k, v, segment_ids)
    n = mesh.shape[axis_name]
    if H % n or KV % n:
        if segment_ids is not None:
            return dense_fallback(dense, q, k, v, segment_ids)
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal, scale=scale, mesh=mesh)

    spec = seq_spec(q, axis_name)
    body = functools.partial(_ulysses_body, axis_name=axis_name, causal=causal, scale=scale)
    specs = (spec, seq_spec(k, axis_name), seq_spec(v, axis_name))
    if segment_ids is None:
        return shard_map(lambda a, b, c: body(a, b, c, None), mesh=mesh, in_specs=specs, out_specs=spec)(q, k, v)
    return shard_map(body, mesh=mesh, in_specs=specs + (seq_spec(segment_ids, axis_name),),
                     out_specs=spec)(q, k, v, segment_ids)
