"""Pipeline parallelism: the GPipe microbatch schedule over the stage axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``. Stage-stacked parameters
are sharded ``PartitionSpec("stage", ...)`` (the ``ShardingStrategy.pp()``
rule), and one ``shard_map`` body runs the reference's schedule: T =
n_micro + n_stages - 1 steps; at step t stage 0 ingests microbatch t, every
other stage takes the activation its predecessor sent at step t - 1
(``ppermute``), and the last stage keeps its finished microbatch. The last
stage's outputs are then broadcast over the stage axis. The backward comes
from autograd through the same graph (each ppermute's transpose is the
reverse hop), so gradients accumulate over the microbatches as in the
reference's differentiated scan.

Where the reference runs every stage at every step (static shapes; the
fill and drain steps compute on repeated or zero inputs whose outputs are
never selected), the port runs stage i at step t only when 0 <= t - i <
n_micro: the same outputs and gradients, without the bubble's arithmetic.

Layout contract (the reference's):
- ``stage_params``: pytree whose leaves have leading dim n_stages x layers
  per stage, sharded over ``axis_name`` on dim 0.
- ``x``: [n_micro, mb, ...]; ``x_spec`` its PartitionSpec over the
  non-stage axes (e.g. P(None, "data")), default replicated.
- ``stage_fn(params_slice, h) -> h``: one layer group's compute.
"""
from __future__ import annotations

from typing import Any, Callable


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def pipeline_apply(stage_fn: Callable, stage_params: Any, x, *, mesh, axis_name: str = "stage", x_spec=None):
    """Runs the staged computation; returns [n_micro, mb, ...] outputs."""
    import torch

    from ray_tpu_torch.parallel._shard_map import shard_map
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    n_stages = mesh.shape[axis_name]
    if n_stages == 1:
        def apply_all(h):
            for i in range(_first_leaf(stage_params).shape[0]):
                h = stage_fn(_tree_map(lambda p: p[i], stage_params), h)
            return h

        full = x.full() if hasattr(x, "full") else x
        return torch.stack([apply_all(full[j]) for j in range(full.shape[0])])

    n_micro = x.shape[0]
    x_spec = P() if x_spec is None else x_spec
    param_specs = _tree_map(lambda _: P(axis_name), stage_params)

    def body(params, xs):
        return _pipeline_body(params, xs, stage_fn=stage_fn, axis_name=axis_name, n_stages=n_stages,
                              n_micro=n_micro, mesh=mesh)

    return shard_map(body, mesh=mesh, in_specs=(param_specs, x_spec), out_specs=x_spec)(stage_params, x)


def _pipeline_body(params: list, xs: list, *, stage_fn, axis_name, n_stages, n_micro, mesh):
    """Per-slot body. params[s]: the slot's layer groups [L_local, ...];
    xs[s]: its [n_micro, mb, ...] input."""
    import torch

    from ray_tpu_torch.parallel._shard_map import axis_index, groups, ppermute

    idx = axis_index(axis_name)
    n = len(xs)
    T = n_micro + n_stages - 1

    def apply_stage(p, h):
        for i in range(_first_leaf(p).shape[0]):
            h = stage_fn(_tree_map(lambda a: a[i], p), h)
        return h

    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    recv = [None] * n
    outputs = [[] for _ in range(n)]
    for t in range(T):
        h_out = [None] * n
        for s in range(n):
            m = t - idx[s]  # the microbatch stage idx[s] holds at step t
            if not 0 <= m < n_micro:
                continue  # fill or drain: nothing to compute here
            h_in = xs[s][m] if idx[s] == 0 else recv[s]
            h_out[s] = apply_stage(params[s], h_in)
            if idx[s] == n_stages - 1:
                outputs[s].append(h_out[s])
        filler = next(h for h in h_out if h is not None)
        sent = [h if h is not None else torch.zeros_like(filler) for h in h_out]
        recv = ppermute(sent, axis_name, fwd_perm)
    # Only the last stage holds real outputs: broadcast them over the stage
    # axis (autograd's transpose sums the stages' cotangents back onto it).
    devs = mesh.slot_devices
    done: dict = {}
    out = []
    for s, (members, _j) in enumerate(groups(mesh, axis_name)):
        last = members[n_stages - 1]
        if last not in done:
            done[last] = torch.stack(outputs[last])
        out.append(done[last].to(devs[s]))
    return out
