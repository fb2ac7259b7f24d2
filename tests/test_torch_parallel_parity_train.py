"""The port's sharded train steps held against ``ray_tpu``'s sharded steps.

The JAX steps are the reference tests' own (``jax.jit`` under
``in_shardings`` on the 8-device virtual CPU mesh); the port's are the same
``train_step`` over a state placed by ``shard_pytree`` on 8 CPU slots
(``RAY_TPU_TORCH_DEVICE_SLOTS=8``), which computes per slot. Same converted
weights, same batch from a numpy seed, AdamW on both sides
(``optax.adamw(3e-4, weight_decay=0.01)`` / the port's ``adamw``). Tolerances
are the reference tests' own: the loss at rtol 2e-4, grad_norm at rtol 2e-3
and the updated ``wq`` at atol 2e-5 / rtol 2e-4 (the pipeline case at the
reference's rtol 5e-3 / atol 1e-5 for it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JC
from ray_tpu.models import make_train_step as jmake
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import ShardingStrategy as JStrategy
from ray_tpu.parallel import logical_sharding as jlogical
from ray_tpu.parallel import shard_pytree as jshard
from ray_tpu.parallel.sharding import use_strategy as juse
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.models import TransformerConfig, make_pipeline_train_step, make_train_step, state_logical_axes
from ray_tpu_torch.models.transformer import leaves
from ray_tpu_torch.parallel import MeshSpec, ShardingStrategy, device_put, devices, shard_pytree, use_strategy

KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64, attention_impl="reference")


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_SLOTS", "8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread (torch's default of one per core
    oversubscribes the CPU when the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(kw, np_params):
    cfg = TransformerConfig(**kw, dtype=torch.float32)
    init, step = make_train_step(cfg)
    st = init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for dst, src in zip(leaves(st["params"]), leaves(from_numpy_tree(np_params, cfg, device="cpu"))):
            dst.copy_(src)
    return cfg, st, step


def _jax_sharded(kw, strategy, mesh_kw, tokens, tok_axes=("batch", "seq"), pipe=None):
    """The reference test's sharded step: (initial params, metrics, updated wq)."""
    jcfg = JC(**kw, dtype=jnp.float32)
    init, step, axes_fn = jmake(jcfg)
    state = init(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.asarray, state["params"])
    mesh = JMeshSpec(**mesh_kw).build()
    strat = JStrategy.named(strategy)
    axes = axes_fn(state)
    if pipe:
        from ray_tpu.models import make_pipeline_train_step as jpipe

        _, step, _ = jpipe(jcfg, mesh, n_micro=pipe)
    import contextlib

    # The reference's pipeline test runs under the mesh alone (its stage body
    # is a shard_map, where the model's constraints may not name mesh axes).
    with (contextlib.nullcontext() if pipe else juse(strat)), mesh:
        st = jshard(state, axes, mesh, strat)
        st_sh = jlogical(mesh, strat, axes)
        b_sh = strat.sharding(mesh, tok_axes)
        data = {"tokens": jax.device_put(jnp.asarray(tokens), b_sh)}
        new, m = jax.jit(step, in_shardings=(st_sh, {"tokens": b_sh}), out_shardings=(st_sh, None))(st, data)
    return p0, float(m["loss"]), float(m["grad_norm"]), np.asarray(jax.device_get(new["params"]["layers"]["wq"]))


def _port_sharded(kw, np_params, strategy, mesh_kw, tokens, tok_axes=("batch", "seq"), pipe=None):
    cfg, st, step = _port_state(kw, np_params)
    mesh = MeshSpec(**mesh_kw).build(devices("cpu"))
    strat = ShardingStrategy.named(strategy)
    if pipe:
        _, step = make_pipeline_train_step(cfg, mesh, n_micro=pipe)
    with use_strategy(strat), mesh:
        sh = shard_pytree(st, state_logical_axes(st, cfg), mesh, strat)
        m = step(sh, {"tokens": device_put(torch.from_numpy(tokens), strat.sharding(mesh, tok_axes))})
    return m["loss"].item(), m["grad_norm"].item(), sh["params"]["layers"]["wq"].full().detach().numpy()


CASES = {
    "dp|tp": dict(kw=KW, strategy="dp+tp", mesh=dict(data=2, tensor=4), B=4),
    "ep|fsdp": dict(kw=dict(KW, n_experts=4, expert_top_k=2), strategy="ep+fsdp",
                    mesh=dict(data=2, fsdp=2, expert=2), B=8),
    "dp|sp-ring": dict(kw=dict(KW, attention_impl="ring", remat=True, n_kv_heads=2), strategy="dp+sp",
                       mesh=dict(data=2, seq=4), B=4, tok_axes=("batch", None)),
    "dp|pp": dict(kw=dict(KW, n_layers=4), strategy="dp+pp", mesh=dict(data=2, stage=4), B=8, pipe=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_sharded_step(case):
    c = CASES[case]
    tokens = np.random.default_rng(1).integers(0, c["kw"]["vocab_size"], (c["B"], 33)).astype(np.int32)
    tok_axes = c.get("tok_axes", ("batch", "seq"))
    p0, j_loss, j_norm, j_wq = _jax_sharded(c["kw"], c["strategy"], c["mesh"], tokens, tok_axes, c.get("pipe"))
    t_loss, t_norm, t_wq = _port_sharded(c["kw"], p0, c["strategy"], c["mesh"], tokens, tok_axes, c.get("pipe"))
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-4)
    np.testing.assert_allclose(t_norm, j_norm, rtol=2e-3)
    tol = dict(rtol=5e-3, atol=1e-5) if c.get("pipe") else dict(atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(t_wq, j_wq, **tol)


def test_ulysses_step_matches_jax_reference_step():
    """attention_impl="ulysses" over seq 4 x data 2 (flash per head group in
    the port, on the CPU its plain version) against the JAX package's
    unsharded reference-attention step: the reference's tolerances."""
    kw = dict(KW, n_kv_heads=4)
    tokens = np.random.default_rng(2).integers(0, kw["vocab_size"], (4, 33)).astype(np.int32)
    jcfg = JC(**kw, dtype=jnp.float32)
    init, step, _ = jmake(jcfg)
    state = init(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.asarray, state["params"])
    new, m = jax.jit(step)(state, {"tokens": jnp.asarray(tokens)})
    t_loss, t_norm, t_wq = _port_sharded(dict(kw, attention_impl="ulysses"), p0, "dp+sp", dict(data=2, seq=4),
                                         tokens, ("batch", None))
    np.testing.assert_allclose(t_loss, float(m["loss"]), rtol=2e-4)
    np.testing.assert_allclose(t_norm, float(m["grad_norm"]), rtol=2e-3)
    np.testing.assert_allclose(t_wq, np.asarray(new["params"]["layers"]["wq"]), atol=2e-5, rtol=2e-4)
