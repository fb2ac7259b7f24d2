"""The port's parallelism held against ``ray_tpu``'s on the same inputs.

Both run on 8 CPU slots: the JAX package on its 8-device virtual CPU mesh
(the repo's conftest), the port on ``RAY_TPU_TORCH_DEVICE_SLOTS=8``. Inputs
come from numpy seeds; model weights are drawn by the JAX package and
converted (``ray_tpu_torch.convert``). Tolerances, each stated where it is
used: the sharding specs and shard layouts are exact; ring and Ulysses
attention and the pipeline in fp32 at atol/rtol 2e-5 (the reference's own
bound for its ring); the TP-2 engine's greedy tokens exactly. The sharded
train steps are in ``test_torch_parallel_parity_train.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import ShardingStrategy as JStrategy
from ray_tpu_torch.parallel import MeshSpec, NamedSharding, PartitionSpec as P, ShardingStrategy
from ray_tpu_torch.parallel import device_put, devices, shard_pytree

TOL = dict(atol=2e-5, rtol=2e-5)
PRESETS = ("dp", "fsdp", "tp", "sp", "ep", "pp", "none")


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


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _axes_sets():
    from ray_tpu.models.transformer import param_logical_axes
    from ray_tpu.models import TransformerConfig as JC

    out = {("batch", "seq"), ("batch", None), ("batch", "seq", "embed"), ("batch", "seq", "heads", "head_dim"),
           ("batch", "seq", "mlp"), ("experts", "batch", "seq", "expert_mlp"), ("batch", "seq", "vocab"),
           ("mlp", "heads"), ("embed", "heads", "head_dim")}
    for cfg in (JC(), JC(n_experts=4)):
        out |= set(jax.tree.leaves(param_logical_axes(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    return sorted(out, key=str)


def test_every_preset_and_composition_gives_the_references_spec():
    """Exact: every preset, every ordered pair and the three-way
    compositions of presets give the reference's PartitionSpec for every
    logical-axis tuple the model uses."""
    names = list(PRESETS) + [f"{a}+{b}" for a, b in itertools.permutations(PRESETS[:-1], 2)] + \
        ["fsdp+tp+sp", "dp+tp+pp", "ep+fsdp+tp"]
    for name in names:
        ps, js = ShardingStrategy.named(name), JStrategy.named(name)
        assert ps.rules == js.rules, name
        for axes in _axes_sets():
            assert tuple(ps.spec(axes)) == tuple(js.spec(axes)), (name, axes)


def _jax_shards(arr, mesh):
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    return [(tuple(s.data.shape), tuple((sl.start or 0, dim if sl.stop is None else sl.stop)
                                        for sl, dim in zip(s.index, arr.shape)))
            for s in sorted(arr.addressable_shards, key=lambda s: pos[s.device])]


def _port_shards(st):
    return [(tuple(s.data.shape), tuple((sl.start, sl.stop) for sl in s.index)) for s in st.addressable_shards]


@pytest.mark.parametrize("strategy,mesh_kw,moe", [
    ("dp", dict(data=8), False),
    ("fsdp", dict(fsdp=8), False),
    ("tp", dict(data=2, tensor=4), False),
    ("ep+fsdp", dict(data=2, fsdp=2, expert=2), True),
    ("dp+pp", dict(data=2, stage=4), False),
])
def test_each_leafs_shards_match_jax(strategy, mesh_kw, moe):
    """Exact: every parameter leaf's per-slot shard shape and global index,
    in flat slot order, equal jax's addressable_shards on the same mesh."""
    from ray_tpu.models import TransformerConfig as JC
    from ray_tpu.models.transformer import init_params as jinit
    from ray_tpu.models.transformer import param_logical_axes as jaxes
    from ray_tpu.parallel import shard_pytree as jshard
    from ray_tpu_torch.convert import from_numpy_tree
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import leaves, param_logical_axes

    kw = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq_len=64,
              n_experts=4 if moe else 0)
    jcfg, tcfg = JC(**kw, dtype=jnp.float32), TransformerConfig(**kw, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    jmesh = JMeshSpec(**mesh_kw).build()
    jsh = jshard(jp, jaxes(jcfg), jmesh, JStrategy.named(strategy))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tsh = shard_pytree(tp, param_logical_axes(tcfg), MeshSpec(**mesh_kw).build(devices("cpu")),
                       ShardingStrategy.named(strategy))
    pairs = [(jsh[k], tsh[k]) for k in ("embed", "final_norm", "lm_head")] + \
        [(jsh["layers"][k], t) for k, t in tsh["layers"].items()]
    assert len(pairs) == len(leaves(tsh))
    for j, t in pairs:
        assert _port_shards(t) == _jax_shards(j, jmesh)
        assert tuple(t.spec) == tuple(j.sharding.spec)


def _both_meshes(**kw):
    return JMeshSpec(**kw).build(), MeshSpec(**kw).build(devices("cpu"))


def _jax_seq(mesh, *xs):
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP

    return [jax.device_put(jnp.asarray(x), JNS(mesh, JP(None, "seq", None, None))) for x in xs]


def _port_seq(mesh, *xs):
    return [device_put(torch.from_numpy(x), NamedSharding(mesh, P(None, "seq", None, None))) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax_ring(causal):
    """fp32, atol/rtol 2e-5: the port's ring against the JAX ring (seq 4 x data 2)."""
    from ray_tpu.ops.ring_attention import ring_attention as jring
    from ray_tpu_torch.ops import ring_attention

    jm, tm = _both_meshes(seq=4, data=2)
    q, k, v = (_normal(s, (2, 32, 4, 16)) for s in range(3))
    with jm:
        want = np.asarray(jax.jit(lambda a, b, c: jring(a, b, c, causal=causal))(*_jax_seq(jm, q, k, v)))
    got = ring_attention(*_port_seq(tm, q, k, v), causal=causal).full().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ulysses_gqa_and_segments_match_jax():
    """fp32, atol/rtol 2e-5: GQA (8 heads, 4 KV) with two packed segments
    per row, seq 4, against the JAX Ulysses (flash in interpret mode)."""
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.ops.ulysses import ulysses_attention as julysses
    from ray_tpu_torch.ops import ulysses_attention

    jm, tm = _both_meshes(seq=4, data=2)
    B, S, H, KV, D = 2, 32, 8, 4, 8
    q, k, v = _normal(10, (B, S, H, D)), _normal(11, (B, S, KV, D)), _normal(12, (B, S, KV, D))
    seg = np.concatenate([np.zeros((B, 12), np.int32), np.ones((B, S - 12), np.int32)], axis=1)
    with jm:
        jseg = jax.device_put(jnp.asarray(seg), JNS(jm, JP(None, "seq")))
        want = np.asarray(jax.jit(lambda a, b, c, s: julysses(a, b, c, segment_ids=s))(*_jax_seq(jm, q, k, v), jseg))
    tseg = device_put(torch.from_numpy(seg), NamedSharding(tm, P(None, "seq")))
    got = ulysses_attention(*_port_seq(tm, q, k, v), segment_ids=tseg).full().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ulysses_indivisible_falls_back_to_ring_like_jax():
    """fp32, atol/rtol 2e-5: 2 heads over seq 8 fall back to the ring in
    both packages."""
    from ray_tpu.ops.ulysses import ulysses_attention as julysses
    from ray_tpu_torch.ops import ulysses_attention

    jm, tm = _both_meshes(seq=8)
    q, k, v = (_normal(20 + s, (1, 64, 2, 8)) for s in range(3))
    with jm:
        want = np.asarray(jax.jit(lambda a, b, c: julysses(a, b, c))(*_jax_seq(jm, q, k, v)))
    got = ulysses_attention(*_port_seq(tm, q, k, v)).full().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_pipeline_apply_matches_jax():
    """fp32, atol/rtol 2e-5: the GPipe schedule over stage 4 x data 2, 8
    microbatches, against the JAX pipeline on the same weights."""
    from ray_tpu.parallel.pipeline import pipeline_apply as jpipe
    from ray_tpu_torch.parallel import pipeline_apply

    jm, tm = _both_meshes(stage=4, data=2)
    w, b, x = _normal(30, (4, 16, 16)) * 0.3, _normal(31, (4, 16)) * 0.1, _normal(32, (8, 2, 16))
    with jm:
        want = np.asarray(jax.jit(lambda p, xx: jpipe(lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, xx, mesh=jm))(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    got = pipeline_apply(lambda q, h: torch.tanh(h @ q["w"] + q["b"]),
                         {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x), mesh=tm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp2_engine_greedy_tokens_match_jax_tp2_engine(layout):
    """Exact: the port's TP-2 engine and ray_tpu's TP-2 engine, on the same
    converted weights (fp32), give the same greedy tokens for two prompts."""
    from ray_tpu.llm import EngineConfig as JEC
    from ray_tpu.llm import LLMEngine as JEngine
    from ray_tpu.models import TransformerConfig as JC
    from ray_tpu_torch.convert import from_numpy_tree
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig

    kw = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
              attention_impl="reference")
    ek = dict(max_slots=4, max_seq=128, prefill_buckets=(16, 32), kv_layout=layout, tensor_parallel=2)
    if layout == "paged":
        ek["page_size"] = 32
    jeng = JEngine(JC(**kw, dtype=jnp.float32), engine_config=JEC(**ek))
    tree = jax.tree.map(np.asarray, jeng.params)
    tcfg = TransformerConfig(**kw, dtype=torch.float32)
    teng = LLMEngine(tcfg, params=from_numpy_tree(tree, tcfg, device="cpu"), engine_config=EngineConfig(**ek),
                     device="cpu")
    for prompt in ([5, 17, 42, 7, 23, 11, 2], list(range(3, 24))):
        want = jeng.generate(prompt, max_tokens=10)["tokens"]
        assert teng.generate(prompt, max_tokens=10)["tokens"] == want


def test_with_logical_constraint_reshards_like_jax():
    """Exact: a ShardedTensor that comes in batch-sharded is re-laid by
    with_logical_constraint onto the layout jax's constraint gives the same
    logical axes (dp|sp: batch over data, sequence over seq) -- the same
    per-slot blocks and values; outside a strategy, and on a plain
    tensor, it is a no-op as in the reference."""
    from jax.sharding import NamedSharding as JNS

    from ray_tpu.parallel import with_logical_constraint as jwlc
    from ray_tpu.parallel.sharding import use_strategy as juse
    from ray_tpu_torch.parallel import use_strategy, with_logical_constraint

    jm, tm = _both_meshes(data=2, seq=4)
    x = _normal(50, (4, 32, 8))
    jstrat, tstrat = JStrategy.named("dp+sp"), ShardingStrategy.named("dp+sp")
    axes = ("batch", "seq", "embed")
    with juse(jstrat), jm:
        jx = jax.device_put(jnp.asarray(x), JNS(jm, jstrat.spec(("batch", None, None))))
        jy = jax.jit(lambda a: jwlc(a, axes))(jx)
    tx = device_put(torch.from_numpy(x), NamedSharding(tm, tstrat.spec(("batch", None, None))))
    assert with_logical_constraint(tx, axes) is tx  # no strategy: no-op
    with use_strategy(tstrat), tm:
        ty = with_logical_constraint(tx, axes)
        plain = torch.from_numpy(x)
        assert with_logical_constraint(plain, axes) is plain
    # jax reports the spec with its size-1 axes and trailing Nones dropped:
    # the per-slot blocks are the comparison.
    assert ty.spec == tstrat.spec(axes)
    assert _port_shards(ty) == _jax_shards(jy, jm)
    np.testing.assert_array_equal(ty.full().numpy(), np.asarray(jy))


def test_prefetch_to_device_places_shards_like_jax_device_put():
    """Exact: prefetch_to_device(sharding=) lays each batch's leaves out
    per slot as ray_tpu's infeed (jax.device_put(batch, sharding)) does."""
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.data.infeed import prefetch_to_device as jprefetch
    from ray_tpu_torch.data.infeed import prefetch_to_device

    jm, tm = _both_meshes(data=4, tensor=2)
    batches = [{"tokens": np.arange(8 * 6, dtype=np.int32).reshape(8, 6) + i,
                "mask": np.ones((8, 6), np.float32)} for i in range(3)]
    jout = list(jprefetch(iter(batches), sharding=JNS(jm, JP("data", None))))
    tout = list(prefetch_to_device(iter(batches), sharding=NamedSharding(tm, P("data", None))))
    assert len(tout) == len(jout) == 3
    for j, t in zip(jout, tout):
        for k in ("tokens", "mask"):
            assert _port_shards(t[k]) == _jax_shards(j[k], jm)
            np.testing.assert_array_equal(t[k].full().numpy(), np.asarray(j[k]))
