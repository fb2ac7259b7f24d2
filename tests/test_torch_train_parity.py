"""The port's train plane against ``ray_tpu``'s, on the CPU: the same seeded
numpy inputs through both packages.

- Collectives (allreduce sum and max, the averaged allreduce of
  BucketedGradSync, reduce-scatter, allgather, broadcast) on 2- and 3-rank
  groups in int32, fp32 and bf16, and the int8-quantized allreduce: bitwise
  equal, bf16 compared as its uint16 bits (the reference's ml_dtypes
  arrays, the port's torch bf16 tensors).
- ShardedOptimizerStep, sgd with momentum and adam, 3 steps on the same
  grads: the parameters bitwise equal.
- ``elastic.plan.plan_pull`` on 50 seeded N->M layouts: equal plans.
- ``ckpt``: a tree saved by either package restores through the other's
  ``restore_tree`` bitwise, both give the same chunk digests, and a
  resharded N->M restore is byte-identical.
- The train plane: the port's DataParallelTrainer, 2 CPU workers on half
  the rows each with ``train.grad_sync()``, against ``ray_tpu``'s
  in-process ``make_train_step`` on the whole batch from the same weights
  (``ray_tpu_torch/convert.py``): losses within 1e-5 (absolute), fp32. The
  halves change only how the mean and the gradient sum associate.
- The public surface: each package's ``__all__`` equals the reference's,
  ``TorchTrainer`` in the place of ``JaxTrainer``.

One runtime at a time: the reference's session runs every collective case
and shuts down, then the port's does the same and trains (``outputs``).
"""
import numpy as np
import pytest

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

SEED = 29
N = 37  # elements per rank: not a multiple of 2 or 3 (uneven ring chunks)
WORLDS = (2, 3)
DTYPES = ("int32", "float32", "bfloat16")
TRAIN_MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                   max_seq_len=64)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 32, 3
LOSS_TOL = 1e-5


def _member_cls(pkg: str):
    """An actor class joining a host collective group of ``pkg``
    ("ray_tpu" or "ray_tpu_torch"); ``run`` returns every result as raw
    bytes (bf16 as its uint16 bits)."""
    import importlib

    col = importlib.import_module(pkg + ".collective")

    class Member(col.CollectiveActorMixin):
        def run(self, pkg, group, rank, world, seed, n):
            import importlib

            import numpy as np

            col = importlib.import_module(pkg + ".collective")
            gsm = importlib.import_module(pkg + ".train.grad_sync")
            torch_side = pkg == "ray_tpu_torch"
            if torch_side:
                import torch

            def make(a32, dt):
                """The package's array for fp32 values ``a32`` in ``dt``."""
                if dt == "bfloat16":
                    if torch_side:
                        return torch.from_numpy(a32).to(torch.bfloat16)
                    import ml_dtypes

                    return a32.astype(ml_dtypes.bfloat16)
                return a32.astype(dt)

            def raw(a):
                if a is None:
                    return None
                if isinstance(a, list):
                    return [raw(x) for x in a]
                if isinstance(a, dict):
                    return {k: raw(v) for k, v in sorted(a.items())}
                if torch_side and isinstance(a, torch.Tensor):
                    if a.dtype == torch.bfloat16:
                        a = a.view(torch.int16)
                    return ("bfloat16" if a.dtype == torch.int16 else str(a.dtype).split(".")[-1],
                            list(a.shape), a.numpy().tobytes())
                a = np.asarray(a)
                name = a.dtype.name
                return (name, list(a.shape), a.tobytes())

            out = {}
            for dt in ("int32", "float32", "bfloat16"):
                rng = np.random.default_rng(seed + rank)
                if dt == "int32":
                    v = rng.integers(-40, 40, n).astype(np.float32)
                    stack = rng.integers(-40, 40, (world, n)).astype(np.float32)
                else:
                    v = rng.standard_normal(n).astype(np.float32)
                    stack = rng.standard_normal((world, n)).astype(np.float32)
                x = make(v, dt)
                out[f"allreduce_sum.{dt}"] = raw(col.allreduce(x, "sum", group_name=group))
                out[f"allreduce_max.{dt}"] = raw(col.allreduce(x, "max", group_name=group))
                gs = gsm.BucketedGradSync(group_name=group, bucket_bytes=64)
                out[f"allreduce_mean.{dt}"] = raw(gs.allreduce({"w": x, "u": make(v[:5] * 3, dt)}))
                out[f"reducescatter.{dt}"] = raw(col.reducescatter(make(stack, dt), "sum", group_name=group))
                out[f"allgather.{dt}"] = raw(col.allgather(x, group_name=group))
                out[f"broadcast.{dt}"] = raw(col.broadcast(x, src_rank=1, group_name=group))
                if dt != "int32":
                    out[f"quantized.{dt}"] = raw(
                        col.allreduce(x, group_name=group, quantization="int8"))
            # ShardedOptimizerStep: sgd with momentum and adam, 3 steps.
            for opt in ("sgd", "adam"):
                prng = np.random.default_rng(seed)
                params = {"a": prng.standard_normal(13).astype(np.float32),
                          "b": prng.standard_normal((5, 7)).astype(np.float32)}
                if torch_side:
                    params = {k: torch.from_numpy(p) for k, p in params.items()}
                kw = {"momentum": 0.9} if opt == "sgd" else {}
                step = gsm.ShardedOptimizerStep(opt, lr=0.05, group_name=group,
                                                bucket_bytes=64, **kw)
                for s in range(3):
                    grng = np.random.default_rng(seed * 7 + 31 * s + rank)
                    grads = {"a": grng.standard_normal(13).astype(np.float32),
                             "b": grng.standard_normal((5, 7)).astype(np.float32)}
                    if torch_side:
                        grads = {k: torch.from_numpy(g) for k, g in grads.items()}
                    params = step.step(params, grads)
                out[f"sharded.{opt}"] = raw(params)
            return out

    return Member


def _run_collectives(pkg_name, pkg):
    out = {}
    Member = pkg.remote(_member_cls(pkg_name))
    for world in WORLDS:
        group = f"parity{world}"
        members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
        import importlib

        col = importlib.import_module(pkg_name + ".collective")
        col.create_collective_group(members, world, list(range(world)), group_name=group)
        res = pkg.get([m.run.remote(pkg_name, group, r, world, SEED, N)
                       for r, m in enumerate(members)], timeout=300)
        col.destroy_collective_group(group)
        for m in members:
            pkg.kill(m)
        out[world] = res
    return out


def _port_train_fn(config):
    """Rank r takes rows [r*B/2, (r+1)*B/2) of the batch: loss and backward
    on its half, the grads averaged over the ring into each .grad, AdamW;
    rank 0 reports the two ranks' mean loss."""
    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.convert import from_numpy_tree
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import adamw, cross_entropy_loss, leaves

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    cfg = TransformerConfig(**config["model"], dtype=torch.float32, attention_impl="reference")
    params = from_numpy_tree(config["weights"], cfg, device="cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    opt = adamw(leaves(params))
    tokens = np.asarray(config["tokens"])
    half = tokens.shape[0] // world
    batch = {"tokens": torch.from_numpy(tokens[rank * half:(rank + 1) * half])}
    sync = train.grad_sync()
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(params, batch, cfg)
        loss.backward()
        grads = sync.allreduce([t.grad for t in leaves(params)])
        with torch.no_grad():
            for t, g in zip(leaves(params), grads):
                t.grad.copy_(g)
        opt.step()
        mean = sync.allreduce({"loss": loss.detach().reshape(1)})["loss"]
        train.report({"step": step, "loss": float(mean[0])})


def _train_inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jt

    jc = jt.TransformerConfig(**TRAIN_MODEL, dtype=jnp.float32, attention_impl="reference")
    jp = jt.init_params(jax.random.PRNGKey(SEED), jc)
    weights = jax.tree.map(np.asarray, jp)
    tokens = np.random.default_rng(SEED).integers(
        0, TRAIN_MODEL["vocab_size"], (TRAIN_B, TRAIN_S + 1)).astype(np.int64)
    return jc, jp, weights, tokens


def _run_port_trainer(tmp, weights, tokens):
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    res = DataParallelTrainer(
        _port_train_fn,
        train_loop_config={"model": TRAIN_MODEL, "weights": weights, "tokens": tokens,
                           "steps": TRAIN_STEPS},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="parity", storage_path=str(tmp)),
    ).fit()
    assert res.error is None, res.error
    return [m["loss"] for m in res.metrics_history]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    import ray_tpu
    import ray_tpu_torch

    _, _, weights, tokens = _train_inputs()
    ray_tpu.init(num_cpus=8)
    try:
        want = _run_collectives("ray_tpu", ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        got = _run_collectives("ray_tpu_torch", ray_tpu_torch)
        got["train_losses"] = _run_port_trainer(tmp_path_factory.mktemp("train"), weights, tokens)
    finally:
        ray_tpu_torch.shutdown()
    return want, got


_CASES = [f"{op}.{dt}" for dt in DTYPES for op in (
    "allreduce_sum", "allreduce_max", "allreduce_mean", "reducescatter", "allgather", "broadcast")]
_CASES += ["quantized.float32", "quantized.bfloat16"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", _CASES)
def test_collective_bitwise_equal_to_ray_tpu(outputs, world, case):
    want, got = outputs
    for rank in range(world):
        assert got[world][rank][case] == want[world][rank][case], (world, rank, case)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sharded_optimizer_step_bitwise_equal_to_ray_tpu(outputs, world, opt):
    want, got = outputs
    for rank in range(world):
        g, w = got[world][rank][f"sharded.{opt}"], want[world][rank][f"sharded.{opt}"]
        assert g == w, (world, rank, opt)
    # Every rank ends with the same parameters.
    assert len({repr(got[world][r][f"sharded.{opt}"]) for r in range(world)}) == 1


def test_train_plane_losses_match_ray_tpu_in_process_step(outputs):
    """2 CPU workers on half the rows each, grads averaged over the port's
    ring, against ray_tpu's make_train_step on the whole batch from the same
    weights: every step's loss within LOSS_TOL."""
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import transformer as jt

    _, got = outputs
    jc, jp, _, tokens = _train_inputs()
    _, train_step, _ = jt.make_train_step(jc)
    # make_train_step's own optimizer (optax.adamw(3e-4, weight_decay=0.01)),
    # started on the weights the port's workers were given.
    state = {"params": jp, "opt": optax.adamw(3e-4, weight_decay=0.01).init(jp),
             "step": jnp.zeros((), jnp.int32)}
    want = []
    for _ in range(TRAIN_STEPS):
        state, m = train_step(state, {"tokens": jnp.asarray(tokens.astype(np.int32))})
        want.append(float(m["loss"]))
    assert len(got["train_losses"]) == TRAIN_STEPS
    np.testing.assert_allclose(got["train_losses"], want, atol=LOSS_TOL, rtol=0)


def test_plan_pull_equal_on_seeded_layouts():
    from ray_tpu.elastic import plan as rplan
    from ray_tpu_torch.elastic import plan as pplan

    rng = np.random.default_rng(SEED)
    for case in range(50):
        ndim = int(rng.integers(1, 4))
        shape = [int(rng.integers(1, 9)) for _ in range(ndim)]
        itemsize = int(rng.choice([1, 2, 4, 8]))
        n_src, n_dst = int(rng.integers(1, 5)), int(rng.integers(1, 5))

        def cuts(k):
            axis = int(rng.integers(0, ndim))
            edges = np.linspace(0, shape[axis], k + 1).astype(int)
            return [[[0, d] if a != axis else [int(edges[i]), int(edges[i + 1])]
                     for a, d in enumerate(shape)] for i in range(k)]

        src = {r: rect for r, rect in enumerate(cuts(n_src))}
        dst_rect = cuts(n_dst)[int(rng.integers(0, n_dst))]
        prefer = rplan.rotated(src, int(rng.integers(0, n_src)))
        want = rplan.plan_pull("a", shape, itemsize, src, dst_rect, prefer)
        got = pplan.plan_pull("a", shape, itemsize, src, dst_rect, prefer)
        assert [(r.path, r.src_rank, r.src_off, r.dst_off, r.nbytes) for r in got] == \
            [(r.path, r.src_rank, r.src_off, r.dst_off, r.nbytes) for r in want], case


def _ckpt_tree(side: str, bf16: bool):
    """One tree for both packages: fp32, int32, float64 leaves, and with
    ``bf16`` a bf16 leaf (ml_dtypes for the reference, torch for the port)."""
    rng = np.random.default_rng(SEED)
    w = rng.standard_normal((33, 17)).astype(np.float32)
    h = rng.standard_normal(300).astype(np.float32)
    tree = {"model": {"w": w},
            "opt": {"step": np.int32(5), "m": rng.standard_normal(64)},
            "ids": rng.integers(0, 1000, (9, 4)).astype(np.int32)}
    if bf16:
        if side == "ray_tpu":
            import ml_dtypes

            tree["model"]["half"] = h.astype(ml_dtypes.bfloat16)
        else:
            import torch

            tree["model"]["half"] = torch.from_numpy(h).to(torch.bfloat16)
    return tree


def _bits(tree):
    """{path: (dtype name, shape, bytes)} of a restored tree, bf16 as bits."""
    import torch

    from ray_tpu_torch.ckpt.saver import _flatten

    out = {}
    for path, a in _flatten(tree).items():
        if isinstance(a, torch.Tensor):
            out[path] = ("bfloat16", list(a.shape), a.view(torch.int16).numpy().tobytes())
        else:
            a = np.asarray(a)
            name = a.dtype.name
            out[path] = (name, list(a.shape), a.tobytes())
    return out


def _save(pkg: str, root, tree):
    import importlib

    ck = importlib.import_module(pkg + ".ckpt")
    saver = ck.AsyncSaver(str(root), chunk_size=1024)
    try:
        return saver.save(3, tree)
    finally:
        saver.close()


@pytest.mark.parametrize("writer", ["ray_tpu", "ray_tpu_torch"])
def test_ckpt_cross_restore_bitwise(tmp_path, writer):
    """A tree saved by one package restores through the other's
    restore_tree bitwise. The port's tree carries a bf16 leaf; ray_tpu's
    cannot: its write_part takes a memoryview of the leaf, which numpy
    refuses for ml_dtypes' bfloat16."""
    import importlib

    import ml_dtypes  # noqa: F401  (names "bfloat16" for numpy on ray_tpu's side)

    reader = "ray_tpu_torch" if writer == "ray_tpu" else "ray_tpu"
    bf16 = writer == "ray_tpu_torch"
    m = _save(writer, tmp_path, _ckpt_tree(writer, bf16))
    r = importlib.import_module(reader + ".ckpt")
    got = r.restore_tree(r.load_manifest(str(tmp_path), m["ckpt_id"]),
                         r.ChunkStore(str(tmp_path)), verify=True)
    w = importlib.import_module(writer + ".ckpt")
    own = w.restore_tree(m, w.ChunkStore(str(tmp_path)), verify=True)
    assert _bits(got) == _bits(own) == _bits(_ckpt_tree(writer, bf16))


def test_ckpt_same_tree_same_chunk_digests(tmp_path):
    m_ref = _save("ray_tpu", tmp_path / "ref", _ckpt_tree("ray_tpu", False))
    m_port = _save("ray_tpu_torch", tmp_path / "port", _ckpt_tree("ray_tpu_torch", False))

    def layout(m):
        return {p: (e["dtype"], e["shape"], [(s["index"], s["chunks"]) for s in e["shards"]])
                for p, e in m["arrays"].items()}

    assert layout(m_port) == layout(m_ref)
    assert m_port["bytes_total"] == m_ref["bytes_total"]


def test_ckpt_resharded_restore_byte_identical(tmp_path):
    """A 3-shard checkpoint (row shards of one array, written part by part
    by ray_tpu) restores onto 2 row targets and 2 column targets through
    both packages byte-identically."""
    from ray_tpu import ckpt as rck
    from ray_tpu_torch import ckpt as pck

    rows, cols = 24, 10
    data = np.random.default_rng(SEED).standard_normal((rows, cols))
    store = rck.ChunkStore(str(tmp_path), chunk_size=256)
    ms = rck.ManifestStore(str(tmp_path), chunk_store=store)
    cuts = [0, 7, 15, rows]
    parts = [rck.write_part(store, {"w": {"dtype": "float64", "shape": [rows, cols], "shards": [
        ([[cuts[i], cuts[i + 1]], [0, cols]], data[cuts[i]:cuts[i + 1]])]}}, rank=i)
        for i in range(3)]
    m = rck.commit_parts(ms, rck.new_ckpt_id(1), 1, parts, 3)
    pm = pck.load_manifest(str(tmp_path), m["ckpt_id"])
    pstore = pck.ChunkStore(str(tmp_path))
    for targets in ([[[0, 12], [0, cols]], [[12, rows], [0, cols]]],
                    [[[0, rows], [0, 4]], [[0, rows], [4, cols]]]):
        for t in targets:
            want = rck.restore(m, store, target_indices={"w": t})["w"]
            got = pck.restore(pm, pstore, target_indices={"w": t})["w"]
            assert got.tobytes() == want.tobytes()
            assert got.shape == want.shape


@pytest.mark.parametrize("pkg", ["collective", "ckpt", "elastic", "train"])
def test_same_public_surface(pkg):
    """Each package exports what ray_tpu's does; train's one difference is
    its trainer: TorchTrainer in the place of JaxTrainer."""
    import importlib

    ref = list(importlib.import_module(f"ray_tpu.{pkg}").__all__)
    port = list(importlib.import_module(f"ray_tpu_torch.{pkg}").__all__)
    if pkg == "train":
        ref = ["TorchTrainer" if n == "JaxTrainer" else n for n in ref]
    assert port == ref
