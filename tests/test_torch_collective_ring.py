"""The port's collective plane on port clusters: the cases of
``tests/test_collective_ring.py``, case for case. bfloat16 inputs are torch
tensors (numpy has no bfloat16 without ml_dtypes, which the port does not
use); their results come back as bfloat16 tensors.

Collective performance plane: ring transport, int8 quantization,
bucketed overlap, sharded update.

The load-bearing invariants:
* ring results match the coordinator transport for every op and dtype
  (exact-representable values, so float comparison is equality);
* the coordinator actor carries ZERO tensor payload bytes on the ring path
  (its own counting shim — the PR-3 pickle-bypass proof, collective-shaped);
* quantized allreduce stays inside the codec's documented error bound and
  agrees byte-for-byte across ranks;
* bucketed overlap and the sharded update are bit-equal to their unbucketed
  / unsharded references on exactly-representable grads;
* sharded optimizer state never approaches full-model size.
"""
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import collective as col
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


def _bf16(a):
    """A numpy array as a bfloat16 torch tensor (exact for small ints)."""
    import torch

    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f64(a):
    """float64 numpy copy of a numpy array or a torch tensor (bf16 too)."""
    if type(a).__module__ == "torch":
        return a.double().numpy()
    return np.asarray(a, np.float64)


def _name(a) -> str:
    from ray_tpu_torch.util.dtypes import dtype_name

    return dtype_name(a.dtype)


def _exact_vals(rank: int, n: int = 64):
    """Small integers: exact in every dtype incl. bf16, so any summation
    order (ring phase, bucketing) produces identical bytes."""
    return np.arange(n) % 3 + rank + 1  # 1..5


def test_ring_matches_coordinator_all_ops_dtypes(shared_ray):
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            import torch

            out = {}
            dtypes = ["float32", "float64", "int32", "int64", "bfloat16"]
            for key in dtypes:
                x = (_bf16(_exact_vals(rank)) if key == "bfloat16"
                     else _exact_vals(rank).astype(key))
                for op in ("sum", "max", "min", "prod"):
                    r = col.allreduce(x, op, group_name="eq", transport="ring")
                    c = col.allreduce(x, op, group_name="eq",
                                      transport="coordinator")
                    assert _name(r) == key, (key, op, r.dtype)
                    out[f"ar.{key}.{op}"] = (_f64(r), _f64(c))
                rg = col.allgather(x, group_name="eq", transport="ring")
                cg = col.allgather(x, group_name="eq", transport="coordinator")
                out[f"ag.{key}"] = ([_f64(a) for a in rg],
                                    [_f64(a) for a in cg])
                stack = (torch.stack([x + i for i in range(world)])
                         if key == "bfloat16"
                         else np.stack([x + i for i in range(world)]))
                rs = col.reducescatter(stack, "sum", group_name="eq",
                                       transport="ring")
                cs = col.reducescatter(stack, "sum", group_name="eq",
                                       transport="coordinator")
                out[f"rs.{key}"] = (_f64(rs), _f64(cs))
                src_val = x if rank == 1 else None
                rb = col.broadcast(src_val, src_rank=1, group_name="eq",
                                   transport="ring")
                cb = col.broadcast(src_val, src_rank=1, group_name="eq",
                                   transport="coordinator")
                assert _name(rb) == key, (key, rb.dtype)
                out[f"bc.{key}"] = (_f64(rb), _f64(cb))
                rr = col.reduce(x, dst_rank=2, op="sum", group_name="eq",
                                transport="ring")
                cr = col.reduce(x, dst_rank=2, op="sum", group_name="eq",
                                transport="coordinator")
                assert (rr is None) == (rank != 2) == (cr is None)
                if rank == 2:
                    out[f"rd.{key}"] = (_f64(rr), _f64(cr))
            # Degenerate shard sizes: fewer elements than ranks.
            tiny = col.allreduce(np.full((2,), rank + 1.0, np.float32),
                                 group_name="eq", transport="ring")
            out["tiny"] = (np.asarray(tiny, np.float64),
                           np.full((2,), 6.0))
            return out

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, list(range(world)),
                                group_name="eq")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=180)
    for rank, res in enumerate(outs):
        for name, (ring_v, coord_v) in res.items():
            if name.startswith("ag."):
                assert len(ring_v) == len(coord_v) == world
                for a, b in zip(ring_v, coord_v):
                    assert np.array_equal(a, b), (rank, name)
            else:
                assert np.array_equal(ring_v, coord_v), (rank, name)
    col.destroy_collective_group("eq")


def test_coordinator_carries_zero_payload_bytes_on_ring_path(shared_ray):
    """The acceptance invariant, PR-3 counting-shim style: the coordinator's
    own payload-byte counters stay at zero across a full suite of ring ops —
    and the shim itself is proven live by one legacy-transport op after."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def ring_ops(self, rank, world):
            x = np.full((4096,), rank + 1.0, np.float32)
            col.allreduce(x, group_name="zb")
            col.allreduce(x, group_name="zb", quantization="int8")
            col.allgather(x, group_name="zb")
            col.reducescatter(np.stack([x] * world), group_name="zb")
            col.broadcast(x if rank == 0 else None, src_rank=0, group_name="zb")
            col.reduce(x, dst_rank=0, group_name="zb")
            return True

        def legacy_op(self, rank):
            col.allreduce(np.full((256,), rank + 1.0, np.float32),
                          group_name="zb", transport="coordinator")
            return True

    world = 2
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1], group_name="zb")
    rt.get([m.ring_ops.remote(i, world) for i, m in enumerate(members)],
           timeout=120)
    from ray_tpu_torch.collective.collective import _GROUP_PREFIX

    actor = rt.get_actor(_GROUP_PREFIX + "zb")
    stats = rt.get(actor.get_stats.remote(), timeout=30)
    assert stats == {"payload_in": 0, "payload_out": 0}, stats
    # Shim liveness: the legacy transport must move the counters, or the
    # zero above is green-by-vacuity.
    rt.get([m.legacy_op.remote(i) for i, m in enumerate(members)], timeout=60)
    stats = rt.get(actor.get_stats.remote(), timeout=30)
    assert stats["payload_in"] == world * 256 * 4, stats
    assert stats["payload_out"] == world * world * 256 * 4, stats
    col.destroy_collective_group("zb")


def test_legacy_reduce_broadcast_ship_only_whats_consumed(shared_ray):
    """Satellite: on the coordinator transport, reduce() serves the
    all-ranks box ONLY to dst (was: every rank), and broadcast() publishes
    one value (was: an all-ranks box with W-1 Nones that everyone fetched)."""
    n = 512
    nbytes = n * 4

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            x = np.full((n,), rank + 1.0, np.float32)
            r = col.reduce(x, dst_rank=1, group_name="slim",
                           transport="coordinator")
            b = col.broadcast(x if rank == 0 else None, src_rank=0,
                              group_name="slim", transport="coordinator")
            return (None if r is None else float(r[0]), float(b[0]))

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1, 2], group_name="slim")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    assert [o[0] for o in outs] == [None, 6.0, None]
    assert [o[1] for o in outs] == [1.0, 1.0, 1.0]
    from ray_tpu_torch.collective.collective import _GROUP_PREFIX

    stats = rt.get(rt.get_actor(_GROUP_PREFIX + "slim").get_stats.remote(),
                   timeout=30)
    # reduce: W contributions in, ONE box (W arrays) out to dst.
    # broadcast: 1 contribution in, W single-value fetches out.
    assert stats["payload_in"] == world * nbytes + nbytes, stats
    assert stats["payload_out"] == world * nbytes + world * nbytes, stats
    col.destroy_collective_group("slim")


def test_quantized_allreduce_error_gate(shared_ray):
    """int8 ring allreduce: inside the codec's DOCUMENTED bound
    (quantize.max_abs_error_bound), byte-identical across ranks, dtype
    preserved — on adversarially scaled random data."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            rng = np.random.default_rng(1234 + rank)
            # Mixed scales stress the per-block absmax: big blocks next to
            # tiny ones.
            x = (rng.standard_normal(5000) *
                 np.repeat([1.0, 100.0, 0.01, 10.0, 1.0], 1000)
                 ).astype(np.float32)
            q = col.allreduce(x, group_name="qt", quantization="int8")
            exact = col.allreduce(x.astype(np.float64), group_name="qt")
            assert q.dtype == np.float32
            return x, q, exact

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1, 2], group_name="qt")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=120)
    from ray_tpu_torch.collective import quantize

    absmax_in = max(float(np.abs(o[0]).max()) for o in outs)
    bound = quantize.max_abs_error_bound(world, absmax_in)
    for rank, (x, q, exact) in enumerate(outs):
        err = float(np.abs(q.astype(np.float64) - outs[0][2]).max())
        assert err <= bound, (rank, err, bound)
    # An allreduce must agree everywhere — quantized included (the owner
    # ships its encoding verbatim and adopts its own dequantized image).
    for o in outs[1:]:
        assert o[1].tobytes() == outs[0][1].tobytes()
    # bf16 in, bf16 out (fp32 accumulation is internal).
    col.destroy_collective_group("qt")


def test_quantization_rejects_bad_combinations(shared_ray):
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank):
            import pytest as pt

            with pt.raises(ValueError, match="sum"):
                col.allreduce(np.ones(8, np.float32), "max", group_name="qv",
                              quantization="int8")
            with pt.raises(ValueError, match="floating"):
                col.allreduce(np.ones(8, np.int32), group_name="qv",
                              quantization="int8")
            with pt.raises(ValueError, match="ring"):
                col.allreduce(np.ones(8, np.float32), group_name="qv",
                              quantization="int8", transport="coordinator")
            return True

    members = [Member.options(max_concurrency=2).remote() for _ in range(2)]
    col.create_collective_group(members, 2, [0, 1], group_name="qv")
    assert rt.get([m.run.remote(i) for i, m in enumerate(members)], timeout=60)
    col.destroy_collective_group("qv")


def test_bf16_quantizes_and_averages(shared_ray):
    """bfloat16 (a torch tensor here; ml_dtypes' reports numpy kind 'V' in
    the reference) — the plane's flagship dtype must still pass the int8
    float gate (result dtype preserved) and still be AVERAGED by
    BucketedGradSync (a kind=='f' check silently handed every rank grad
    sums, W times too large)."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            import torch

            from ray_tpu_torch.train.grad_sync import BucketedGradSync

            x = torch.full((256,), float(rank + 1), dtype=torch.bfloat16)
            q = col.allreduce(x, group_name="bf16", quantization="int8")
            assert q.dtype == x.dtype, q.dtype
            gs = BucketedGradSync(group_name="bf16", bucket_bytes=1024)
            out = gs.allreduce(
                {"w": torch.full((64,), float(rank + 1), dtype=torch.bfloat16)})
            assert out["w"].dtype == torch.bfloat16
            # mean of 1, 2 = 1.5: exact in bf16 — sums (3.0) would betray
            # the skipped division.
            return (float(q[0]), float(out["w"][0]))

    world = 2
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1], group_name="bf16")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    for q0, avg0 in outs:
        assert q0 == 3.0  # 1 + 2, exactly representable -> quant exact
        assert avg0 == 1.5
    col.destroy_collective_group("bf16")


def test_bucketed_overlap_bit_identical_to_unbucketed(shared_ray):
    """Satellite gate: the bucketed-overlap path produces byte-identical
    reduced grads vs one unbucketed fp32 allreduce (exact-representable
    grads), and stays allclose on arbitrary floats."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            from ray_tpu_torch.train.grad_sync import BucketedGradSync

            rng = np.random.default_rng(7 + rank)
            grads = {
                "w1": (rng.integers(-8, 8, (100, 33)).astype(np.float32)),
                "b1": (rng.integers(-8, 8, (257,)).astype(np.float32)),
                "w2": (rng.integers(-8, 8, (41, 19)).astype(np.float32)),
                "b2": (rng.integers(-8, 8, (5,)).astype(np.float32)),
            }
            many = BucketedGradSync("ov", bucket_bytes=4096).allreduce(grads)
            one = BucketedGradSync("ov", bucket_bytes=1 << 30).allreduce(grads)
            fuzzy = {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in grads.items()}
            fm = BucketedGradSync("ov", bucket_bytes=4096).allreduce(fuzzy)
            fo = BucketedGradSync("ov", bucket_bytes=1 << 30).allreduce(fuzzy)
            return many, one, fm, fo

    world = 2
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1], group_name="ov")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=120)
    for many, one, fm, fo in outs:
        for k in many:
            assert many[k].tobytes() == one[k].tobytes(), k
            np.testing.assert_allclose(fm[k], fo[k], rtol=1e-6, atol=1e-6)
    # Ranks agree with each other too.
    for k in outs[0][0]:
        assert outs[0][0][k].tobytes() == outs[1][0][k].tobytes()
    col.destroy_collective_group("ov")


def test_sharded_update_matches_reference_and_bounds_state(shared_ray):
    """Sharded optimizer step: bit-equal to a full (unsharded) Adam given
    exact grads, and per-rank optimizer state is ~1/W of full-model state
    (the no-host-materializes-full-state invariant, by byte accounting)."""
    shapes = {"w1": (64, 33), "b1": (257,), "w2": (41, 19)}

    def make(rank, seed_off=0):
        rng = np.random.default_rng(11 + rank + seed_off)
        return ({k: rng.integers(-4, 4, s).astype(np.float32)
                 for k, s in shapes.items()})

    params0 = make(100)  # same on every rank (seed ignores rank via offset)

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            from ray_tpu_torch.train.grad_sync import ShardedOptimizerStep

            params = {k: v.copy() for k, v in make(100).items()}
            opt = ShardedOptimizerStep("adam", lr=0.1, group_name="sh",
                                       bucket_bytes=8192)
            for step in range(3):
                grads = make(rank, seed_off=step + 1)
                params = opt.step(params, grads)
            return params, opt.state_bytes(), opt.peak_state_bytes

    world = 2
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1], group_name="sh")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=120)

    # Reference: full-model Adam over the mean grads, mirroring
    # _update_shard's exact op order (elementwise => shard-invariant).
    ref = {k: v.copy() for k, v in params0.items()}
    m = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    v = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    b1, b2, lr, eps = 0.9, 0.999, 0.1, 1e-8
    for step in range(3):
        gsum = {k: sum(make(r, seed_off=step + 1)[k] for r in range(world))
                for k in shapes}
        for k in shapes:
            g = (gsum[k] / world).astype(np.float32)
            m[k] *= b1
            m[k] += (1 - b1) * g
            v[k] *= b2
            v[k] += (1 - b2) * np.square(g)
            mhat = m[k] / (1 - b1 ** (step + 1))
            vhat = v[k] / (1 - b2 ** (step + 1))
            ref[k] = ref[k] - lr * mhat / (np.sqrt(vhat) + eps)

    full_state_bytes = 2 * sum(
        int(np.prod(s)) * 4 for s in shapes.values())  # adam m+v, full model
    for params, state_bytes, peak in outs:
        for k in shapes:
            assert params[k].dtype == np.float32
            assert params[k].tobytes() == ref[k].tobytes(), k
        # Shard-sized state: ~full/W plus per-bucket ceil padding; far from
        # ever materializing the full slots.
        assert state_bytes == peak
        assert state_bytes < full_state_bytes * 0.6, (
            state_bytes, full_state_bytes)
    assert outs[0][0]["w1"].tobytes() == outs[1][0]["w1"].tobytes()
    col.destroy_collective_group("sh")


def test_async_collectives_overlap_in_flight(shared_ray):
    """Several allreduces in flight on one ring at once (the overlap
    substrate): results arrive correct and per-op, regardless of launch
    interleaving with result collection."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            works = [col.allreduce_async(
                np.full((2048,), float((rank + 1) * (i + 1)), np.float32),
                group_name="ov2") for i in range(4)]
            return [float(w.result(60)[0]) for w in works]

    world = 2
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1], group_name="ov2")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    want = [3.0 * (i + 1) for i in range(4)]  # (1+2) * (i+1)
    assert outs == [want, want]
    col.destroy_collective_group("ov2")


def test_trainer_session_grad_sync_end_to_end(shared_ray):
    """The tentpole wiring at the trainer layer: a DataParallelTrainer train
    fn reaches the gang-bound overlap path via train.grad_sync() /
    train.sharded_optimizer() — no hand-built collective group, ranks
    rendezvous through the session's world info."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    def train_fn(config):
        import numpy as np
        import ray_tpu_torch.train as train

        ctx = train.get_context()
        rank = ctx.get_world_rank()
        grads = {"w": np.full((64, 16), float(rank + 1), np.float32)}
        reduced = train.grad_sync(bucket_bytes=1024).allreduce(grads)
        params = {"w": np.ones((64, 16), np.float32)}
        opt = train.sharded_optimizer("sgd", lr=0.5, bucket_bytes=1024)
        params = opt.step(params, grads)
        train.report({
            "reduced0": float(reduced["w"][0, 0]),
            "param0": float(params["w"][0, 0]),
            "state_bytes": opt.state_bytes(),
        })

    result = DataParallelTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ring_gs_e2e"),
    ).fit()
    m = result.metrics
    assert m["reduced0"] == 1.5        # mean of 1, 2
    assert m["param0"] == 0.25         # 1 - 0.5 * 1.5 (sgd on mean grad)
    assert m["state_bytes"] == 0       # plain sgd: no slots
    # The controller reaps the run's gang coordinator when fit() returns
    # (world-size-keyed name: an elastic resize rendezvouses fresh).
    with pytest.raises(ValueError):
        rt.get_actor("raytpu_collective:train:ring_gs_e2e:w2")


def test_broadcast_meta_survives_late_receiver(shared_ray):
    """src's establish is not gated on its successor's, so the broadcast
    meta notify can land before the receiver has built its ring. It must be
    stashed and adopted at establish (like pending hellos) — not silently
    dropped, which stranded the late rank until the step timeout."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank, world):
            if rank == 1:
                time.sleep(1.5)  # src's successor reaches its first op late
            v = col.broadcast(
                np.full((32,), 7.0, np.float32) if rank == 0 else None,
                src_rank=0, group_name="latemeta")
            return float(v[0])

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1, 2],
                                group_name="latemeta")
    outs = rt.get([m.run.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    assert outs == [7.0] * world
    col.destroy_collective_group("latemeta")


def test_ring_recovers_from_single_link_death(shared_ray):
    """A dead peer socket must not strand the gang. For world >= 3 the
    failing rank's predecessor is healthy and will never re-dial, so
    re-establish must carry the surviving inbound link — and the op counter,
    which the untouched ranks keep — for the next collective on the SAME
    group/epoch to succeed."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def sync(self, rank, world):
            r = col.allreduce(np.full((512,), rank + 1.0, np.float32),
                              group_name="heal")
            return float(r[0])

        def kill_succ_link(self):
            import asyncio
            from ray_tpu_torch.collective import ring as _ring
            from ray_tpu_torch.core import api as _api

            core = _api._require_worker()
            with _ring._LOCK:
                ring = next(r for (g, _b, _e), r in _ring._RINGS.items()
                            if g.endswith(":heal"))
            asyncio.run_coroutine_threadsafe(
                ring.succ_conn.close(), core.loop).result(10)
            return True

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1, 2], group_name="heal")
    outs = rt.get([m.sync.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    assert outs == [6.0] * world
    rt.get(members[0].kill_succ_link.remote(), timeout=30)
    time.sleep(1.0)  # let the EOF reach the successor's read loop
    outs = rt.get([m.sync.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    assert outs == [6.0] * world
    col.destroy_collective_group("heal")


def test_recv_honors_full_timeout_in_one_wait(shared_ray):
    """Satellite: recv() with no sender fails at ~timeout (one server-side
    event wait), not timeout+30 (the old rt.get over-wait) and not in 30s
    polling slices."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def lonely_recv(self):
            t0 = time.monotonic()
            try:
                col.recv(src_rank=0, group_name="p2p", timeout=2.0)
            except TimeoutError:
                return time.monotonic() - t0
            return -1.0

        def ping(self):
            return True

    members = [Member.options(max_concurrency=2).remote() for _ in range(2)]
    col.create_collective_group(members, 2, [0, 1], group_name="p2p")
    rt.get([m.ping.remote() for m in members], timeout=30)
    elapsed = rt.get(members[1].lonely_recv.remote(), timeout=30)
    assert 1.5 <= elapsed <= 6.0, elapsed  # ~2s wait + rpc slack, never 32s
    col.destroy_collective_group("p2p")


def test_ring_failure_is_typed_not_hung(shared_ray):
    """A rank that never joins the op (here: simply absent from the second
    collective) must surface as a typed CollectiveError at the step
    deadline on the ranks that did show up — the no-hang contract without
    chaos machinery (the injected-fault shapes live in scenario
    ring_link_loss)."""
    @rt.remote
    class Member(col.CollectiveActorMixin):
        def good(self, rank, world):
            out = col.allreduce(np.full((64,), rank + 1.0, np.float32),
                                group_name="tf")
            return float(out[0])

        def maybe_second(self, rank, participate):
            from ray_tpu_torch.collective import ring as _ring

            with _ring._LOCK:
                r = next(v for k, v in _ring._RINGS.items()
                         if k[0].endswith("tf"))
            r.step_timeout = 1.0  # fail fast for the test
            if not participate:
                return "sat_out"
            try:
                col.allreduce(np.full((64,), 1.0, np.float32),
                              group_name="tf", timeout=20.0)
                return "completed"
            except col.CollectiveError as e:
                # Which typed shape depends on ring position: the absent
                # rank's predecessor sees "never armed", others see the
                # step timeout or the fanned abort.
                shapes = ("timed out", "aborted", "never armed")
                return f"typed:{any(s in str(e) for s in shapes)}"

    world = 3
    members = [Member.options(max_concurrency=2).remote() for _ in range(world)]
    col.create_collective_group(members, world, [0, 1, 2], group_name="tf")
    outs = rt.get([m.good.remote(i, world) for i, m in enumerate(members)],
                  timeout=60)
    assert outs == [6.0, 6.0, 6.0]
    t0 = time.monotonic()
    outs = rt.get([m.maybe_second.remote(i, i != 1) for i, m in
                   enumerate(members)], timeout=60)
    elapsed = time.monotonic() - t0
    assert outs[1] == "sat_out"
    assert outs[0] == "typed:True" and outs[2] == "typed:True", outs
    assert elapsed < 15, elapsed
    col.destroy_collective_group("tf")
