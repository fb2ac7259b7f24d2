"""The port's elastic plane on port clusters: the cases of
``tests/test_elastic.py``, case for case.

Elastic training plane: shard-rectangle planning, raw-lane live
transfer, and in-place N->M gang resize (ray_tpu_torch/elastic/)."""
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch.elastic import plan as eplan


# ---------------------------------------------------------------------------
# Property test: the shared rectangle-intersection module
# ---------------------------------------------------------------------------


def _random_partition(rng, extent: int) -> list[tuple[int, int]]:
    """Split [0, extent) into 1..4 contiguous blocks (extent 0 => one empty
    block — zero-length dims are legal layouts)."""
    if extent == 0:
        return [(0, 0)]
    k = int(rng.integers(1, min(4, extent) + 1))
    cuts = sorted(rng.choice(np.arange(1, extent), size=k - 1, replace=False).tolist()) if k > 1 else []
    edges = [0] + [int(c) for c in cuts] + [extent]
    return list(zip(edges[:-1], edges[1:]))


def _grid_tiles(rng, shape) -> list[list]:
    """A random grid partition of the whole array: the cross product of a
    random contiguous partition per axis (rows/cols/tiles)."""
    per_axis = [_random_partition(rng, d) for d in shape]
    tiles = [[]]
    for blocks in per_axis:
        tiles = [t + [list(b)] for t in tiles for b in blocks]
    return tiles


def test_plan_pull_tiles_destination_exactly_once_randomized():
    """Randomized N->M layouts (rows/cols/tiles, odd shapes, itemsize>1,
    zero-length dims, replicated extras): planned runs must tile every
    destination byte exactly once, and executing them must materialize the
    right bytes."""
    rng = np.random.default_rng(20260804)
    for case in range(60):
        ndim = int(rng.integers(0, 4))
        shape = tuple(int(rng.integers(0, 8)) for _ in range(ndim))
        dtype = np.dtype(rng.choice(["u1", "f4", "f8"]))
        total = int(np.prod(shape)) if shape else 1
        world = np.arange(total, dtype=np.int64).reshape(shape) if shape else np.int64(7)
        world = (world + 1).astype(dtype) if dtype.kind != "u" else world.astype(dtype)
        src_tiles = _grid_tiles(rng, shape)
        src_rects = {r: rect for r, rect in enumerate(src_tiles)}
        # Replication: sometimes one extra source holds the WHOLE array.
        if rng.random() < 0.3:
            src_rects[len(src_rects)] = [[0, d] for d in shape]
        dst_tiles = _grid_tiles(rng, shape)
        dst_rect = dst_tiles[int(rng.integers(0, len(dst_tiles)))]
        prefer = eplan.rotated(src_rects, int(rng.integers(0, 5)))
        runs = eplan.plan_pull("a", shape, dtype.itemsize, src_rects,
                               dst_rect, prefer)
        # Exact-once: coverage counters over the destination region.
        dst_nbytes = eplan.rect_nbytes(eplan.norm_index(dst_rect, shape),
                                       dtype.itemsize)
        hits = np.zeros(dst_nbytes, dtype=np.int32)
        for r in runs:
            hits[r.dst_off:r.dst_off + r.nbytes] += 1
        assert (hits == 1).all() if dst_nbytes else not runs, (
            f"case {case}: shape={shape} dst={dst_rect} "
            f"multi/zero-covered bytes: {np.unique(hits)}")
        # Execute the runs against materialized source regions and compare
        # with the ground-truth slice.
        def region(rect):
            idx = tuple(slice(a, b) for a, b in eplan.norm_index(rect, shape))
            return np.ascontiguousarray(world[idx] if shape else world)

        buf = bytearray(dst_nbytes)
        for r in runs:
            src = memoryview(region(src_rects[r.src_rank])).cast("B")
            buf[r.dst_off:r.dst_off + r.nbytes] = src[r.src_off:r.src_off + r.nbytes]
        expect = region(dst_rect)
        assert bytes(buf) == expect.tobytes(), f"case {case}: wrong bytes"


def test_plan_pull_window_layouts_n_to_m():
    """1-D optimizer-window reshard N->M for odd sizes, including n <
    world (empty tail windows) and the degenerate n=0."""
    rng = np.random.default_rng(7)
    for n, N, M in [(10, 3, 2), (10, 2, 3), (7, 4, 2), (5, 8, 3), (0, 2, 3),
                    (1, 3, 1), (64, 1, 5), (17, 5, 5)]:
        flat = rng.integers(0, 255, size=max(n, 1)).astype(np.uint8)[:n]
        src_rects = {r: eplan.window_rect(n, N, r) for r in range(N)}
        for m_rank in range(M):
            dst = eplan.window_rect(n, M, m_rank)
            runs = eplan.plan_pull("w", [n], 1, src_rects, dst,
                                   eplan.rotated(src_rects, m_rank))
            lo, hi = dst[0]
            buf = bytearray(hi - lo)
            for r in runs:
                s_lo = src_rects[r.src_rank][0][0]
                buf[r.dst_off:r.dst_off + r.nbytes] = \
                    flat.tobytes()[s_lo + r.src_off:s_lo + r.src_off + r.nbytes]
            assert bytes(buf) == flat.tobytes()[lo:hi], (n, N, M, m_rank)


def test_plan_pull_prefers_sources_in_order_and_fails_loud():
    rects = {0: [[0, 8]], 1: [[0, 8]], 2: [[0, 8]]}  # fully replicated
    runs = eplan.plan_pull("p", [8], 4, rects, [[0, 8]], [2, 0, 1])
    assert [r.src_rank for r in runs] == [2]  # first preference takes all
    # A hole no source covers is a typed CoverageError, never zero-fill.
    with pytest.raises(eplan.CoverageError):
        eplan.plan_pull("p", [8], 4, {0: [[0, 3]], 1: [[5, 8]]},
                        [[0, 8]], [0, 1])
    # The failover-retry form: only the requested intervals get planned.
    runs = eplan.plan_pull("p", [8], 1, rects, [[0, 8]], [1],
                           uncovered=[(2, 5)])
    assert len(runs) == 1 and (runs[0].dst_off, runs[0].nbytes) == (2, 3)


def test_sharded_optimizer_window_export_adopt_matches_reference(monkeypatch):
    """ShardedOptimizerStep windows exported at world 3, resharded through
    the plan layer, adopted at world 2: every adopted window must be
    byte-identical to slicing the known full state."""
    from ray_tpu_torch.train.grad_sync import ShardedOptimizerStep

    from ray_tpu_torch import collective as col

    n_by_bucket = {0: 300, 1: 17}
    full = {
        (bi, slot): np.random.default_rng(bi * 10 + hash(slot) % 7).normal(
            size=n).astype(np.float32)
        for bi, n in n_by_bucket.items() for slot in ("m", "v")
    }

    def make_opt(world, rank):
        opt = ShardedOptimizerStep("adam", group_name="g", bucket_bytes=1024)
        opt._t = 5
        for bi, n in n_by_bucket.items():
            shard = -(-n // world)
            opt._bucket_n[bi] = n
            slots = opt._state.setdefault(bi, {})
            for slot in ("m", "v"):
                padded = np.zeros(shard, dtype=np.float32)
                lo = min(n, rank * shard)
                hi = min(n, lo + shard)
                padded[:hi - lo] = full[(bi, slot)][lo:hi]
                slots[slot] = padded
        return opt

    exports = {}
    for r in range(3):
        monkeypatch.setattr(col, "get_rank", lambda g, _r=r: _r)
        exports[r] = make_opt(3, r).live_shards()
    # Every exported window carries its clipped rect [lo, lo+len) over n.
    for r, shards in exports.items():
        for path, (arr, lo, n) in shards.items():
            bi = int(path.split(".")[1])
            assert n == n_by_bucket[bi]
            assert lo == r * -(-n // 3)
            assert arr.size == max(0, min(-(-n // 3), n - lo))
    monkeypatch.setattr(col, "get_collective_group_size", lambda g: 2)
    for new_rank in range(2):
        # Reshard each path via the plan layer (what transfer.pull_state
        # does over the wire, here executed as local copies).
        adopted = {}
        for path in exports[0]:
            _arr0, _lo0, n = exports[0][path]
            src_rects = {r: [[exports[r][path][1],
                              exports[r][path][1] + exports[r][path][0].size]]
                         for r in range(3)}
            dst = eplan.window_rect(n, 2, new_rank)
            itemsize = 4
            buf = bytearray(eplan.rect_nbytes(dst, itemsize))
            for run in eplan.plan_pull(path, [n], itemsize, src_rects, dst,
                                       eplan.rotated(src_rects, new_rank)):
                src_bytes = exports[run.src_rank][path][0].tobytes()
                buf[run.dst_off:run.dst_off + run.nbytes] = \
                    src_bytes[run.src_off:run.src_off + run.nbytes]
            adopted[path] = (np.frombuffer(bytes(buf), np.float32),
                             dst[0][0], n)
        opt2 = ShardedOptimizerStep("adam", group_name="g", bucket_bytes=1024)
        opt2.adopt_shards(adopted, t=5)
        assert opt2._t == 5
        for bi, n in n_by_bucket.items():
            shard = -(-n // 2)
            lo = min(n, new_rank * shard)
            hi = min(n, lo + shard)
            for slot in ("m", "v"):
                window = opt2._state[bi][slot]
                assert window.size == shard  # uniform re-padded allocation
                assert window[:hi - lo].tobytes() == \
                    full[(bi, slot)][lo:hi].tobytes()
                assert not window[hi - lo:].any()  # pad stays exact zeros


# ---------------------------------------------------------------------------
# Raw-lane transfer between workers
# ---------------------------------------------------------------------------


class _Party:
    """Actor hosting one side of a transfer (runs in its own worker)."""

    def export(self, tid, rank, seed, sharded_n=None):
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.elastic import transfer

        rng = np.random.default_rng(seed)
        rep = {"w": rng.normal(size=(33, 17)).astype(np.float32),
               "b": rng.normal(size=()).astype(np.float64)}
        sharded = None
        if sharded_n is not None:
            n, world = sharded_n
            shard = -(-n // world)
            lo = min(n, rank * shard)
            win = np.arange(lo, min(n, lo + shard), dtype=np.float32) * (1 + seed)
            sharded = {"opt.0.m": (win, lo, n)}
        meta = transfer.export_state(tid, rank, rep, sharded,
                                     seq=3, meta={"step": 9})
        meta["addr"] = _api._require_worker().address
        return meta

    def pull(self, tid, sources, world, rank, self_rank=None):
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.elastic import transfer

        core = _api._require_worker()
        res = core._run(
            transfer.pull_state(core, tid, sources, world, rank,
                                self_rank=self_rank), timeout=120)
        out = {"stats": res["stats"], "meta": res["meta"], "seq": res["seq"],
               "state": {k: v.tobytes() for k, v in res["state"].items()},
               "sharded": {k: (a.tobytes(), lo, n)
                           for k, (a, lo, n) in res["sharded"].items()}}
        # Counting-shim proof, strongest form: the live pull path never even
        # LOADS the blob-store/checkpoint machinery in this process, let
        # alone reads from it.
        import sys

        out["ckpt_modules"] = sorted(
            m for m in sys.modules if m.startswith("ray_tpu_torch.ckpt"))
        return out

    def release(self, tid):
        from ray_tpu_torch.elastic import transfer

        return transfer.release(tid)


def _expected_rep(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(33, 17)).astype(np.float32),
            "b": rng.normal(size=()).astype(np.float64)}


def test_transfer_pull_replicated_and_windows_zero_pickle(fresh_cluster):
    """Two workers: B pulls A's replicated arrays + its 1-D window over the
    raw lane; payload bytes identical, wire counters move, and the pulling
    worker never loads any ckpt/blob-store module (the no-disk proof)."""
    fresh_cluster.add_node(num_cpus=2)
    rt.init(address=fresh_cluster.address)
    try:
        Party = rt.remote(_Party)
        a, b = Party.remote(), Party.remote()
        tid = "t-unit-1"
        meta_a = rt.get(a.export.remote(tid, 0, seed=1, sharded_n=(10, 2)), timeout=60)
        meta_b = rt.get(b.export.remote(tid, 1, seed=1, sharded_n=(10, 2)), timeout=60)
        # World 1 target on B: full windows + replicated arrays, sources
        # rank0=A (remote) and rank1=B (local fast path).
        out = rt.get(b.pull.remote(tid, [meta_a, meta_b], 1, 0, 1), timeout=120)
        exp = _expected_rep(1)
        assert out["state"]["w"] == exp["w"].tobytes()
        assert out["state"]["b"] == exp["b"].tobytes()
        arr_bytes, lo, n = out["sharded"]["opt.0.m"]
        assert (lo, n) == (0, 10)
        got = np.frombuffer(arr_bytes, np.float32)
        # rank0's window [0,5) scaled by (1+seed)=2, rank1's [5,10) too.
        assert got.tobytes() == (np.arange(10, dtype=np.float32) * 2).tobytes()
        assert out["meta"] == {"step": 9} and out["seq"] == 3
        st = out["stats"]
        assert st["wire_bytes"] > 0 and st["local_bytes"] > 0
        assert st["bytes"] == st["wire_bytes"] + st["local_bytes"]
        assert st["mb_s"] > 0 and st["failovers"] == 0
        assert out["ckpt_modules"] == [], (
            f"live pull loaded blob-store code: {out['ckpt_modules']}")
        assert rt.get(a.release.remote(tid), timeout=30)
        assert not rt.get(a.release.remote(tid), timeout=30)  # idempotent
    finally:
        rt.shutdown()


def test_transfer_failover_reroutes_dropped_source(fresh_cluster):
    """Chaos-dropped frames from the first source: the puller's deadline
    fails that source typed, re-plans onto the replica, and the assembled
    bytes are still exact."""
    from ray_tpu_torch.chaos import plan as chaos_plan
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    cfg.elastic_transfer_timeout_s = 3.0
    cfg.chaos_spec = json.dumps({
        "seed": 5,
        "rules": [{"site": "elastic.reshard.transfer", "kind": "drop",
                   "nth": 1, "ctx": {"src": "0"}}],
    })
    chaos_plan.install_from_json(cfg.chaos_spec)
    fresh_cluster.add_node(num_cpus=3)
    rt.init(address=fresh_cluster.address)
    try:
        Party = rt.remote(_Party)
        a, b, c = Party.remote(), Party.remote(), Party.remote()
        tid = "t-unit-drop"
        metas = [rt.get(w.export.remote(tid, r, seed=4), timeout=60)
                 for r, w in ((0, a), (1, b))]
        # C (no local export) pulls; the preferred source's first frame is
        # chaos-dropped -> after the 3s deadline its runs re-plan onto the
        # other replica.
        out = rt.get(c.pull.remote(tid, metas, 1, 0, None), timeout=120)
        exp = _expected_rep(4)
        assert out["state"]["w"] == exp["w"].tobytes()
        assert out["state"]["b"] == exp["b"].tobytes()
        assert out["stats"]["failovers"] >= 1, out["stats"]
    finally:
        rt.shutdown()
        chaos_plan.uninstall()


def test_transfer_uncoverable_window_fails_typed(fresh_cluster):
    """A window whose only holder is gone must raise the typed error (the
    controller's checkpoint-fallback trigger), never hand back zeros."""
    fresh_cluster.add_node(num_cpus=2)
    rt.init(address=fresh_cluster.address)
    try:
        Party = rt.remote(_Party)
        a, b = Party.remote(), Party.remote()
        tid = "t-unit-hole"
        meta_a = rt.get(a.export.remote(tid, 0, seed=2, sharded_n=(10, 2)), timeout=60)
        # Only rank 0's half of the window is offered; world-1 target needs
        # [0, 10).
        with pytest.raises(Exception) as ei:
            rt.get(b.pull.remote(tid, [meta_a], 1, 0, None), timeout=120)
        assert "ElasticTransferError" in str(ei.value) or "uncoverable" in str(ei.value)
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# End-to-end: live in-place gang resize on a preemption notice
# ---------------------------------------------------------------------------


def _live_fn(config):
    """Deterministic SPMD steps with a ShardedOptimizerStep; state kept
    live every step. Parks at the barrier step (first incarnation) so the
    resize point is a deterministic boundary."""
    from ray_tpu_torch import train

    ctx = train.get_context()
    world = ctx.get_world_size()
    steps, barrier = config["steps"], config["barrier_step"]
    opt = ctx.sharded_optimizer("adam", lr=0.1, bucket_bytes=512)
    d = 96
    resumed = train.live_resume()
    if resumed is not None:
        params = np.array(resumed["state"]["params"], copy=True)
        opt.adopt_shards(resumed["sharded"], t=resumed["meta"]["t"])
        start = resumed["meta"]["step"] + 1
        full = opt.full_state()
        h = hashlib.blake2b(params.tobytes(), digest_size=12)
        for k in sorted(full):
            h.update(full[k].tobytes())
        train.report({"resume_digest": h.hexdigest(), "world_size": world,
                      "resume_step": start - 1})
    else:
        params = np.zeros(d, dtype=np.float32)
        start = 0
    for i in range(start, steps):
        target = np.random.default_rng(100 + i).normal(size=d).astype(np.float32)
        params = opt.step({"p": params}, {"p": params - target})["p"]
        full = opt.full_state()
        h = hashlib.blake2b(params.tobytes(), digest_size=12)
        for k in sorted(full):
            h.update(full[k].tobytes())
        train.report({"step": i, "digest": h.hexdigest(), "world_size": world})
        train.keep_live({"params": params}, sharded=opt.live_shards(),
                        meta={"step": i, "t": opt._t})
        if i == barrier and world == config["start_world"]:
            if ctx.get_world_rank() == 0:
                open(config["marker"], "w").close()
            while not ctx.should_stop():
                time.sleep(0.05)
            raise RuntimeError("stopped at resize barrier")


def test_live_resize_on_preemption_is_byte_exact(fresh_cluster):
    """2-worker gang on two nodes; one node drains mid-run (the preemption
    notice surface). The controller live-reshards to world 1 in place: no
    checkpoint restore, optimizer windows byte-identical across the resize
    (resume digest == the parked boundary's digest), steps contiguous."""
    import threading

    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.train import (
        DataParallelTrainer,
        ElasticScalingPolicy,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )

    get_config().elastic_transfer_timeout_s = 15.0
    n1 = fresh_cluster.add_node(num_cpus=1)
    n2 = fresh_cluster.add_node(num_cpus=1)
    rt.init(address=fresh_cluster.address)
    try:
        tmp = tempfile.mkdtemp()
        marker = os.path.join(tmp, "progress")
        steps = 6
        scaling = ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1})
        trainer = DataParallelTrainer(
            _live_fn,
            train_loop_config={"steps": steps, "barrier_step": 2,
                               "start_world": 2, "marker": marker},
            scaling_config=scaling,
            run_config=RunConfig(
                name="live-e2e", storage_path=tmp,
                failure_config=FailureConfig(max_failures=0),
                elastic_live=True,
            ),
            scaling_policy=ElasticScalingPolicy(
                scaling, min_workers=1, max_workers=2,
                resize_cooldown_s=3600.0),
            controller_as_actor=False,
        )

        from ray_tpu_torch.core import api as _api

        def drain_when_progressing():
            deadline = time.time() + 90
            while not os.path.exists(marker) and time.time() < deadline:
                time.sleep(0.1)
            core = _api._require_worker()
            # Drain one gang node (whichever rank landed there — survivor
            # ranks reassign in old-rank order and new rank 0 stays
            # canonical either way).
            core._run(core.controller.call("drain_node",
                                           {"node_id": n2.node_id}))

        t = threading.Thread(target=drain_when_progressing, daemon=True)
        t.start()
        result = trainer.fit()
        t.join()
        assert result.error is None, result.error
        by_step, resume = {}, None
        for m in result.metrics_history:
            if "resume_digest" in m:
                resume = m
            elif "step" in m:
                by_step[m["step"]] = m
        assert sorted(by_step) == list(range(steps)), sorted(by_step)
        sizes = [by_step[i]["world_size"] for i in range(steps)]
        assert sizes[0] == 2 and sizes[-1] == 1, sizes
        assert resume is not None, "no live resume happened"
        assert resume["world_size"] == 1
        bstep = resume["resume_step"]
        # Byte-exactness across the wire: the reassembled full state on the
        # 1-host mesh digests identically to the parked 2-host boundary.
        assert resume["resume_digest"] == by_step[bstep]["digest"]
    finally:
        rt.shutdown()
