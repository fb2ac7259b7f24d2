"""The port's checkpoint plane on port clusters: the cases of
``tests/test_checkpoint_plane.py``, plus the port's LLMServer hot-swap.
``test_registry_state_api_and_dashboard`` is split in two:
``test_registry_state_api`` and ``test_registry_on_dashboard``.
``test_llm_server_weights_channel_
swaps_to_published_manifest`` is the port's own: an LLMServer on the CPU
swaps to a published manifest and decodes as an engine built on that tree.

Checkpoint & weight-publication plane (ray_tpu_torch/ckpt/): async sharded
saves with content-addressed dedup, atomic manifest commit, resharded
restore, chunk-refcount retention, controller registry, serve hot-swap.

The pure-plane tests run against tmp storage with no cluster; the
registry/publication tests run one shared session.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401
from ray_tpu_torch import ckpt


@pytest.fixture(autouse=True)
def _chaos_clean():
    from ray_tpu_torch.chaos import plan as _plan

    _plan.uninstall()
    yield
    _plan.uninstall()


_FROZEN = np.arange(32 * 24, dtype=np.float32).reshape(32, 24)


def _tree(step: int) -> dict:
    # hot: distinct bytes per chunk AND per step (value-offset keeps it
    # disjoint from frozen's bytes, so within-save dedup stays zero).
    hot = (1000.0 + np.arange(32 * 16, dtype=np.float32) * (step + 1)).reshape(32, 16)
    return {
        "model": {
            "frozen": _FROZEN,  # never changes across steps: dedup fodder
            "hot": hot,
        },
        "opt": {"step": np.int64(step), "nested": [np.ones(7), np.zeros((3, 3))]},
    }


# ---------------------------------------------------------------------------
# save / dedup / restore (no cluster)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip_nested_tree(tmp_path):
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=1024)
    try:
        m = saver.save(1, _tree(1))
        got = ckpt.restore_tree(m, saver.chunks, verify=True)
        assert np.array_equal(got["model"]["frozen"], _FROZEN)
        assert np.array_equal(got["model"]["hot"], _tree(1)["model"]["hot"])
        assert got["opt"]["step"] == 1 and got["opt"]["step"].shape == ()
        assert isinstance(got["opt"]["nested"], list)
        assert np.array_equal(got["opt"]["nested"][1], np.zeros((3, 3)))
    finally:
        saver.close()


def test_incremental_save_dedups_unchanged_chunks(tmp_path):
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=512)
    try:
        m1 = saver.save(1, _tree(1))
        m2 = saver.save(2, _tree(2))  # only "hot" (and the scalar) changed
        assert m1["bytes_new"] == m1["bytes_total"]  # cold store: full save
        assert m2["bytes_new"] < m2["bytes_total"]
        assert m2.dedup_ratio > 0.4, m2.summary()
        # The listing carries the ratio (the /api/checkpoints column).
        rows = saver.manifests.list()
        assert rows[-1]["dedup_ratio"] == round(m2.dedup_ratio, 4)
    finally:
        saver.close()


def test_async_save_overlaps_step_path(tmp_path):
    """save_async returns after the snapshot; the commit lands in the
    background and the future resolves to the committed manifest."""
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=4096)
    try:
        futs = [saver.save_async(s, _tree(s)) for s in range(3)]
        assert saver.last_stall_s < 10  # the handoff timed, not the write
        manifests = [f.result(timeout=60) for f in futs]
        assert [m["step"] for m in manifests] == [0, 1, 2]
        assert saver.manifests.list_ids() == sorted(m.ckpt_id for m in manifests)
    finally:
        saver.close()


def test_manifest_atomicity_under_injected_chunk_write_failure(tmp_path):
    """The satellite invariant: a failed chunk write aborts the WHOLE
    attempt — nothing staged survives, no uncommitted manifest is ever
    listed, and the attempt's already-written chunks are reclaimed."""
    from ray_tpu_torch import chaos

    chaos.install(chaos.FaultSchedule.from_spec({
        "seed": 0,
        "rules": [{"site": "ckpt.chunk.write", "kind": "error", "nth": 3}],
    }))
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=512)
    try:
        fut = saver.save_async(1, _tree(1))
        with pytest.raises(chaos.ChaosError):
            fut.result(timeout=60)
        assert saver.manifests.list_ids() == []
        assert saver.manifests.verify()["ok"], saver.manifests.verify()
        assert os.listdir(saver.manifests.staging) == []
        chaos.uninstall()
        m = saver.save(2, _tree(2))  # the plane recovers on the next step
        assert saver.manifests.list_ids() == [m.ckpt_id]
        got = ckpt.restore(m, saver.chunks)
        assert np.array_equal(got["model/frozen"], _FROZEN)
    finally:
        saver.close()


def test_worker_death_mid_save_never_commits(tmp_path):
    """Gang protocol: one of two workers dies mid-save (its part never
    acks) — commit_parts discards the attempt and reclaims the orphaned
    chunks of the dead attempt."""
    from ray_tpu_torch import chaos

    store = ckpt.ChunkStore(str(tmp_path), chunk_size=1024)
    ms = ckpt.ManifestStore(str(tmp_path), chunk_store=store)
    rows = 16
    data = np.arange(rows * 32, dtype=np.float32).reshape(rows, 32)

    def snap(rank):
        lo, hi = rank * (rows // 2), (rank + 1) * (rows // 2)
        return {"w": {"dtype": "float32", "shape": [rows, 32],
                      "shards": [([[lo, hi], [0, 32]], data[lo:hi])]}}

    chaos.install(chaos.FaultSchedule.from_spec({
        "seed": 1,
        "rules": [{"site": "ckpt.worker.kill_mid_save", "kind": "kill",
                   "ctx": {"rank": "1"}}],
    }))
    parts = []
    for rank in range(2):
        try:
            parts.append(ckpt.write_part(store, snap(rank), rank=rank, step=1))
        except ckpt.WorkerKilledMidSave:
            pass
    chaos.uninstall()
    assert len(parts) == 1
    with pytest.raises(ckpt.CommitAborted):
        ckpt.commit_parts(ms, ckpt.new_ckpt_id(1), 1, parts, expected_workers=2)
    assert ms.list_ids() == []
    assert ms.verify()["ok"], ms.verify()  # rank 0's chunks reclaimed
    # Same snapshot with both workers alive commits and restores whole.
    parts = [ckpt.write_part(store, snap(r), rank=r, step=2) for r in range(2)]
    m = ckpt.commit_parts(ms, ckpt.new_ckpt_id(2), 2, parts, expected_workers=2)
    assert np.array_equal(ckpt.restore(m, store)["w"], data)


def test_resharded_restore_n_to_m_byte_identical(tmp_path):
    """An N-shard checkpoint restores onto M target shards byte-identically
    to the same-mesh restore — rows, columns, and 2-D tiles."""
    store = ckpt.ChunkStore(str(tmp_path), chunk_size=256)
    ms = ckpt.ManifestStore(str(tmp_path), chunk_store=store)
    rows, cols = 24, 20
    data = np.arange(rows * cols, dtype=np.float64).reshape(rows, cols)
    parts = []
    for rank in range(4):  # N=4 source hosts, row-sharded
        lo, hi = rank * (rows // 4), (rank + 1) * (rows // 4)
        parts.append(ckpt.write_part(store, {
            "w": {"dtype": "float64", "shape": [rows, cols],
                  "shards": [([[lo, hi], [0, cols]], data[lo:hi])]}
        }, rank=rank, step=1))
    m = ckpt.commit_parts(ms, ckpt.new_ckpt_id(1), 1, parts, expected_workers=4)
    same_mesh = ckpt.restore(m, store)["w"]
    assert same_mesh.tobytes() == data.tobytes()
    # M=3 uneven row shards (crossing source boundaries).
    cuts = [0, 5, 17, rows]
    got = np.concatenate([
        ckpt.restore(m, store, target_indices={"w": [[cuts[i], cuts[i + 1]], [0, cols]]})["w"]
        for i in range(3)
    ])
    assert got.tobytes() == data.tobytes()
    # M=2 COLUMN shards: every target fetches strided ranges from every
    # source shard (the general redistribution case).
    left = ckpt.restore(m, store, target_indices={"w": [[0, rows], [0, 7]]})["w"]
    right = ckpt.restore(m, store, target_indices={"w": [[0, rows], [7, cols]]})["w"]
    assert np.array_equal(np.concatenate([left, right], axis=1), data)
    # A 2-D tile in the middle.
    tile = ckpt.restore(m, store, target_indices={"w": [[3, 21], [4, 15]]})["w"]
    assert np.array_equal(tile, data[3:21, 4:15])


def test_restore_reads_only_needed_bytes(tmp_path):
    """The memory-efficiency contract: restoring a small slice reads a
    small fraction of the checkpoint's bytes (ranged preads, not whole
    chunks of the whole array)."""
    store = ckpt.ChunkStore(str(tmp_path), chunk_size=1024)
    ms = ckpt.ManifestStore(str(tmp_path), chunk_store=store)
    data = np.zeros((256, 256), np.float32)  # 256 KiB
    part = ckpt.write_part(store, {
        "w": {"dtype": "float32", "shape": [256, 256],
              "shards": [([[0, 256], [0, 256]], data)]}}, step=1)
    m = ckpt.commit_parts(ms, ckpt.new_ckpt_id(1), 1, [part], 1)

    read = {"n": 0}
    orig = store.pread

    def counting_pread(digest, off, ln):
        read["n"] += ln
        return orig(digest, off, ln)

    store.pread = counting_pread
    got = ckpt.restore(m, store, target_indices={"w": [[0, 8], [0, 256]]})["w"]
    assert got.shape == (8, 256)
    assert read["n"] == 8 * 256 * 4  # exactly the slice, not the array


def test_chunk_refcount_eviction_topk(tmp_path):
    """Top-K retention deletes only chunks no surviving manifest references;
    the shared frozen chunk outlives every eviction."""
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=1 << 20, num_to_keep=2)
    try:
        frozen_digest = None
        for s in range(4):
            m = saver.save(s, _tree(s))
            for d, _sz in m["arrays"]["model/frozen"]["shards"][0]["chunks"]:
                frozen_digest = d
        ids = saver.manifests.list_ids()
        assert len(ids) == 2
        assert [saver.manifests.load(i)["step"] for i in sorted(ids,
                key=lambda i: saver.manifests.load(i)["step"])] == [2, 3]
        assert saver.manifests.evicted_manifests == 2
        assert saver.manifests.evicted_chunks > 0  # old hot chunks reclaimed
        assert saver.chunks.contains(frozen_digest)  # shared chunk survived
        ver = saver.manifests.verify()
        assert ver["ok"], ver  # refcounts balance: no orphans, no missing
    finally:
        saver.close()


def test_manifest_corruption_detected_on_verify(tmp_path):
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=1024)
    try:
        m = saver.save(1, _tree(1))
        digest = m["arrays"]["model/hot"]["shards"][0]["chunks"][0][0]
        with open(saver.chunks.path(digest), "r+b") as f:
            f.seek(0)
            f.write(b"\xff\xff\xff\xff")
        with pytest.raises(ckpt.ChunkCorruption):
            ckpt.restore(m, saver.chunks, verify=True)
    finally:
        saver.close()


# ---------------------------------------------------------------------------
# CheckpointManager satellites (train/checkpoint.py)
# ---------------------------------------------------------------------------

def test_checkpoint_manager_torn_register_not_adopted(tmp_path, monkeypatch):
    """Kill mid-copy: the out-of-storage copy path stages first, so a crash
    leaves only .staging garbage — a reloaded manager never lists (and the
    storage root never contains) a torn checkpoint_NNNNNN dir."""
    from ray_tpu_torch.train import CheckpointManager

    storage = str(tmp_path / "runs")
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(b"x" * 128)
    (src / "b.bin").write_bytes(b"y" * 128)
    mgr = CheckpointManager(storage)

    def torn_copytree(s, d, **kw):
        os.makedirs(d)
        shutil.copy(os.path.join(s, "a.bin"), d)  # half the payload...
        raise OSError("killed mid-copy")  # ...then the crash

    monkeypatch.setattr("ray_tpu_torch.train.checkpoint.shutil.copytree", torn_copytree)
    with pytest.raises(OSError):
        mgr.register(str(src), {"acc": 0.5})
    monkeypatch.undo()
    assert not [d for d in os.listdir(storage) if d.startswith("checkpoint_")]
    mgr2 = CheckpointManager(storage)  # reload: sweeps staging, adopts nothing
    assert mgr2.latest is None
    assert not os.path.exists(os.path.join(storage, ".staging"))
    # And a clean register still lands atomically afterwards.
    c = mgr2.register(str(src), {"acc": 0.9})
    assert sorted(os.listdir(c.path)) == ["a.bin", "b.bin"]


def test_checkpoint_manager_dangling_evict_entries_repaired(tmp_path):
    """An eviction that crashed after rmtree but before the index
    repersisted: reload filters the dangling entry AND rewrites the state
    file, and evictions are tallied."""
    from ray_tpu_torch.train import CheckpointManager

    storage = str(tmp_path / "runs")
    mgr = CheckpointManager(storage)
    paths = []
    for i in range(3):
        src = tmp_path / f"src{i}"
        src.mkdir()
        (src / "x.txt").write_text(str(i))
        paths.append(mgr.register(str(src), {"i": i}).path)
    shutil.rmtree(paths[0])  # the simulated crash-after-rmtree
    mgr2 = CheckpointManager(storage)
    assert [c.path for _s, _i, c in mgr2._checkpoints] == paths[1:]
    st = json.load(open(os.path.join(storage, "checkpoint_manager.json")))
    assert len(st["checkpoints"]) == 2  # filter-AND-repersist
    # Eviction tally (train.checkpoint.evicted_total feeds the reporter).
    mgr3 = CheckpointManager(str(tmp_path / "runs2"), num_to_keep=1)
    for i in range(3):
        src = tmp_path / f"top{i}"
        src.mkdir()
        (src / "x.txt").write_text(str(i))
        mgr3.register(str(src), {"i": i})
    assert mgr3.evicted_total == 2


def test_checkpoint_manager_releases_manifest_refs_on_eviction(tmp_path):
    """The retention fold: evicting a manifest_ref checkpoint dir releases
    its manifest's chunk refcounts through the attached ManifestStore."""
    from ray_tpu_torch.train import CheckpointManager

    storage = str(tmp_path / "plane")
    saver = ckpt.AsyncSaver(storage, chunk_size=1024)
    try:
        mgr = CheckpointManager(str(tmp_path / "runs"), num_to_keep=1,
                                manifest_store=saver.manifests)
        for s in range(2):
            m = saver.save(s, _tree(s))
            ref = tmp_path / f"ref{s}"
            ref.mkdir()
            (ref / "manifest_ref.json").write_text(json.dumps(
                {"ckpt_id": m.ckpt_id, "step": s, "storage": storage}))
            mgr.register(str(ref), {"step": s})
        assert len(saver.manifests.list_ids()) == 1  # step 0's manifest released
        assert saver.manifests.load(saver.manifests.list_ids()[0])["step"] == 1
        assert saver.manifests.verify()["ok"]
    finally:
        saver.close()


def test_checkpoint_manager_lazy_manifest_fold(tmp_path):
    """Without an attached store (the TrainController shape — eviction in a
    different process than the savers), the fold opens a ManifestStore
    lazily from the ref's storage root and still reclaims chunks."""
    from ray_tpu_torch.train import CheckpointManager

    storage = str(tmp_path / "plane")
    saver = ckpt.AsyncSaver(storage, chunk_size=1024)
    try:
        mgr = CheckpointManager(str(tmp_path / "runs"), num_to_keep=1)
        for s in range(3):
            m = saver.save(s, _tree(s))
            ref = tmp_path / f"ref{s}"
            ref.mkdir()
            (ref / "manifest_ref.json").write_text(json.dumps(
                {"ckpt_id": m.ckpt_id, "step": s, "storage": storage}))
            mgr.register(str(ref), {"step": s})
        remaining = ckpt.ManifestStore(storage)
        assert len(remaining.list_ids()) == 1
        assert remaining.load(remaining.list_ids()[0])["step"] == 2
        assert remaining.verify()["ok"]
    finally:
        saver.close()


def test_close_drains_queued_saves(tmp_path):
    """close() writes queued saves out (their futures resolve) instead of
    dropping them — a dropped save would hang any result() waiter."""
    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=4096)
    futs = [saver.save_async(s, _tree(s)) for s in range(3)]
    saver.close()
    ids = [f.result(timeout=1).ckpt_id for f in futs]  # already resolved
    assert saver.manifests.list_ids() == sorted(ids)


def test_commit_parts_dedups_replicated_rectangles(tmp_path):
    """A leaf replicated across ranks contributes ONE shard per rectangle
    to the merged manifest (restore reads it once, coverage stays exact)."""
    store = ckpt.ChunkStore(str(tmp_path), chunk_size=1024)
    ms = ckpt.ManifestStore(str(tmp_path), chunk_store=store)
    rep = np.arange(64, dtype=np.float32)
    parts = [ckpt.write_part(store, {
        "rep": {"dtype": "float32", "shape": [64],
                "shards": [([[0, 64]], rep)]}}, rank=r, step=1) for r in range(3)]
    m = ckpt.commit_parts(ms, ckpt.new_ckpt_id(1), 1, parts, expected_workers=3)
    assert len(m["arrays"]["rep"]["shards"]) == 1
    assert np.array_equal(ckpt.restore(m, store)["rep"], rep)


# ---------------------------------------------------------------------------
# the seeded chaos scenario (fresh in-process cluster per run — MUST come
# before the shared-session tests: a scenario refuses to run while this
# process is already a driver, and module fixtures tear down at module end)
# ---------------------------------------------------------------------------

def test_ckpt_chaos_scenario_smoke():
    """The seeded ckpt_kill_mid_save scenario end to end (quick shape):
    aborted attempts invisible, committed manifests byte-identical after
    the faults, refcounts balanced after eviction, delayed swap lands."""
    from ray_tpu_torch.chaos.scenarios import run_scenario

    report = run_scenario("ckpt_kill_mid_save", seed=11, quick=True)
    assert report["ok"], report
    assert report["details"]["aborted"] >= 2
    assert report["details"]["committed"] >= 2
    assert report["invariants"]["faults_visible_in_metrics"]["ok"]


def test_ckpt_scenario_replays_identically():
    from ray_tpu_torch.chaos.scenarios import run_scenario

    r1 = run_scenario("ckpt_kill_mid_save", seed=77, quick=True)
    assert r1["ok"], r1
    r2 = run_scenario("ckpt_kill_mid_save", seed=77, quick=True)
    assert r2["ok"], r2
    assert r1["injections"] and r1["injections"] == r2["injections"]


# ---------------------------------------------------------------------------
# controller registry + publication + hot-swap (one shared session)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_cluster():
    from ray_tpu_torch import serve

    rt.init(num_cpus=8)
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()


def test_registry_state_api(ckpt_cluster, tmp_path):
    from ray_tpu_torch import chaos, state

    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=2048, channel="regtest")
    try:
        m1 = saver.save(1, _tree(1))
        chaos.install(chaos.FaultSchedule.from_spec({
            "seed": 0,
            "rules": [{"site": "ckpt.chunk.write", "kind": "error", "nth": 1}]}))
        with pytest.raises(chaos.ChaosError):
            saver.save(2, _tree(2))
        chaos.uninstall()
        out = state.list_checkpoints(channel="regtest")
        by_status = {c["status"] for c in out["checkpoints"]}
        assert by_status == {"committed", "aborted"}
        committed = [c for c in out["checkpoints"] if c["status"] == "committed"]
        assert committed[0]["ckpt_id"] == m1.ckpt_id
        assert committed[0]["dedup_ratio"] == 0.0  # cold store: full save
        assert out["channels"]["regtest"] == m1.ckpt_id  # aborted never published
        # Filters + truncation markers follow the list conventions.
        only_aborted = state.list_checkpoints(channel="regtest", status="aborted")
        assert only_aborted["total"] == 1 and only_aborted["truncated"] == 0
    finally:
        saver.close()


def _plane_train_fn(config):
    import numpy as np

    from ray_tpu_torch import train as _train

    ctx = _train.get_context()
    fut = None
    for s in range(config["steps"]):
        tree = {"w": np.full(128, float(s), np.float32)}
        if ctx.get_world_rank() == 0:
            fut = _train.save_pytree_async(tree, {"step": s})
        else:
            _train.report({"step": s})
    if fut is not None:
        # The session guarantee: result() happens-after the checkpoint
        # report is queued, so the controller's final poll absorbs it.
        fut.result(timeout=120)


def test_train_session_plane_saves_fold_into_manager(ckpt_cluster, tmp_path):
    """save_pytree_async end to end through a real gang: the committed
    manifest's ref dir rides the normal report/adopt path, and the adopted
    checkpoint restores to the last step's weights."""
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    trainer = DataParallelTrainer(
        _plane_train_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="plane", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    ref = json.load(open(os.path.join(result.checkpoint.path, "manifest_ref.json")))
    m = ckpt.load_manifest(ref["storage"], ref["ckpt_id"])
    got = ckpt.restore(m, ckpt.ChunkStore(ref["storage"]))
    assert np.array_equal(got["w"], np.full(128, 2.0, np.float32))


class _Weighted:
    """Serve callable whose responses must never tear: (version, sum) are
    read under the same lock the swap writes them under."""

    def __init__(self, storage, channel):
        self._lock = threading.Lock()
        self.version = "init"
        self.w = np.ones(512, np.float64)
        self._sub = ckpt.WeightSubscriber(
            channel, self._swap, poll_interval_s=0.2, storage_root=storage)

    def _swap(self, tree, summary):
        with self._lock:  # the admission gate: one pointer flip, atomic
            self.w = tree["w"]
            self.version = summary["ckpt_id"]

    def __call__(self, _request):
        with self._lock:
            return {"version": self.version, "sum": float(self.w.sum())}

    def swaps(self):
        return self._sub.swaps

    def __raytpu_exit__(self):
        self._sub.stop()


def test_serve_replica_hot_swap_no_torn_reads(ckpt_cluster, tmp_path):
    """Replicas serve the OLD weights until the swap completes, then the
    new — and every response is internally consistent (its sum matches its
    version's weights: a torn read would pair old sum with new version or
    a half-swapped tree)."""
    from ray_tpu_torch import serve

    storage = str(tmp_path / "weights")
    channel = "swaptest"
    app = serve.deployment(_Weighted, name="Weighted", max_ongoing_requests=4)
    handle = serve.run(app.bind(storage, channel), name="swapapp", http=False)
    expected = {"init": float(np.ones(512).sum())}
    try:
        r = handle.remote({}).result(timeout=60)
        assert (r["version"], r["sum"]) == ("init", expected["init"])
        # Background load while checkpoints publish underneath it.
        stop = threading.Event()
        seen: list = []
        errs: list = []

        def flood():
            while not stop.is_set():
                try:
                    seen.append(handle.remote({}).result(timeout=30))
                except Exception as e:  # pragma: no cover - fails the assert below
                    errs.append(repr(e))

        threads = [threading.Thread(target=flood) for _ in range(3)]
        for t in threads:
            t.start()
        store = ckpt.ChunkStore(storage, chunk_size=4096)
        ms = ckpt.ManifestStore(storage, chunk_store=store)
        last_id = None
        for s in range(1, 4):
            w = np.full(512, float(s * 10), np.float64)
            part = ckpt.write_part(store, {
                "w": {"dtype": "float64", "shape": [512],
                      "shards": [([[0, 512]], w)]}}, step=s)
            m = ckpt.commit_parts(ms, ckpt.new_ckpt_id(s), s, [part], 1)
            ckpt.publish_checkpoint(m, channel)
            expected[m.ckpt_id] = float(w.sum())
            last_id = m.ckpt_id
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if handle.remote({}).result(timeout=30)["version"] == m.ckpt_id:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError(f"replica never swapped to {m.ckpt_id}")
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        assert len(seen) > 0
        for r in seen:  # the no-torn-read invariant
            assert r["sum"] == expected[r["version"]], r
        versions = {r["version"] for r in seen}
        assert "init" in versions or len(seen) < 5  # old weights served pre-swap
        assert handle.remote({}).result(timeout=30)["version"] == last_id
    finally:
        serve.delete("swapapp")


def test_llm_server_weights_channel_swaps_to_published_manifest(ckpt_cluster, tmp_path):
    """An LLMServer subscribed to a channel (device="cpu") swaps to the
    manifest published there, and its greedy tokens equal those of an
    engine built on the restored tree."""
    import torch

    from ray_tpu_torch.llm import LLMEngine, LLMServer
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import init_params

    model = dict(vocab_size=320, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=64, max_seq_len=128, dtype=torch.float32)
    engine = {"max_slots": 4, "max_seq": 128, "prefill_buckets": (32,),
              "decode_block": 4, "kv_layout": "paged", "page_size": 16}
    cfg = TransformerConfig(**model)
    trained = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    srv = LLMServer(model, engine, weights_channel="llm-swap", device="cpu")
    try:
        assert srv.weights_version() is None
        saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=4096)
        try:
            m = saver.save(1, trained)
        finally:
            saver.close()
        ckpt.publish_checkpoint(m, "llm-swap")
        deadline = time.monotonic() + 30
        while srv.weights_version() != m.ckpt_id:
            assert time.monotonic() < deadline, "the server never swapped"
            time.sleep(0.05)
        tree = ckpt.restore_tree(m, ckpt.ChunkStore(str(tmp_path)))
        ref = LLMEngine(cfg, params={k: v for k, v in _torch_tree(tree).items()},
                        engine_config=EngineConfig(**engine), device="cpu")
        prompts = [[1 + i, 5, 9, 2 * i + 3] for i in range(3)]
        for p in prompts:
            got = srv.generate(p, max_tokens=8)["tokens"]
            want = ref.generate(p, max_tokens=8)["tokens"]
            assert list(got) == list(want)
    finally:
        srv.__raytpu_exit__()


def _torch_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_registry_on_dashboard(ckpt_cluster, tmp_path):
    """The dashboard half of the reference's
    ``test_registry_state_api_and_dashboard``: ``/api/checkpoints`` lists
    the committed save of a channel, filtered by status."""
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=2048, channel="dashtest")
    try:
        m1 = saver.save(1, _tree(1))
    finally:
        saver.close()
    port = start_dashboard(0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/checkpoints?channel=dashtest&status=committed",
                timeout=30) as resp:
            body = json.loads(resp.read())
        assert [c["ckpt_id"] for c in body["checkpoints"]] == [m1.ckpt_id]
    finally:
        stop_dashboard()


def test_list_checkpoints_cli(ckpt_cluster, tmp_path, capsys, monkeypatch):
    import argparse

    from ray_tpu_torch import scripts

    saver = ckpt.AsyncSaver(str(tmp_path), chunk_size=2048, channel="clitest")
    try:
        m = saver.save(7, _tree(7))
    finally:
        saver.close()
    # The session is already this process's driver; skip the CLI redial.
    monkeypatch.setattr(scripts, "_connect_driver", lambda addr: rt)
    scripts.cmd_list(argparse.Namespace(
        address=None, kind="checkpoints", state=None, fn="clitest",
        node=None, job=None, limit=50))
    out = capsys.readouterr().out
    assert m.ckpt_id in out and "committed" in out and "dedup" in out

