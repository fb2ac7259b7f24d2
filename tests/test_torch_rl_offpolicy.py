"""Off-policy RL: replay buffers (uniform + prioritized sum-tree), the
buffer actor's backpressure, DQN learning CartPole through the buffer, and
the sampling/learning overlap (reference analogues:
rllib/utils/replay_buffers tests + per-algorithm CartPole smoke learning).

``tests/test_rl_offpolicy.py`` on ``ray_tpu_torch.rl`` case for case; the
learners run on the CPU (``device="cpu"``)."""
import time

import numpy as np
import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.rl import DQN, DQNConfig, PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rl.replay_buffer import SumTree


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """The learner runs in this process, on one torch thread: its updates
    are small (dispatch-bound), and more threads spin-wait against
    parallel test workers on a loaded host."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data structures (no cluster needed)
# ---------------------------------------------------------------------------

def test_sum_tree_matches_naive_sampling():
    rng = np.random.default_rng(0)
    n = 37
    tree = SumTree(n)
    pri = rng.uniform(0.1, 5.0, n)
    tree.set(np.arange(n), pri)
    assert tree.total == pytest.approx(pri.sum())
    # Prefix-sum inversion: sampled leaf must be the one whose cumulative
    # range contains s.
    cum = np.cumsum(pri)
    for s in rng.uniform(0, pri.sum(), 200):
        leaf = tree.sample(np.array([s]))[0]
        expected = int(np.searchsorted(cum, s))
        assert leaf == min(expected, n - 1)
    # Updates propagate.
    tree.set(np.array([3]), np.array([100.0]))
    assert tree.total == pytest.approx(pri.sum() - pri[3] + 100.0)


def _mk_batch(n, rng, obs_dim=4):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "terms": (rng.random(n) < 0.1).astype(np.float32),
    }


def test_concurrent_first_push_cannot_split_allocation():
    """Regression (round-4 SAC flake): two collectors' FIRST add_batch calls
    racing on an empty buffer must not split the lazy store allocation —
    thread B used to see a partially-built store (truthy after 'obs'), skip
    allocation, and die with KeyError: 'actions'. Mutation is now atomic."""
    import threading

    errors = []
    for trial in range(50):
        buf = ReplayBuffer(capacity=256, seed=trial)
        barrier = threading.Barrier(3)

        def push():
            try:
                barrier.wait()
                for _ in range(4):
                    buf.add_batch(_mk_batch(16, np.random.default_rng(trial)))
            except Exception as e:  # noqa: BLE001 — collecting for assert
                errors.append(e)

        def drain():
            try:
                barrier.wait()
                for _ in range(8):
                    s = buf.sample(8)
                    if s is not None:
                        assert set(s) >= {"obs", "actions", "rewards",
                                          "next_obs", "terms"}
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=push), threading.Thread(target=push),
              threading.Thread(target=drain)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errors, errors
    s = buf.sample(32)
    assert s is not None and s["actions"].shape == (32,)


def test_uniform_buffer_ring_semantics():
    rng = np.random.default_rng(1)
    buf = ReplayBuffer(capacity=100, seed=1)
    assert buf.sample(4) is None
    buf.add_batch(_mk_batch(60, rng))
    assert len(buf) == 60
    buf.add_batch(_mk_batch(60, rng))
    assert len(buf) == 100  # wrapped
    s = buf.sample(32)
    assert s["obs"].shape == (32, 4)
    assert np.all(s["weights"] == 1.0)


def test_prioritized_buffer_prefers_high_priority():
    rng = np.random.default_rng(2)
    buf = PrioritizedReplayBuffer(capacity=128, alpha=1.0, beta=1.0, seed=2)
    buf.add_batch(_mk_batch(128, rng))
    # Demote everything except index 7.
    pri = np.full(128, 1e-3)
    pri[7] = 10.0
    buf.update_priorities(np.arange(128), pri)
    counts = np.zeros(128)
    for _ in range(50):
        s = buf.sample(32)
        for i in s["indices"]:
            counts[i] += 1
    assert counts[7] > 0.8 * counts.sum(), "high-priority transition not dominant"
    # Importance weights: the dominant sample gets the SMALLEST weight.
    s = buf.sample(64)
    w7 = s["weights"][s["indices"] == 7]
    assert len(w7) and np.all(w7 <= s["weights"].max())
    assert s["weights"].max() == pytest.approx(1.0)


def test_prioritized_priority_update_shifts_distribution():
    rng = np.random.default_rng(3)
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, beta=0.4, seed=3)
    buf.add_batch(_mk_batch(64, rng))
    pri = np.full(64, 1e-3)
    pri[5] = 50.0
    buf.update_priorities(np.arange(64), pri)
    assert 5 in buf.sample(16)["indices"]
    # Demote 5, promote 9: sampling follows.
    pri[5] = 1e-3
    pri[9] = 50.0
    buf.update_priorities(np.arange(64), pri)
    idx = np.concatenate([buf.sample(16)["indices"] for _ in range(10)])
    assert (idx == 9).sum() > (idx == 5).sum()


# ---------------------------------------------------------------------------
# actor pipeline
# ---------------------------------------------------------------------------

def test_buffer_actor_backpressure(shared_ray):
    from ray_tpu_torch.rl.replay_buffer import ReplayBufferActor

    buf = rt.remote(ReplayBufferActor).remote(
        10_000, prioritized=False, max_ahead_ratio=2.0, warmup=100,
    )
    rng = np.random.default_rng(0)
    # Push without any sampling: throttle must flip on after warmup.
    throttled = False
    for _ in range(10):
        reply = rt.get(buf.add_batch.remote(_mk_batch(64, rng)), timeout=60)
        throttled = throttled or reply["throttle"]
    assert throttled, "collector never throttled despite zero consumption"
    # Consume: throttle releases.
    for _ in range(12):
        rt.get(buf.sample.remote(64), timeout=60)
    reply = rt.get(buf.add_batch.remote(_mk_batch(64, rng)), timeout=60)
    assert not reply["throttle"]
    rt.kill(buf)


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_dqn_learns_cartpole_with_overlap(shared_ray):
    algo = DQNConfig(
        num_env_runners=2,
        num_envs_per_runner=8,
        collect_steps=32,
        batch_size=64,
        updates_per_iter=64,
        learning_starts=500,
        eps_decay_steps=4_000,
        target_update_every=100,
        prioritized=True,
        seed=7,
        device="cpu",
    ).build()
    best = -np.inf
    try:
        for _ in range(300):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if result["episode_return_mean"] >= 200.0:
                break
        assert best >= 200.0, f"DQN failed to learn CartPole via the buffer: best {best}"
        # Overlap evidence: buffer adds (collection) kept happening between
        # the first and last learner-side sample — i.e. sampling and learning
        # ran concurrently, not in alternating phases of a single thread.
        stats = rt.get(algo.buffer.stats.remote(), timeout=60)
        assert stats["sampled"] > 0 and stats["added"] > 1000
        adds = stats["add_times"]
        spread = adds[-1] - adds[0]
        gaps = np.diff(adds)
        # Collection ran continuously: no gap remotely close to the whole
        # training window (a serial design would show one giant learn-phase gap).
        assert len(adds) > 20
        assert gaps.max() < 0.5 * spread
    finally:
        algo.stop()


def test_sac_learns_pendulum(shared_ray):
    """SAC (continuous control: twin soft-Q, tanh-Gaussian policy, learned
    temperature) drives Pendulum from ~-1200 (random) to > -350 mean return
    through the same async buffer pipeline as DQN (reference analogue:
    rllib/algorithms/sac CartPole/Pendulum smokes)."""
    from ray_tpu_torch.rl import SACConfig

    algo = SACConfig(seed=0, device="cpu").build()
    try:
        best = -1e9
        for i in range(200):
            r = algo.train()
            m = r["episode_return_mean"]
            if m != 0.0:  # 0.0 = no episodes finished yet
                best = max(best, m)
            if best > -350.0:
                break
        assert best > -350.0, f"SAC failed to learn Pendulum: best mean {best}"
    finally:
        algo.stop()
