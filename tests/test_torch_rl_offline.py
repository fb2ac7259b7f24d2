"""Offline RL: BC + CQL on saved transition datasets (reference:
rllib/algorithms/bc/, rllib/algorithms/cql/; datasets stream through
ray_tpu_torch.data like the reference's ray.data input pipelines).

Dataset generation uses scripted competent controllers (CartPole pole-PD,
Pendulum energy swing-up) so the tests stay minutes-fast; the pipeline the
data flows through (collect -> npz -> data blocks -> shuffled batches ->
jitted learner) is exactly the user path.

``tests/test_rl_offline.py`` on ``ray_tpu_torch.rl`` case for case; the
learners run on the CPU (``device="cpu"``)."""
import numpy as np
import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.rl.offline import (
    BCConfig,
    CQLConfig,
    collect_transitions,
    evaluate_policy,
    iter_offline_batches,
    load_transitions,
    save_transitions,
)

@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """The learner runs in this process. Two torch threads (CQL's matmuls
    gain from a second): more spin-wait against parallel test workers on a
    loaded host, where 4 threads made a CQL update ~4x slower than 2."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _cartpole_teacher(obs):
    # Pole-angle PD: a competent CartPole policy (~400 return).
    return (0.5 * obs[:, 2] + obs[:, 3] > 0).astype(np.int64)


def _pendulum_expert(obs):
    # Energy swing-up + PD catch: ~-155 mean return (near-optimal ~-150).
    c, s, thdot = obs[:, 0], obs[:, 1], obs[:, 2]
    th = np.arctan2(s, c)
    energy = 0.5 * thdot ** 2 + 10.0 * c
    u = np.where(
        np.abs(th) < 0.35,
        -(16.0 * th + 4.0 * thdot),
        np.sign(thdot) * np.clip(2.0 * (10.0 - energy), -2, 2),
    )
    return np.clip(u, -2, 2).astype(np.float32)[:, None]


def test_offline_dataset_roundtrip_and_batches(tmp_path):
    """collect -> save -> load -> shuffled full-size batches through the
    data pipeline, dtypes and shapes intact."""
    rng = np.random.default_rng(0)

    def policy(obs):
        return rng.integers(0, 2, len(obs)).astype(np.int64)

    data = collect_transitions("CartPole-v1", policy, 1_000, seed=1)
    assert len(data["obs"]) == 1_000 and data["obs"].dtype == np.float32
    path = str(tmp_path / "ds.npz")
    save_transitions(path, data)
    loaded = load_transitions(path)
    np.testing.assert_array_equal(loaded["obs"], data["obs"])
    n = 0
    for b in iter_offline_batches(loaded, 256, epochs=2, seed=0):
        assert b["obs"].shape == (256, 4) and b["obs"].dtype == np.float32
        assert b["actions"].dtype == np.int64
        n += 1
    assert n == 2 * (1_000 // 256)


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_bc_clones_competent_cartpole_policy():
    """BC recovers a competent discrete policy from logged data alone
    (reference: rllib/algorithms/bc): trained on noisy-teacher rollouts,
    the clone's eval return reaches the teacher's."""
    teacher_ret = evaluate_policy("CartPole-v1", _cartpole_teacher, episodes=10, seed=1)
    assert teacher_ret > 250, f"teacher too weak to clone: {teacher_ret}"

    rng = np.random.default_rng(0)

    def noisy_teacher(obs):
        a = _cartpole_teacher(obs)
        flip = rng.random(len(a)) < 0.1
        return np.where(flip, rng.integers(0, 2, len(a)), a).astype(np.int64)

    data = collect_transitions("CartPole-v1", noisy_teacher, 10_000, seed=2)
    bc = BCConfig(env="CartPole-v1", epochs_per_iter=5, seed=0, device="cpu").build(data)
    losses = [bc.train()["bc_loss"] for _ in range(3)]
    assert losses[-1] < losses[0]
    bc_ret = bc.evaluate(episodes=10, seed=3)
    assert bc_ret >= 0.85 * teacher_ret, (
        f"BC return {bc_ret} not near teacher {teacher_ret}"
    )


def test_cql_beats_bc_on_mixed_pendulum():
    """The offline-RL payoff (reference: rllib/algorithms/cql): on a
    trajectory-level mixture (half noisy-expert episodes, half random — the
    D4RL medium-expert shape), BC can only imitate the AVERAGE behavior,
    while CQL's conservative Bellman backup stitches the good actions and
    lands far above it."""
    prng = np.random.default_rng(1)

    def noisy_expert(obs):
        a = _pendulum_expert(obs) + prng.normal(0, 0.15, (len(obs), 1)).astype(np.float32)
        return np.clip(a, -2, 2)

    def random_pol(obs):
        return prng.uniform(-2, 2, (len(obs), 1)).astype(np.float32)

    d1 = collect_transitions("Pendulum-v1", noisy_expert, 10_000, seed=4)
    d2 = collect_transitions("Pendulum-v1", random_pol, 10_000, seed=5)
    data = {k: np.concatenate([d1[k], d2[k]]) for k in d1}

    bc = BCConfig(env="Pendulum-v1", epochs_per_iter=5, seed=0, device="cpu").build(data)
    for _ in range(3):
        bc.train()
    bc_ret = bc.evaluate(episodes=10, seed=6)

    # Measured trajectory (20-episode evals, this exact config): CQL sits
    # near the dataset average for ~5k updates, then takes off and
    # converges to ~-135 — near the scripted expert's -155 — by ~9k, while
    # BC stays at ~-1060. The margin below is ~500 under the converged gap.
    cql = CQLConfig(env="Pendulum-v1", updates_per_iter=1000, seed=0, device="cpu").build(data)
    best = -np.inf
    for _ in range(10):
        cql.train()
        best = max(best, cql.evaluate(episodes=10, seed=6))
        if best > bc_ret + 400:
            break  # already conclusive; keep the test fast
    assert best > bc_ret + 400, (
        f"CQL best {best:.0f} does not beat BC {bc_ret:.0f} on the same data"
    )
