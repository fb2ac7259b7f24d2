"""RL layer: GAE correctness, learner step, and PPO learning CartPole to
>450 mean return on the actor runtime (reference analogue: rllib per-algorithm
CartPole smoke learning tests, SURVEY §4).

``tests/test_rl.py`` on ``ray_tpu_torch.rl`` case for case: the forwards'
case holds numpy against torch (jax there), and the learner runs on the CPU
(``device="cpu"``)."""
import numpy as np
import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel, shared_ray  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.rl import PPO, PPOConfig
from ray_tpu_torch.rl.learner import compute_gae
from ray_tpu_torch.rl.module import init_params, np_logits_values, torch_logits_values


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


def test_gae_matches_reference_recursion():
    rng = np.random.default_rng(0)
    T, N = 6, 2
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    values = rng.standard_normal((T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    last_values = rng.standard_normal(N).astype(np.float32)
    gamma, lam = 0.9, 0.8
    adv, ret = compute_gae(rewards, values, dones, dones, last_values, gamma, lam)
    # brute force per env
    for n in range(N):
        expected = np.zeros(T)
        for t in range(T):
            acc, discount = 0.0, 1.0
            for k in range(t, T):
                nv = last_values[n] if k + 1 == T else values[k + 1, n]
                delta = rewards[k, n] + gamma * nv * (1 - dones[k, n]) - values[k, n]
                acc += discount * delta
                discount *= gamma * lam * (1 - dones[k, n])
                if dones[k, n]:
                    break
            expected[t] = acc
        np.testing.assert_allclose(adv[:, n], expected, rtol=1e-5, atol=1e-5)


def test_gae_truncation_bootstraps_value():
    """A time-limit truncation must bootstrap gamma*V(next) (terms=0) while a
    true termination must not (terms=1)."""
    rewards = np.array([[1.0], [1.0]], np.float32)
    values = np.array([[0.0], [5.0]], np.float32)  # V at t=1 = V(final_obs)
    dones = np.array([[1.0], [0.0]], np.float32)  # boundary after t=0
    last_values = np.array([9.0], np.float32)
    # termination: no bootstrap at t=0
    adv_term, _ = compute_gae(rewards, values, dones, dones, last_values, 0.9, 0.95)
    assert adv_term[0, 0] == pytest.approx(1.0)  # r - V = 1 - 0
    # truncation: bootstraps gamma * values[t+1] = 0.9 * 5
    zeros = np.zeros_like(dones)
    adv_trunc, _ = compute_gae(rewards, values, dones, zeros, last_values, 0.9, 0.95)
    assert adv_trunc[0, 0] == pytest.approx(1.0 + 0.9 * 5.0)


def test_numpy_and_torch_forwards_agree():
    import torch

    rng = np.random.default_rng(1)
    params = init_params(rng, 4, 2, (32, 32))
    obs = rng.standard_normal((7, 4)).astype(np.float32)
    nl, nv = np_logits_values(params, obs)
    tl, tv = torch_logits_values({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(obs))
    np.testing.assert_allclose(nl, tl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nv, tv.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_ppo_learns_cartpole(shared_ray):
    algo = PPOConfig(
        num_env_runners=2,
        num_envs_per_runner=8,
        rollout_len=128,
        lr=2.5e-4,
        minibatch_size=256,
        seed=3,
        device="cpu",
    ).build()
    best = -np.inf
    try:
        for _ in range(250):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if result["episode_return_mean"] >= 450.0:
                break
        assert best >= 450.0, f"PPO failed to learn CartPole: best mean return {best}"
    finally:
        algo.stop()
