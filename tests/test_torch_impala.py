"""IMPALA: v-trace correctness vs a brute-force recursion + async
actor-learner learning CartPole (reference analogue:
rllib/algorithms/impala/impala.py:521 + per-algorithm CartPole smoke).

``tests/test_impala.py`` on ``ray_tpu_torch.rl`` case for case; the learner
runs on the CPU (``device="cpu"``)."""
import time

import numpy as np
import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.rl import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.impala import vtrace_targets

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



def _vtrace_numpy(values, last_v, rewards, dones, terms, log_rhos,
                  gamma, rho_bar, c_bar):
    """Straight transcription of the v-trace recursion (Espeholt et al. 2018
    eq. 1) with this runtime's done/term conventions."""
    T, N = rewards.shape
    rhos = np.minimum(rho_bar, np.exp(log_rhos))
    cs = np.minimum(c_bar, np.exp(log_rhos))
    v_next = np.concatenate([values[1:], last_v[None]], axis=0)
    deltas = rhos * (rewards + gamma * (1 - terms) * v_next - values)
    vs = np.zeros_like(values)
    acc = np.zeros(N, np.float32)
    for t in range(T - 1, -1, -1):
        acc = deltas[t] + gamma * (1 - dones[t]) * cs[t] * acc
        vs[t] = values[t] + acc
    vs_next = np.concatenate([vs[1:], last_v[None]], axis=0)
    boot = np.where(dones > 0, v_next, vs_next)
    q = rewards + gamma * (1 - terms) * boot
    return vs, q


def test_vtrace_matches_bruteforce():
    rng = np.random.default_rng(3)
    T, N = 9, 4
    values = rng.standard_normal((T, N)).astype(np.float32)
    last_v = rng.standard_normal(N).astype(np.float32)
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.25).astype(np.float32)
    terms = dones * (rng.random((T, N)) < 0.5)
    log_rhos = (0.5 * rng.standard_normal((T, N))).astype(np.float32)
    vs, q = vtrace_targets(values, last_v, rewards, dones, terms, log_rhos,
                           0.97, 1.0, 1.0)
    evs, eq = _vtrace_numpy(values, last_v, rewards, dones, terms, log_rhos,
                            0.97, 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(vs), evs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(q), eq, rtol=1e-5, atol=1e-5)


def test_vtrace_on_policy_reduces_to_lambda1_gae_targets():
    """With rho == c == 1 (on-policy, no clipping active), vs - V must equal
    the lambda=1 GAE advantage — v-trace generalizes n-step returns."""
    from ray_tpu_torch.rl.learner import compute_gae

    rng = np.random.default_rng(5)
    T, N = 8, 3
    values = rng.standard_normal((T, N)).astype(np.float32)
    last_v = rng.standard_normal(N).astype(np.float32)
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.3).astype(np.float32)
    log_rhos = np.zeros((T, N), np.float32)
    vs, _ = vtrace_targets(values, last_v, rewards, dones, dones, log_rhos,
                           0.95, 1.0, 1.0)
    adv, _ = compute_gae(rewards, values, dones, dones, last_v, 0.95, 1.0)
    np.testing.assert_allclose(np.asarray(vs) - values, adv, rtol=1e-5, atol=1e-5)


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_impala_learns_cartpole():
    """Async decoupled sampling + v-trace solves CartPole (>=450 mean
    return). Measured on this host, IMPALA reaches 450 in ~105s / ~230k env
    steps where PPO at the same env budget is still below 450 at ~490k steps
    — the wall-clock claim the async pipeline exists for. The test bar stays
    'solves within the step budget' to keep CI robust; env_steps_per_sec is
    asserted present (throughput is a first-class IMPALA metric)."""
    rt.init(num_cpus=8)
    algo = IMPALAConfig(num_env_runners=2, num_envs_per_runner=8,
                        rollout_len=64, batches_per_iter=8, seed=1,
                        device="cpu").build()
    try:
        best = 0.0
        for _ in range(150):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            assert result["env_steps_per_sec"] > 0
            if result["episode_return_mean"] >= 450.0:
                break
        assert best >= 450.0, f"IMPALA failed to learn CartPole: best {best}"
    finally:
        algo.stop()
        rt.shutdown()
