"""Multi-agent RL: env contract, per-policy runner batching, and
independent PPO learning a cooperative game with shared and per-agent
policies (reference: rllib/env/multi_agent_env.py + multi_agent_env_runner.py
+ the policy_mapping_fn contract).

``tests/test_rl_multiagent.py`` on ``ray_tpu_torch.rl`` case for case; the
learners run on the CPU (``device="cpu"``)."""
import numpy as np
import pytest
from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.rl.multi_agent import (
    CueMatchEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)

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



@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_env_contract():
    env = CueMatchEnv(n_agents=3, n_cues=4, ep_len=5)
    obs, _ = env.reset(seed=0)
    assert set(obs) == set(env.possible_agents)
    assert all(o.shape == (4,) and o.sum() == 1.0 for o in obs.values())
    for t in range(5):
        obs, rew, term, trunc, _ = env.step({a: 0 for a in env.possible_agents})
        assert set(rew) == set(env.possible_agents)
        assert term["__all__"] == (t == 4)


def test_runner_groups_by_policy():
    """The runner batches agents BY policy: one forward per policy over
    [E * agents_of_policy] rows, trajectories in [T, N] layout."""
    from ray_tpu_torch.rl.module import init_params

    rng = np.random.default_rng(0)
    mapping = {"agent_0": "a", "agent_1": "b", "agent_2": "a"}
    runner = MultiAgentEnvRunner(
        lambda: CueMatchEnv(n_agents=3, n_cues=4, ep_len=8),
        num_envs=4, rollout_len=8, policy_mapping=mapping, seed=1,
    )
    runner.set_weights({
        "a": init_params(rng, 4, 4, (16,)),
        "b": init_params(rng, 4, 4, (16,)),
    })
    out = runner.sample()
    pa, pb = out["policies"]["a"], out["policies"]["b"]
    assert pa["obs"].shape == (8, 8, 4)  # 4 envs x 2 agents on policy a
    assert pb["obs"].shape == (8, 4, 4)  # 4 envs x 1 agent on policy b
    assert pa["last_values"].shape == (8,)
    assert out["steps"] == 8 * 4 * 3
    assert out["episode_returns"], "episodes should complete at ep_len=8"
    # Episodes ended on the last row -> the NEXT rollout starts with a
    # next-step-reset junk row (valids=0), the contract compute_gae's
    # bootstrapping requires (truncated episodes must not bootstrap into
    # the next episode's value).
    out2 = runner.sample()
    assert (out2["policies"]["a"]["valids"][0] == 0.0).all()
    assert (out2["policies"]["a"]["rewards"][0] == 0.0).all()
    assert (out2["policies"]["a"]["valids"][1] == 1.0).all()
    runner.close()


def test_mismatched_policy_group_rejected():
    class Lopsided(CueMatchEnv):
        def __init__(self):
            super().__init__(n_agents=2, n_cues=4)
            self.n_actions = {"agent_0": 4, "agent_1": 2}

    with pytest.raises(ValueError, match="mismatched spaces"):
        MultiAgentPPOConfig(
            env_ctor=Lopsided, policy_mapping_fn=lambda a: "shared", device="cpu",
        ).build()


def test_shared_policy_learns_cue_match():
    """Parameter sharing: one policy for all agents solves the cue game
    (near-max team reward: 2 agents x 16 steps x ~1.0)."""
    algo = MultiAgentPPOConfig(
        env_ctor=lambda: CueMatchEnv(n_agents=2, n_cues=4, ep_len=16),
        num_env_runners=2, num_envs_per_runner=8, rollout_len=64,
        lr=3e-3, seed=0, device="cpu",
    ).build()
    try:
        result = {}
        for _ in range(12):
            result = algo.train()
            if result["episode_return_mean"] > 26:  # max 32, random ~1.4
                break
        assert result["episode_return_mean"] > 26, result
        assert set(result["policies"]) == {"shared"}
    finally:
        algo.stop()


@pytest.mark.slow  # heavy battery, kept out of the tier-1 budget as the reference test is
def test_per_agent_policies_learn_independently():
    """policy_mapping_fn routes each agent to its own policy; both learn,
    and the two learners really hold different weights (independent
    updates from their own streams)."""
    algo = MultiAgentPPOConfig(
        env_ctor=lambda: CueMatchEnv(n_agents=2, n_cues=3, ep_len=16),
        policy_mapping_fn=lambda a: f"pi_{a}",
        num_env_runners=2, num_envs_per_runner=8, rollout_len=64,
        lr=3e-3, seed=1, device="cpu",
    ).build()
    try:
        result = {}
        for _ in range(12):
            result = algo.train()
            if result["episode_return_mean"] > 26:
                break
        assert result["episode_return_mean"] > 26, result
        assert set(result["policies"]) == {"pi_agent_0", "pi_agent_1"}
        w0 = algo.learners["pi_agent_0"].get_weights()
        w1 = algo.learners["pi_agent_1"].get_weights()
        assert any(
            not np.array_equal(w0[k], w1[k]) for k in w0
        ), "per-agent policies should diverge"
    finally:
        algo.stop()
