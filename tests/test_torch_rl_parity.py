"""The port's RL against ``ray_tpu.rl`` on the same numpy inputs, on the CPU.

Each learner (PPO, the multi-agent PPO's per-policy learner, IMPALA, DQN,
SAC, BC on discrete and continuous actions, CQL) is built in both packages
from the same seed-0 numpy parameters and takes 3 updates on one seeded
minibatch (``chip_smoke.rl_case``: the sizes of the reference's tests).
SAC and CQL draw their noise from a ``jax.random`` key in ``ray_tpu``; the
port's update is fed those same draws (computed here from the key the JAX
update consumes). Each update's losses agree to 1e-5 relative, and every
parameter, target network and temperature to a per-leaf relative L2 of
5e-5 after the 3 updates. The leaves' bound is fp32's, not the losses':
optax computes Adam's bias correction 1 - 0.999^t in float32 (1.3e-5
relative at t = 1) where torch.optim.Adam uses Python floats, which puts
~6.7e-6 on every zero-initialized leaf, and an element whose gradient
changes sign between updates is ill-conditioned under Adam's
normalization: SAC's critic bias q2b0 differs by 2.0e-5 between this
update in float32 and in float64, in the port alone. GAE and v-trace agree
within 1e-6, the sum tree and the prioritized buffer draw the same indices,
and CueMatchEnv and MultiAgentEnvRunner give the same trajectories.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from ray_tpu.rl import dqn as j_dqn
from ray_tpu.rl import impala as j_impala
from ray_tpu.rl import learner as j_learner
from ray_tpu.rl import module as j_module
from ray_tpu.rl import multi_agent as j_ma
from ray_tpu.rl import offline as j_offline
from ray_tpu.rl import replay_buffer as j_rb
from ray_tpu.rl import sac as j_sac
from ray_tpu_torch.rl import impala as t_impala
from ray_tpu_torch.rl import learner as t_learner
from ray_tpu_torch.rl import multi_agent as t_ma
from ray_tpu_torch.rl import replay_buffer as t_rb

TOL = 1e-5  # each update's losses, relative
LEAF_TOL = 5e-5  # per-leaf relative L2 after the updates (module docstring)


def _ref_cfg(ref_cls, port_cfg):
    """The reference's config dataclass with the port config's values."""
    return ref_cls(**{f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(ref_cls)})


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_draws(name, cfg, key, B):
    """The draws ``ray_tpu``'s SAC / CQL update makes from ``key``."""
    if name == "sac":
        k1, k2 = jax.random.split(key)
        return {"next": np.array(jax.random.normal(k1, (B, 1))), "cur": np.array(jax.random.normal(k2, (B, 1)))}
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n = cfg.n_action_samples
    return {"next": np.array(jax.random.normal(k1, (B, 1))), "cur": np.array(jax.random.normal(k2, (B, 1))),
            "rand": np.array(jax.random.uniform(k3, (B, n, 1), minval=-1.0, maxval=1.0)),
            "pol": np.array(jax.random.normal(k4, (B * n, 1))),
            "nxt": np.array(jax.random.normal(k5, (B * n, 1)))}


class _Ref:
    """``ray_tpu``'s learner for a case: update(i) -> losses, leaves()."""

    def __init__(self, name, case):
        self.name, self.case = name, case
        p, cfg = case["params"], case["config"]
        scale = np.array([2.0], np.float32)
        if name in ("ppo", "multi_agent_ppo"):
            self.l = j_learner.PPOLearner(p, lr=cfg["lr"])
        elif name == "impala":
            self.l = j_impala.IMPALALearner(p, _ref_cfg(j_impala.IMPALAConfig, cfg))
        elif name == "dqn":
            self.l = j_dqn.DQNLearner(p, _ref_cfg(j_dqn.DQNConfig, cfg))
        elif name == "sac":
            self.l = j_sac.SACLearner(p, scale, _ref_cfg(j_sac.SACConfig, cfg))
        else:
            # BC and CQL keep their update inside the algorithm object: build
            # it (a gymnasium probe sizes it) and give it the case's state.
            if name == "cql":
                self.l = _ref_cfg(j_offline.CQLConfig, cfg).build(case["batch"])
            else:
                env = "CartPole-v1" if name == "bc_discrete" else "Pendulum-v1"
                self.l = j_offline.BCConfig(env=env, lr=cfg["lr"]).build(case["batch"])
            self.l.params = jax.tree.map(jnp.asarray, p)
            if name == "cql":
                self.l.target = {k: v.copy() for k, v in self.l.params.items() if k.startswith("q")}
            self.l.opt_state = self.l.optimizer.init(self.l.params)

    def update(self, i):
        name, batch, l = self.name, self.case["batch"], self.l
        if name in ("ppo", "multi_agent_ppo"):
            return {"loss": float(l.update_minibatch(batch)["loss"])}
        if name == "impala":
            return {"loss": float(l.update_batch(batch)["loss"])}
        if name == "dqn":
            return {"loss": l.update_batch(batch)[0]}
        if name.startswith("bc"):
            l.params, l.opt_state, loss = l._update(l.params, l.opt_state, batch)
            return {"loss": float(loss)}
        l._key, sub = jax.random.split(l._key)
        self.case["noise"][i] = _jax_draws(name, self.case["config"], sub, len(batch["obs"]))
        (l.params, l.target, l.log_alpha, l.opt_state, l.alpha_opt_state, aux) = l._update(
            l.params, l.target, l.log_alpha, l.opt_state, l.alpha_opt_state, batch, sub)
        keys = ("q_loss", "pi_loss") if name == "sac" else ("bellman_loss", "cql_loss")
        return {k: float(aux[k]) for k in keys}

    def leaves(self):
        out = _np(self.l.params)
        if self.name == "dqn":
            out.update({f"target/{k}": v for k, v in _np(self.l.target_params).items()})
        if self.name in ("sac", "cql"):
            out.update({f"target/{k}": v for k, v in _np(self.l.target).items()})
            out["log_alpha"] = np.asarray(self.l.log_alpha)
        return out


@pytest.mark.parametrize("name", cs.RL_LEARNERS)
def test_learner_matches_ray_tpu(name):
    case = cs.rl_case(name)
    params = {k: v.copy() for k, v in case["params"].items()}
    ref = _Ref(name, case)
    port = cs.rl_learner(name, case, "cpu")
    for i in range(cs.RL_UPDATES):
        want = ref.update(i)  # SAC / CQL: fills case["noise"][i] with the JAX draws
        got = cs.rl_update(name, port, case, i)
        for k in want:
            assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (name, i, k, got[k], want[k])
    assert all(np.array_equal(params[k], case["params"][k]) for k in params), "a learner wrote into its inputs"
    got, want = cs.rl_leaves(name, port), ref.leaves()
    assert set(got) == set(want)
    err = cs.rl_rel_l2(got, want)
    assert err <= LEAF_TOL, (name, err)


def _rollout_arrays(seed, T=16, N=5):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    return dict(values=rng.standard_normal((T, N)).astype(np.float32),
                last_v=rng.standard_normal(N).astype(np.float32),
                rewards=rng.standard_normal((T, N)).astype(np.float32),
                dones=dones, terms=dones * (rng.random((T, N)) < 0.5).astype(np.float32),
                log_rhos=(0.5 * rng.standard_normal((T, N))).astype(np.float32))


def test_gae_equals_ray_tpu():
    a = _rollout_arrays(0)
    args = (a["rewards"], a["values"], a["dones"], a["terms"], a["last_v"], 0.99, 0.95)
    for got, want in zip(t_learner.compute_gae(*args), j_learner.compute_gae(*args)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 0.5)])
def test_vtrace_equals_ray_tpu(clips):
    a = _rollout_arrays(1)
    args = (a["values"], a["last_v"], a["rewards"], a["dones"], a["terms"], a["log_rhos"], 0.97, *clips)
    for got, want in zip(t_impala.vtrace_targets(*args), j_impala.vtrace_targets(*args)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sum_tree_and_prioritized_buffer_draw_the_same_indices():
    rng = np.random.default_rng(2)
    pri = rng.uniform(0.1, 5.0, 37)
    trees = [m.SumTree(37) for m in (t_rb, j_rb)]
    for tree in trees:
        tree.set(np.arange(37), pri)
    s = rng.uniform(0, pri.sum(), 500)
    np.testing.assert_array_equal(trees[0].sample(s), trees[1].sample(s))
    batch = {"obs": rng.standard_normal((96, 4)).astype(np.float32), "actions": rng.integers(0, 2, 96),
             "rewards": rng.standard_normal(96).astype(np.float32)}
    pri64 = rng.uniform(0, 3, 64)
    bufs = [m.PrioritizedReplayBuffer(64, alpha=0.6, beta=0.4, seed=3) for m in (t_rb, j_rb)]
    for buf in bufs:
        buf.add_batch(batch)  # wraps the ring
        buf.update_priorities(np.arange(64), pri64)
    for _ in range(3):
        got, want = bufs[0].sample(32), bufs[1].sample(32)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_cue_match_env_gives_the_same_trajectories():
    envs = [m.CueMatchEnv(n_agents=3, n_cues=4, ep_len=5) for m in (t_ma, j_ma)]
    rng = np.random.default_rng(4)
    outs = [env.reset(seed=7) for env in envs]
    for _ in range(12):
        assert all(np.array_equal(outs[0][0][a], outs[1][0][a]) for a in envs[1].possible_agents)
        if len(outs[0]) > 2:
            assert outs[0][1:4] == outs[1][1:4]
            if outs[0][2]["__all__"]:
                outs = [env.reset() for env in envs]
                continue
        actions = {a: int(rng.integers(4)) for a in envs[1].possible_agents}
        outs = [env.step(actions) for env in envs]


def test_multi_agent_runner_samples_the_same_rollouts():
    """Both packages' MultiAgentEnvRunner, same weights and seed: the same
    per-policy trajectories (numpy on both sides)."""
    rng = np.random.default_rng(5)
    weights = {"a": j_module.init_params(rng, 4, 4, (16,)), "b": j_module.init_params(rng, 4, 4, (16,))}
    mapping = {"agent_0": "a", "agent_1": "b", "agent_2": "a"}
    runners = [m.MultiAgentEnvRunner(lambda m=m: m.CueMatchEnv(n_agents=3, n_cues=4, ep_len=8), num_envs=4,
                                     rollout_len=8, policy_mapping=mapping, seed=1) for m in (t_ma, j_ma)]
    for r in runners:
        r.set_weights(weights)
    for _ in range(2):  # the second rollout starts on next-step-reset rows
        got, want = (r.sample() for r in runners)
        assert got["episode_returns"] == want["episode_returns"] and got["steps"] == want["steps"]
        for pid, rec in want["policies"].items():
            for k, v in rec.items():
                np.testing.assert_array_equal(got["policies"][pid][k], v, err_msg=f"{pid}/{k}")
