"""Multi-agent RL: env ABC, env-runner actor, and multi-policy PPO.

Role-equivalent to the reference's multi-agent stack
(rllib/env/multi_agent_env.py — per-agent dict step API with an "__all__"
done flag — and rllib/env/multi_agent_env_runner.py + the
policy_mapping_fn contract from AlgorithmConfig.multi_agent), re-shaped
for this runtime:

- MultiAgentEnv: reset/step speak per-agent dicts; episodes end via the
  "__all__" key. All agents act every step (simultaneous-move games; the
  common cooperative/competitive case — turn-based agent subsets are a
  follow-up).
- MultiAgentEnvRunner actor: E independent env copies stepped in lockstep;
  per step, agents are grouped BY POLICY (policy_mapping_fn) so each
  policy's numpy forward runs once over [E * n_agents_of_policy] rows, not
  per-agent. Trajectories come back per policy in the exact [T, N, ...]
  layout the single-agent pipeline uses, so GAE and the PPO learner are
  reused untouched.
- MultiAgentPPO: one torch PPOLearner per policy, on the learner's device
  (``device=None`` means the GPU); train() = broadcast all
  policies -> parallel multi-agent rollouts -> per-policy GAE + minibatch
  epochs. Independent PPO — the standard strong baseline the reference's
  multi-agent PPO also implements (each policy optimizes its own stream).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


class MultiAgentEnv:
    """Simultaneous-move multi-agent env contract.

    Subclasses define: possible_agents (list of agent id strings),
    obs_dims / n_actions (dicts per agent id), reset(seed) ->
    (obs_dict, info_dict), step(action_dict) -> (obs_dict, reward_dict,
    terminated_dict, truncated_dict, info_dict) where terminated/truncated
    carry the "__all__" episode flag (reference: multi_agent_env.py)."""

    possible_agents: list = []
    obs_dims: dict = {}
    n_actions: dict = {}

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def close(self):
        pass


class CueMatchEnv(MultiAgentEnv):
    """Cooperative cue-matching: each agent observes a private one-hot cue
    and earns +1 (shared team reward fraction) for answering its own cue,
    with a small penalty otherwise. Independent observations force each
    policy to actually read ITS agent's cue — the canonical smoke task for
    multi-agent plumbing (the reference uses two-step/RPS games the same
    way)."""

    def __init__(self, n_agents: int = 2, n_cues: int = 4, ep_len: int = 16):
        self.possible_agents = [f"agent_{i}" for i in range(n_agents)]
        self.obs_dims = {a: n_cues for a in self.possible_agents}
        self.n_actions = {a: n_cues for a in self.possible_agents}
        self.n_cues = n_cues
        self.ep_len = ep_len
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._cues: dict = {}

    def _draw(self):
        self._cues = {a: int(self._rng.integers(self.n_cues))
                      for a in self.possible_agents}
        return {
            a: np.eye(self.n_cues, dtype=np.float32)[c]
            for a, c in self._cues.items()
        }

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._draw(), {}

    def step(self, action_dict: dict):
        rewards = {
            a: (1.0 if int(action_dict[a]) == self._cues[a] else -0.1)
            for a in self.possible_agents
        }
        self._t += 1
        done = self._t >= self.ep_len
        obs = self._draw()
        flags = {a: done for a in self.possible_agents}
        flags["__all__"] = done
        trunc = {a: False for a in self.possible_agents}
        trunc["__all__"] = False
        return obs, rewards, flags, trunc, {}


class MultiAgentEnvRunner:
    """Rollout actor over E copies of a MultiAgentEnv, returning per-POLICY
    trajectory tensors (reference: multi_agent_env_runner.py). numpy-only —
    no torch in rollout workers (module.py contract)."""

    def __init__(self, env_ctor: Callable[[], MultiAgentEnv], num_envs: int,
                 rollout_len: int, policy_mapping: dict, seed: int = 0):
        from ray_tpu_torch.rl.module import np_sample  # noqa: F401 (validated import)

        self.envs = [env_ctor() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        # agent_id -> policy_id, precomputed (the mapping fn itself may not
        # pickle cheaply; the driver resolves it once).
        self.policy_mapping = dict(policy_mapping)
        self.agents = list(self.envs[0].possible_agents)
        self.by_policy: dict[str, list] = {}
        for a in self.agents:
            self.by_policy.setdefault(self.policy_mapping[a], []).append(a)
        self.rng = np.random.default_rng(seed)
        self.params: dict = {}  # policy_id -> param dict
        self._obs = [env.reset(seed=seed * 997 + i)[0]
                     for i, env in enumerate(self.envs)]
        self._ep_return = np.zeros(num_envs, np.float64)
        # Next-step reset (the single-agent env_runner's contract, which
        # compute_gae's bootstrapping REQUIRES — learner.py:66): the step
        # AFTER an episode ends is a junk row (valids=0) whose "transition"
        # is the reset; resetting same-step would make values[t+1] belong
        # to the next episode and bias truncated-episode advantages.
        self._prev_done = np.zeros(num_envs, bool)

    def set_weights(self, params_by_policy: dict) -> bool:
        # Host-pinned leaves (device arrays may arrive via OOB transport).
        self.params = {
            pid: {k: np.asarray(v) for k, v in p.items()}
            for pid, p in params_by_policy.items()
        }
        return True

    def sample(self) -> dict:
        """rollout_len lockstep steps over all env copies. Returns
        {policy_id: {obs, actions, logp, values, rewards, dones, terms,
        valids, last_values}} in [T, N] layout (N = num_envs *
        agents_of_policy), plus episode_returns (team sums)."""
        from ray_tpu_torch.rl.module import np_logits_values, np_sample

        T, E = self.rollout_len, self.num_envs
        out: dict[str, dict] = {}
        for pid, agents in self.by_policy.items():
            n = E * len(agents)
            d = self.envs[0].obs_dims[agents[0]]
            out[pid] = {
                "obs": np.zeros((T, n, d), np.float32),
                "actions": np.zeros((T, n), np.int64),
                "logp": np.zeros((T, n), np.float32),
                "values": np.zeros((T, n), np.float32),
                "rewards": np.zeros((T, n), np.float32),
                "dones": np.zeros((T, n), np.float32),
                "terms": np.zeros((T, n), np.float32),
                "valids": np.ones((T, n), np.float32),
            }
        episode_returns: list[float] = []

        def stack(agents):
            # [E * len(agents), obs_dim]: env-major then agent-major.
            return np.stack(
                [self._obs[e][a] for a in agents for e in range(E)]
            ).astype(np.float32)

        for t in range(T):
            actions_flat: dict[str, np.ndarray] = {}
            for pid, agents in self.by_policy.items():
                obs = stack(agents)
                acts, logp, vals = np_sample(self.params[pid], obs, self.rng)
                rec = out[pid]
                rec["obs"][t], rec["actions"][t] = obs, acts
                rec["logp"][t], rec["values"][t] = logp, vals
                actions_flat[pid] = acts
            step_out = []
            for e in range(E):
                if self._prev_done[e]:
                    # Junk row: the env finished last step; this step IS the
                    # reset (reward 0, no done) and trains nothing.
                    obs_d, _ = self.envs[e].reset()
                    zero = {a: 0.0 for a in self.agents}
                    flags = {a: False for a in self.agents}
                    flags["__all__"] = False
                    step_out.append((obs_d, zero, dict(flags), dict(flags), {}))
                    continue
                adict = {}
                for pid, agents in self.by_policy.items():
                    for j, a in enumerate(agents):
                        adict[a] = int(actions_flat[pid][j * E + e])
                step_out.append(self.envs[e].step(adict))
            for pid, agents in self.by_policy.items():
                rec = out[pid]
                for j, a in enumerate(agents):
                    for e in range(E):
                        col = j * E + e
                        obs_d, rew_d, term_d, trunc_d, _ = step_out[e]
                        rec["rewards"][t, col] = rew_d[a]
                        done = bool(term_d["__all__"] or trunc_d["__all__"])
                        rec["dones"][t, col] = float(done)
                        rec["terms"][t, col] = float(term_d["__all__"])
                        rec["valids"][t, col] = 0.0 if self._prev_done[e] else 1.0
            for e in range(E):
                obs_d, rew_d, term_d, trunc_d, _ = step_out[e]
                if not self._prev_done[e]:
                    self._ep_return[e] += sum(rew_d.values())
                done = bool(term_d["__all__"] or trunc_d["__all__"])
                if done:
                    episode_returns.append(float(self._ep_return[e]))
                    self._ep_return[e] = 0.0
                self._prev_done[e] = done
                self._obs[e] = obs_d
        for pid, agents in self.by_policy.items():
            rec = out[pid]
            _, last_values = np_logits_values(self.params[pid], stack(agents))
            rec["last_values"] = last_values.astype(np.float32)
        return {"policies": out, "episode_returns": episode_returns,
                "steps": T * E * len(self.agents)}

    def close(self) -> bool:
        for env in self.envs:
            env.close()
        return True


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env_ctor: Optional[Callable] = None  # () -> MultiAgentEnv
    # agent_id -> policy_id; None = one shared policy for every agent
    # (parameter sharing, the common cooperative setup).
    policy_mapping_fn: Optional[Callable] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_len: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    lr: float = 3e-4
    epochs: int = 4
    minibatch_size: int = 512
    hidden: tuple = (64, 64)
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    seed: int = 0
    device: Optional[str] = None  # the learners'; None = the GPU

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Independent PPO over per-agent policies (reference: the multi-agent
    Algorithm path — one Learner per policy, EnvRunnerGroup of multi-agent
    runners, policy_mapping_fn routing)."""

    def __init__(self, config: MultiAgentPPOConfig):
        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.learner import PPOLearner
        from ray_tpu_torch.rl.module import init_params

        if config.env_ctor is None:
            raise ValueError("MultiAgentPPOConfig.env_ctor is required")
        self.cfg = config
        probe = config.env_ctor()
        agents = list(probe.possible_agents)
        mapping_fn = config.policy_mapping_fn or (lambda a: "shared")
        self.policy_mapping = {a: mapping_fn(a) for a in agents}
        probe.close()
        # Agents sharing a policy must share spaces — mismatches would
        # otherwise corrupt silently (a head sized for agent A emitting
        # out-of-range actions for agent B).
        spaces_by_pid: dict[str, tuple] = {}
        for a in agents:
            pid = self.policy_mapping[a]
            spec = (probe.obs_dims[a], probe.n_actions[a])
            prev = spaces_by_pid.setdefault(pid, spec)
            if prev != spec:
                raise ValueError(
                    f"policy {pid!r} maps agents with mismatched spaces: "
                    f"{prev} vs {spec} (agent {a!r}); give them separate policies"
                )
        rng = np.random.default_rng(config.seed)
        self.learners: dict[str, PPOLearner] = {}
        for pid, (obs_dim, n_actions) in spaces_by_pid.items():
            self.learners[pid] = PPOLearner(
                init_params(rng, obs_dim, n_actions, config.hidden),
                lr=config.lr, clip=config.clip, vf_coef=config.vf_coef,
                ent_coef=config.ent_coef, max_grad_norm=config.max_grad_norm,
                device=config.device,
            )
        runner_cls = rt.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(
                config.env_ctor, config.num_envs_per_runner, config.rollout_len,
                self.policy_mapping, seed=config.seed * 10_000 + i,
            )
            for i in range(config.num_env_runners)
        ]
        self._rng = rng
        self.iteration = 0
        self._recent_returns: list[float] = []

    def get_weights(self) -> dict:
        return {pid: l.get_weights() for pid, l in self.learners.items()}

    def train(self) -> dict:
        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.learner import compute_gae

        t0 = time.perf_counter()
        cfg = self.cfg
        weights = self.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.runners], timeout=120)
        rollouts = rt.get([r.sample.remote() for r in self.runners], timeout=300)

        aux_by_policy: dict[str, dict] = {}
        steps = 0
        for pid in self.learners:
            cat = lambda key: np.concatenate(  # noqa: E731
                [r["policies"][pid][key] for r in rollouts], axis=1
            )
            obs, actions = cat("obs"), cat("actions")
            logp_old, values = cat("logp"), cat("values")
            rewards, dones, terms = cat("rewards"), cat("dones"), cat("terms")
            valids = cat("valids")
            last_values = np.concatenate(
                [r["policies"][pid]["last_values"] for r in rollouts]
            )
            adv, returns = compute_gae(
                rewards, values, dones, terms, last_values, cfg.gamma, cfg.gae_lambda
            )
            # Drop the next-step-reset junk rows before SGD (same contract
            # as the single-agent path, ppo.py).
            mask = valids.reshape(-1) > 0
            B = int(mask.sum())
            steps += B
            flat = {
                "obs": obs.reshape(-1, obs.shape[-1])[mask],
                "actions": actions.reshape(-1)[mask],
                "logp_old": logp_old.reshape(-1)[mask],
                "advantages": adv.reshape(-1)[mask],
                "returns": returns.reshape(-1)[mask],
            }
            flat["advantages"] = (
                flat["advantages"] - flat["advantages"].mean()
            ) / (flat["advantages"].std() + 1e-8)
            # Fixed minibatch shape + ceil/pad so no sample is dropped when
            # B is not a multiple of mb (same scheme as ppo.py).
            mb = min(cfg.minibatch_size, B)
            n_mb = max(1, -(-B // mb))
            aux = {}
            for _ in range(cfg.epochs):
                perm = self._rng.permutation(B)
                pad = n_mb * mb - B
                if pad > 0:
                    perm = np.concatenate([perm, self._rng.integers(0, B, pad)])
                for k in range(n_mb):
                    idx = perm[k * mb:(k + 1) * mb]
                    aux = self.learners[pid].update_minibatch(
                        {key: v[idx] for key, v in flat.items()}
                    )
            aux_by_policy[pid] = {k: float(v) for k, v in aux.items()}

        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"])
        self._recent_returns = self._recent_returns[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
            ),
            "env_steps_this_iter": steps,
            "policies": aux_by_policy,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        import ray_tpu_torch as rt

        for r in self.runners:
            try:
                rt.get(r.close.remote(), timeout=10)
            except Exception:
                pass
            try:
                rt.kill(r)
            except Exception:
                pass
