"""EnvRunner: rollout-collecting actor over a gymnasium vector env.

Role-equivalent to the reference's SingleAgentEnvRunner inside an
EnvRunnerGroup (rllib/env/env_runner_group.py): each runner owns a sync
vector env, receives policy weights before sampling, and returns fixed-length
trajectory tensors plus completed-episode returns.
"""
from __future__ import annotations

import numpy as np

from ray_tpu_torch.rl.module import np_logits_values, np_sample


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int, rollout_len: int, seed: int = 0):
        import gymnasium as gym

        self.envs = gym.make_vec(env_name, num_envs=num_envs, vectorization_mode="sync")
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.rng = np.random.default_rng(seed)
        self.params = None
        self.obs, _ = self.envs.reset(seed=seed)
        self._ep_return = np.zeros(num_envs, np.float64)
        self._ep_len = np.zeros(num_envs, np.int64)
        # gymnasium 1.x vector envs auto-reset on the step AFTER an episode
        # ends ("next-step" mode): that step ignores the action and returns
        # the reset observation with reward 0. Those transitions are garbage
        # for training (the obs is the final state, the reward fake, and GAE
        # would bleed the new episode's value into the terminal state) — mark
        # them invalid so the learner filters them out.
        self._prev_done = np.zeros(num_envs, bool)

    def set_weights(self, params: dict):
        # Weights may arrive as device arrays (the learner ships its params
        # through the object store's OOB device transport); the rollout path
        # is pure numpy, so pin each leaf to host once here — gymnasium
        # rejects device-typed actions.
        self.params = {k: np.asarray(v) for k, v in params.items()}
        return True

    def sample(self) -> dict:
        """Collect rollout_len steps from every env. Returns [T, N, ...]
        trajectory arrays + bootstrap values + finished episode returns."""
        T, N = self.rollout_len, self.num_envs
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int64)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)  # episode boundary AFTER step t
        term_buf = np.zeros((T, N), np.float32)  # true termination (no bootstrap)
        valid_buf = np.ones((T, N), np.float32)  # 0 = auto-reset junk step
        episode_returns: list[float] = []
        episode_lengths: list[int] = []
        for t in range(T):
            obs_buf[t] = self.obs
            actions, logp, values = np_sample(self.params, self.obs, self.rng)
            act_buf[t], logp_buf[t], val_buf[t] = actions, logp, values
            valid_buf[t] = (~self._prev_done).astype(np.float32)
            self.obs, rew, term, trunc, _ = self.envs.step(actions)
            done = np.logical_or(term, trunc)
            rew_buf[t] = rew
            done_buf[t] = done.astype(np.float32)
            term_buf[t] = term.astype(np.float32)
            live = ~self._prev_done
            self._ep_return[live] += rew[live]
            self._ep_len[live] += 1
            for i in np.nonzero(done & live)[0]:
                episode_returns.append(float(self._ep_return[i]))
                episode_lengths.append(int(self._ep_len[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done
        _, last_values = np_logits_values(self.params, self.obs)
        return {
            "last_obs": self.obs.copy(),  # bootstrap obs (IMPALA recomputes V under current params)
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "terms": term_buf,
            "valids": valid_buf,
            "last_values": last_values.astype(np.float32),
            "episode_returns": episode_returns,
            "episode_lengths": episode_lengths,
        }

    def close(self):
        self.envs.close()
        return True
