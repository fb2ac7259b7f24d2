"""QEnvRunner: epsilon-greedy transition collector pushing straight into the
replay-buffer actor (async collection — no driver hop on the data path).

Role-equivalent to the reference's EnvRunner feeding off-policy algorithms
(rllib/env/single_agent_env_runner.py + the DQN data path): collect() runs a
fixed number of env steps, ships (obs, action, reward, next_obs, terminated)
to the buffer actor, honors its backpressure hint, and returns episode stats
to the driver. Weights arrive between collect() calls (set_weights), so
collection overlaps learning — the IMPALA-shaped pipeline.
"""
from __future__ import annotations

import time

import numpy as np

from ray_tpu_torch.rl.module import np_logits_values


class TransitionCollector:
    """Shared off-policy collect loop: gymnasium next-step-autoreset junk
    filtering, episode bookkeeping, buffer push + throttle. Subclasses
    implement _select_actions(obs) -> actions (DQN: epsilon-greedy ints;
    SAC: tanh-Gaussian floats) and set up envs/buffer/rng in __init__.
    The autoreset invariant lives HERE exactly once."""

    def _init_collector(self, env_name: str, num_envs: int, buffer, seed: int,
                        throttle_sleep_s: float):
        import gymnasium as gym

        self.envs = gym.make_vec(env_name, num_envs=num_envs, vectorization_mode="sync")
        self.num_envs = num_envs
        self.buffer = buffer
        self.rng = np.random.default_rng(seed)
        self.throttle_sleep_s = throttle_sleep_s
        self.obs, _ = self.envs.reset(seed=seed)
        self._ep_return = np.zeros(num_envs, np.float64)
        self._ep_len = np.zeros(num_envs, np.int64)
        self._prev_done = np.zeros(num_envs, bool)  # next-step autoreset junk

    def _select_actions(self, obs) -> "np.ndarray":
        raise NotImplementedError

    def collect(self, n_steps: int) -> dict:
        """Run n_steps vector-env steps; push valid transitions to the buffer
        actor; returns episode stats + whether the buffer throttled us."""
        episode_returns: list[float] = []
        throttled = False
        obs_l, act_l, rew_l, nxt_l, term_l = [], [], [], [], []
        for _ in range(n_steps):
            actions = self._select_actions(self.obs)
            prev_obs = self.obs
            self.obs, rew, term, trunc, _ = self.envs.step(actions)
            done = np.logical_or(term, trunc)
            live = ~self._prev_done  # autoreset junk steps are not real data
            if live.any():
                obs_l.append(prev_obs[live])
                act_l.append(actions[live])
                rew_l.append(rew[live].astype(np.float32))
                nxt_l.append(self.obs[live])
                term_l.append(term[live].astype(np.float32))
            self._ep_return[live] += rew[live]
            self._ep_len[live] += 1
            for i in np.nonzero(done & live)[0]:
                episode_returns.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done
        n_pushed = 0
        if obs_l:
            batch = {
                "obs": np.concatenate(obs_l).astype(np.float32),
                "actions": np.concatenate(act_l),
                "rewards": np.concatenate(rew_l),
                "next_obs": np.concatenate(nxt_l).astype(np.float32),
                "terms": np.concatenate(term_l),
            }
            n_pushed = len(batch["actions"])
            throttled = self._push(batch)
        return {
            "episode_returns": episode_returns,
            "steps": n_pushed,
            "throttled": throttled,
        }

    def _push(self, batch: dict) -> bool:
        """Deliver one transition batch; returns whether collection was
        throttled. Default: the replay-buffer actor (online pipeline);
        offline dataset collection overrides to accumulate locally."""
        import ray_tpu_torch as rt

        reply = rt.get(self.buffer.add_batch.remote(batch), timeout=60)
        if reply["throttle"]:
            time.sleep(self.throttle_sleep_s)
            return True
        return False

    def close(self) -> bool:
        self.envs.close()
        return True


class QEnvRunner(TransitionCollector):
    def __init__(self, env_name: str, num_envs: int, buffer, seed: int = 0,
                 throttle_sleep_s: float = 0.05):
        self._init_collector(env_name, num_envs, buffer, seed, throttle_sleep_s)
        self.params = None
        self.epsilon = 1.0

    def set_weights(self, params: dict, epsilon: float) -> bool:
        self.params = params
        self.epsilon = float(epsilon)
        return True

    def _select_actions(self, obs):
        q, _ = np_logits_values(self.params, obs)
        greedy = np.argmax(q, axis=1)
        random_a = self.rng.integers(0, q.shape[1], self.num_envs)
        explore = self.rng.random(self.num_envs) < self.epsilon
        return np.where(explore, random_a, greedy).astype(np.int64)
