"""PPO algorithm driver: EnvRunner actor group + torch learner.

Role-equivalent to the reference's Algorithm + PPO
(rllib/algorithms/algorithm.py, algorithms/ppo/) on the new API stack:
train() = broadcast weights -> parallel rollouts from the EnvRunner actors ->
GAE -> epochs of minibatched clipped-surrogate updates -> metrics. The
algorithm object is Tune-trainable shaped (train() returns a result dict with
episode_return_mean), so sweeps drive it exactly like the reference drives
Algorithm via Tune.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_len: int = 128  # steps per env per iteration
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
    # The learner's torch device; None = the GPU (raises when none is
    # visible). Env runners stay numpy on CPU actors.
    device: Optional[str] = None

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    def __init__(self, config: PPOConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.env_runner import EnvRunner
        from ray_tpu_torch.rl.learner import PPOLearner
        from ray_tpu_torch.rl.module import init_params

        self.cfg = config
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        n_actions = int(probe.action_space.n)
        probe.close()
        rng = np.random.default_rng(config.seed)
        params = init_params(rng, obs_dim, n_actions, config.hidden)
        self.learner = PPOLearner(
            params, lr=config.lr, clip=config.clip, vf_coef=config.vf_coef,
            ent_coef=config.ent_coef, max_grad_norm=config.max_grad_norm,
            device=config.device,
        )
        runner_cls = rt.remote(EnvRunner)
        self.runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_runner, config.rollout_len,
                seed=config.seed * 10_000 + i,
            )
            for i in range(config.num_env_runners)
        ]
        self._rng = rng
        self.iteration = 0
        self._recent_returns: list[float] = []

    # -- one training iteration ------------------------------------------
    def train(self) -> dict:
        import ray_tpu_torch as rt

        from ray_tpu_torch.rl.learner import compute_gae

        t0 = time.perf_counter()
        cfg = self.cfg
        weights = self.learner.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.runners], timeout=120)
        rollouts = rt.get([r.sample.remote() for r in self.runners], timeout=300)

        # Stitch runner outputs: [T, N_total, ...]
        cat = lambda key: np.concatenate([r[key] for r in rollouts], axis=1)
        obs, actions = cat("obs"), cat("actions")
        logp_old, values = cat("logp"), cat("values")
        rewards, dones, valids = cat("rewards"), cat("dones"), cat("valids")
        terms = cat("terms")
        last_values = np.concatenate([r["last_values"] for r in rollouts])
        adv, returns = compute_gae(rewards, values, dones, terms, last_values, cfg.gamma, cfg.gae_lambda)

        # Drop auto-reset junk steps (see EnvRunner.valids) before SGD.
        mask = valids.reshape(-1) > 0
        B = int(mask.sum())
        flat = {
            "obs": obs.reshape(-1, obs.shape[-1])[mask],
            "actions": actions.reshape(-1)[mask],
            "logp_old": logp_old.reshape(-1)[mask],
            "advantages": adv.reshape(-1)[mask],
            "returns": returns.reshape(-1)[mask],
        }
        flat["advantages"] = (flat["advantages"] - flat["advantages"].mean()) / (flat["advantages"].std() + 1e-8)

        aux = {}
        # Fixed minibatch shape across iterations (B varies with the junk-step
        # mask): pad the permutation with resampled indices up to a multiple
        # of mb, the draws ray_tpu's PPO makes for its one jitted shape.
        nominal = cfg.num_env_runners * cfg.num_envs_per_runner * cfg.rollout_len
        mb = min(cfg.minibatch_size, nominal)
        n_mb = max(1, -(-B // mb))  # ceil
        for _ in range(cfg.epochs):
            perm = self._rng.permutation(B)
            pad = n_mb * mb - B
            if pad > 0:
                perm = np.concatenate([perm, self._rng.integers(0, B, pad)])
            for k in range(n_mb):
                idx = perm[k * mb : (k + 1) * mb]
                aux = self.learner.update_minibatch({key: v[idx] for key, v in flat.items()})

        for r in rollouts:
            self._recent_returns.extend(r["episode_returns"])
        self._recent_returns = self._recent_returns[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            # 0.0 (not NaN) before any episode completes: NaN poisons metric
            # comparisons in Tune schedulers driving this result dict.
            "episode_return_mean": float(np.mean(self._recent_returns)) if self._recent_returns else 0.0,
            "episodes_this_iter": sum(len(r["episode_returns"]) for r in rollouts),
            "env_steps_this_iter": B,
            "pg_loss": float(aux.get("pg_loss", np.nan)),
            "vf_loss": float(aux.get("vf_loss", np.nan)),
            "entropy": float(aux.get("entropy", np.nan)),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        import ray_tpu_torch as rt

        for r in self.runners:
            try:
                rt.get(r.close.remote(), timeout=10)
            except Exception:
                pass
            try:  # kill even when close() hung/raised — never leak the actor
                rt.kill(r)
            except Exception:
                pass
