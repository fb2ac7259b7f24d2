"""DQN: off-policy learner over the replay-buffer actor with async
collection.

Role-equivalent to the reference's DQN on the new API stack
(rllib/algorithms/dqn/ — double-Q target, target network sync, prioritized
replay with importance weights) with the Learner as one torch update on
the learner's device and the sampling/learning overlap expressed with actor
pipelining: collect tasks stay in flight on QEnvRunner actors while the
driver-side learner consumes the buffer; weights re-broadcast between
collects (IMPALA-shaped, rllib/algorithms/impala/ data path).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ray_tpu_torch.rl.learner import adam, apply_grads, clip_by_global_norm, grads_of
from ray_tpu_torch.rl.module import batch_tensors, learner_device, to_numpy, to_tensors, torch_logits_values


@dataclasses.dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    collect_steps: int = 32  # env steps per collect() task
    buffer_capacity: int = 50_000
    prioritized: bool = True
    per_alpha: float = 0.6
    per_beta: float = 0.4
    batch_size: int = 64
    updates_per_iter: int = 48
    learning_starts: int = 1_000  # buffer size before updates begin
    gamma: float = 0.99
    lr: float = 1e-3
    target_update_every: int = 200  # gradient updates between hard syncs
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 8_000
    hidden: tuple = (64, 64)
    max_grad_norm: float = 10.0
    seed: int = 0
    device: Optional[str] = None  # the learner's; None = the GPU

    def build(self) -> "DQN":
        return DQN(self)


class DQNLearner:
    """Double-DQN update with Huber loss + PER importance weights, in torch
    on the learner's device (``device=None`` means the GPU)."""

    def __init__(self, params: dict, cfg: DQNConfig, device=None):
        self.device = learner_device(device, "DQNLearner")
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        self.target_params = {k: v.detach().clone() for k, v in self.params.items()}
        # optax.chain(clip_by_global_norm(max_grad_norm), adam(lr)).
        self.optimizer = adam(self._leaves, cfg.lr)
        self.max_grad_norm = cfg.max_grad_norm
        self.gamma = cfg.gamma
        self._n_updates = 0
        self._target_every = cfg.target_update_every

    def _loss(self, batch: dict):
        import torch

        def q_of(p, obs):
            q, _ = torch_logits_values(p, obs)  # policy tower doubles as Q-net
            return q

        q = q_of(self.params, batch["obs"])
        q_sa = torch.gather(q, 1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            # Double DQN: online net picks the argmax, target net evaluates it.
            next_a = torch.argmax(q_of(self.params, batch["next_obs"]), dim=1)
            next_target = q_of(self.target_params, batch["next_obs"])
            next_q = torch.gather(next_target, 1, next_a[:, None])[:, 0]
            target = batch["rewards"] + self.gamma * (1.0 - batch["terms"]) * next_q
        td = q_sa - target
        huber = torch.where(torch.abs(td) <= 1.0, 0.5 * td**2, torch.abs(td) - 0.5)
        loss = (batch["weights"] * huber).mean()
        return loss, td

    def update_batch(self, batch: dict) -> tuple[float, np.ndarray]:
        loss, td = self._loss(batch_tensors(batch, self.device))
        grads = grads_of(loss, self._leaves)
        apply_grads(self.optimizer, self._leaves, clip_by_global_norm(grads, self.max_grad_norm))
        self._n_updates += 1
        if self._n_updates % self._target_every == 0:
            self.target_params = {k: v.detach().clone() for k, v in self.params.items()}
        return float(loss.detach()), td.detach().cpu().numpy()

    def get_weights(self) -> dict:
        return to_numpy(self.params)


class DQN:
    """Tune-trainable-shaped driver: train() returns a result dict with
    episode_return_mean, like the PPO driver and the reference Algorithm."""

    def __init__(self, config: DQNConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.module import init_params
        from ray_tpu_torch.rl.q_runner import QEnvRunner
        from ray_tpu_torch.rl.replay_buffer import ReplayBufferActor

        self.cfg = config
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        n_actions = int(probe.action_space.n)
        probe.close()
        rng = np.random.default_rng(config.seed)
        params = init_params(rng, obs_dim, n_actions, config.hidden)
        self.learner = DQNLearner(params, config, device=config.device)
        self.buffer = rt.remote(ReplayBufferActor).options(max_concurrency=4).remote(
            config.buffer_capacity, prioritized=config.prioritized,
            alpha=config.per_alpha, beta=config.per_beta, seed=config.seed,
        )
        runner_cls = rt.remote(QEnvRunner)
        self.runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_runner, self.buffer,
                seed=config.seed * 10_000 + i,
            )
            for i in range(config.num_env_runners)
        ]
        self.env_steps = 0
        self.iteration = 0
        self._recent_returns: list[float] = []
        self._inflight: list = []  # (runner_idx, collect ref)
        weights = self.learner.get_weights()
        rt.get(
            [r.set_weights.remote(weights, self._epsilon()) for r in self.runners],
            timeout=120,
        )

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.env_steps / max(1, cfg.eps_decay_steps))
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    # -- one training iteration -------------------------------------------
    def train(self) -> dict:
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        cfg = self.cfg
        # Keep one collect task in flight per runner: env stepping proceeds
        # on the runner actors WHILE the learner updates below (the overlap).
        while len(self._inflight) < len(self.runners):
            busy = {i for i, _ in self._inflight}
            idx = next(i for i in range(len(self.runners)) if i not in busy)
            self._inflight.append((idx, self.runners[idx].collect.remote(cfg.collect_steps)))

        losses = []
        updates_done = 0
        stats = rt.get(self.buffer.stats.remote(), timeout=60)
        if stats["size"] >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                batch = rt.get(self.buffer.sample.remote(cfg.batch_size), timeout=60)
                if batch is None:
                    break
                indices = batch.pop("indices")
                loss, td = self.learner.update_batch(batch)
                losses.append(loss)
                updates_done += 1
                if cfg.prioritized:
                    self.buffer.update_priorities.remote(indices, td)

        # Harvest every finished collect; re-dispatch with fresh weights.
        refs = [ref for _, ref in self._inflight]
        ready, _ = rt.wait(refs, num_returns=len(refs), timeout=None if updates_done == 0 else 0.0)
        ready_ids = {id(r) for r in ready}
        weights = self.learner.get_weights()
        eps = self._epsilon()
        still: list = []
        for idx, ref in self._inflight:
            if id(ref) in ready_ids:
                out = rt.get(ref, timeout=60)
                self.env_steps += out["steps"]
                self._recent_returns.extend(out["episode_returns"])
                self.runners[idx].set_weights.remote(weights, eps)
                still.append((idx, self.runners[idx].collect.remote(cfg.collect_steps)))
            else:
                still.append((idx, ref))
        self._inflight = still
        self._recent_returns = self._recent_returns[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(self._recent_returns)) if self._recent_returns else 0.0,
            "env_steps_total": self.env_steps,
            "gradient_updates": updates_done,
            "epsilon": eps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "buffer_size": stats["size"],
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        import ray_tpu_torch as rt

        for ref in [r for _, r in self._inflight]:
            try:
                rt.get(ref, timeout=10)
            except Exception:
                pass
        self._inflight = []
        for r in self.runners:
            try:
                rt.get(r.close.remote(), timeout=10)
            except Exception:
                pass
            try:
                rt.kill(r)
            except Exception:
                pass
        try:
            rt.kill(self.buffer)
        except Exception:
            pass
