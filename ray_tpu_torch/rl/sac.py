"""SAC: soft actor-critic for continuous control.

Role-equivalent to the reference's SAC (rllib/algorithms/sac/ — twin
soft-Q critics, tanh-squashed Gaussian policy, learned entropy temperature,
polyak target updates; Haarnoja et al. 2018) on this runtime's off-policy
pipeline: SACEnvRunner actors push transitions straight into the
ReplayBufferActor (async collection, no driver hop — the same shape as
rl/dqn.py), the learner is ONE torch update on its device (both critics,
the actor, the temperature, and the polyak step), and the driver is
Tune-trainable-shaped.

Continuous actions: the buffer is shape-generic (dict-of-ring-arrays), so
[N, act_dim] float32 actions flow through the same machinery as DQN's
integer actions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from ray_tpu_torch.rl.learner import adam, apply_grads, clip_by_global_norm, grads_of, polyak_
from ray_tpu_torch.rl.module import batch_tensors, learner_device, to_numpy, to_tensors
from ray_tpu_torch.rl.q_runner import TransitionCollector

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


@dataclasses.dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    collect_steps: int = 16
    buffer_capacity: int = 100_000
    batch_size: int = 128
    # ~2 gradient updates per env step (collect of 16 steps x 8 envs = 128
    # transitions per drained task): measured on Pendulum, the 0.2-ratio
    # variant crawls while this one reaches -300 mean return in ~15k steps.
    updates_per_iter: int = 256
    learning_starts: int = 1_000
    gamma: float = 0.99
    tau: float = 0.005  # polyak rate for the target critics
    lr: float = 3e-4
    init_alpha: float = 0.2  # entropy temperature (learned; this is the start)
    hidden: tuple = (128, 128)
    max_grad_norm: float = 10.0
    seed: int = 0
    device: Optional[str] = None  # the learner's; None = the GPU

    def build(self) -> "SAC":
        return SAC(self)


# -- continuous policy/critic module (numpy runner-side, torch learner-side) --

def sac_init_params(rng: np.random.Generator, obs_dim: int, act_dim: int,
                    hidden=(128, 128)) -> dict:
    def dense(fan_in, fan_out, scale):
        w = (rng.standard_normal((fan_in, fan_out)) * scale / np.sqrt(fan_in))
        return w.astype(np.float32), np.zeros(fan_out, np.float32)

    p = {}
    d = obs_dim
    for i, h in enumerate(hidden):  # policy trunk
        p[f"pw{i}"], p[f"pb{i}"] = dense(d, h, 1.4)
        d = h
    p["wmu"], p["bmu"] = dense(d, act_dim, 0.01)
    p["wls"], p["bls"] = dense(d, act_dim, 0.01)
    for q in ("q1", "q2"):  # twin critics over (obs ‖ act)
        d = obs_dim + act_dim
        for i, h in enumerate(hidden):
            p[f"{q}w{i}"], p[f"{q}b{i}"] = dense(d, h, 1.4)
            d = h
        p[f"{q}wo"], p[f"{q}bo"] = dense(d, 1, 1.0)
    return p


def _np_policy(params, obs, hidden_n):
    h = obs
    for i in range(hidden_n):
        h = np.tanh(h @ params[f"pw{i}"] + params[f"pb{i}"])
    mu = h @ params["wmu"] + params["bmu"]
    log_std = np.clip(h @ params["wls"] + params["bls"], LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def np_sample_action(params, obs, rng: np.random.Generator, act_scale, hidden_n):
    """Runner-side tanh-squashed Gaussian draw (numpy — no torch in runners)."""
    mu, log_std = _np_policy(params, obs, hidden_n)
    u = mu + np.exp(log_std) * rng.standard_normal(mu.shape).astype(np.float32)
    return np.tanh(u) * act_scale


class SACEnvRunner(TransitionCollector):
    """Continuous-action transition collector pushing into the buffer actor
    (the shared TransitionCollector loop; only action selection differs
    from QEnvRunner)."""

    def __init__(self, env_name: str, num_envs: int, buffer, act_scale,
                 hidden_n: int, seed: int = 0, throttle_sleep_s: float = 0.05):
        self._init_collector(env_name, num_envs, buffer, seed, throttle_sleep_s)
        self.act_scale = np.asarray(act_scale, np.float32)
        self.hidden_n = hidden_n
        self.params = None

    def set_weights(self, params: dict) -> bool:
        self.params = params
        return True

    def _select_actions(self, obs):
        if self.params is None:  # pre-first-broadcast: uniform exploration
            return (self.rng.uniform(-1, 1, (self.num_envs,) + self.act_scale.shape)
                    .astype(np.float32) * self.act_scale)
        return np_sample_action(
            self.params, obs.astype(np.float32), self.rng,
            self.act_scale, self.hidden_n,
        ).astype(np.float32)


def torch_policy(p, obs, hidden_n):
    """Learner-side policy head: (mu, log_std) of the tanh-Gaussian."""
    import torch

    h = obs
    for i in range(hidden_n):
        h = torch.tanh(torch.addmm(p[f"pb{i}"], h, p[f"pw{i}"]))
    mu = torch.addmm(p["bmu"], h, p["wmu"])
    log_std = torch.clamp(torch.addmm(p["bls"], h, p["wls"]), LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def torch_q_val(p, q, obs, act, scale, hidden_n):
    """Critic ``q`` ("q1" / "q2") at (obs, act): [N]."""
    import torch

    h = torch.cat([obs, act / scale], dim=-1)
    for i in range(hidden_n):
        h = torch.tanh(torch.addmm(p[f"{q}b{i}"], h, p[f"{q}w{i}"]))
    return torch.addmm(p[f"{q}bo"], h, p[f"{q}wo"])[:, 0]


def torch_sample(p, obs, eps, scale, hidden_n):
    """Reparameterized tanh-Gaussian draw from the standard-normal noise
    ``eps`` (shape of mu): (scaled action, log prob of the squashed draw)."""
    import torch

    mu, log_std = torch_policy(p, obs, hidden_n)
    std = torch.exp(log_std)
    u = mu + std * eps
    a = torch.tanh(u)
    # log prob of the squashed draw (change of variables).
    logp = (-0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a * scale, logp


class SACLearner:
    """One update: twin soft-Q TD update + reparameterized policy update +
    temperature update + polyak target step, in torch on the learner's
    device (``device=None`` means the GPU).

    Its noise comes from a ``torch.Generator`` on that device seeded
    ``cfg.seed + 7`` (``update_batch``); ``_update`` takes the draws as an
    argument, so the same draws can drive another implementation."""

    def __init__(self, params: dict, act_scale, cfg: SACConfig, device=None):
        import torch

        self.device = learner_device(device, "SACLearner")
        self.hidden_n = len(cfg.hidden)
        self.act_dim = int(np.asarray(params["bmu"]).shape[0])
        self.target_entropy = -float(self.act_dim)
        self.scale = torch.tensor(np.asarray(act_scale, np.float32), device=self.device)
        self.cfg = cfg
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        self.target = {k: v.detach().clone() for k, v in self.params.items() if k.startswith("q")}
        self.log_alpha = torch.log(torch.tensor(cfg.init_alpha, dtype=torch.float32,
                                                device=self.device)).requires_grad_(True)
        # optax.chain(clip_by_global_norm(max_grad_norm), adam(lr)); the
        # temperature has its own adam(lr).
        self.optimizer = adam(self._leaves, cfg.lr)
        self.alpha_opt = adam([self.log_alpha], cfg.lr)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 7)

    def draw_noise(self, batch_size: int) -> dict:
        """The update's standard-normal draws: "next" for the backup's
        action at next_obs, "cur" for the policy's action at obs."""
        import torch

        shape = (batch_size, self.act_dim)
        return {k: torch.randn(shape, generator=self._gen, device=self.device) for k in ("next", "cur")}

    def _update(self, batch: dict, noise: dict) -> dict:
        import torch

        cfg, n, scale = self.cfg, self.hidden_n, self.scale
        p = self.params
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            # Critic target: soft Bellman backup through the TARGET critics.
            a2, logp2 = torch_sample(p, batch["next_obs"], noise["next"], scale, n)
            tq = torch.minimum(
                torch_q_val(self.target, "q1", batch["next_obs"], a2, scale, n),
                torch_q_val(self.target, "q2", batch["next_obs"], a2, scale, n),
            )
            backup = batch["rewards"] + cfg.gamma * (1 - batch["terms"]) * (tq - alpha * logp2)

        q1 = torch_q_val(p, "q1", batch["obs"], batch["actions"], scale, n)
        q2 = torch_q_val(p, "q2", batch["obs"], batch["actions"], scale, n)
        q_loss = 0.5 * (((q1 - backup) ** 2).mean() + ((q2 - backup) ** 2).mean())
        a_new, logp = torch_sample(p, batch["obs"], noise["cur"], scale, n)
        frozen = {k: v.detach() for k, v in p.items() if k.startswith("q")}
        q_pi = torch.minimum(
            torch_q_val(frozen, "q1", batch["obs"], a_new, scale, n),
            torch_q_val(frozen, "q2", batch["obs"], a_new, scale, n),
        )
        pi_loss = (alpha * logp - q_pi).mean()
        grads = grads_of(q_loss + pi_loss, self._leaves)
        apply_grads(self.optimizer, self._leaves, clip_by_global_norm(grads, cfg.max_grad_norm))
        # Temperature: drive policy entropy toward -act_dim. The alpha
        # objective J = -alpha * E[logp + target_entropy] has
        # dJ/dlog_alpha = exp(log_alpha) * E[-logp - target_entropy];
        # descend it directly (entropy above target -> alpha shrinks).
        ent_gap = (-logp.detach() - self.target_entropy).mean()
        apply_grads(self.alpha_opt, [self.log_alpha], [alpha * ent_gap])
        polyak_(self.target, p, cfg.tau)
        return {"q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(),
                "alpha": torch.exp(self.log_alpha.detach()), "entropy": -logp.detach().mean()}

    def update_batch(self, batch: dict) -> dict:
        batch = batch_tensors(batch, self.device)
        return self._update(batch, self.draw_noise(batch["obs"].shape[0]))

    def get_weights(self) -> dict:
        return to_numpy(self.params)

    def get_policy_weights(self) -> dict:
        """Runner broadcast: policy keys only (the critics are ~2/3 of the
        bytes and runners never read them)."""
        return to_numpy({k: v for k, v in self.params.items() if not k.startswith("q")})


class SAC:
    """Tune-trainable-shaped driver (same overlap shape as DQN: collect
    tasks stay in flight on the runner actors while the learner drains the
    buffer)."""

    def __init__(self, config: SACConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.replay_buffer import ReplayBufferActor

        self.cfg = config
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        act_dim = int(np.prod(probe.action_space.shape))
        act_scale = np.asarray(probe.action_space.high, np.float32).reshape(act_dim)
        low = np.asarray(probe.action_space.low, np.float32).reshape(act_dim)
        if not np.allclose(low, -act_scale):
            raise ValueError(
                f"SAC's tanh policy assumes a symmetric action space; "
                f"{config.env} has low={low} high={act_scale} — wrap the env "
                "with an affine action rescale first"
            )
        probe.close()
        rng = np.random.default_rng(config.seed)
        self.learner = SACLearner(
            sac_init_params(rng, obs_dim, act_dim, config.hidden), act_scale, config,
            device=config.device,
        )
        self.buffer = rt.remote(ReplayBufferActor).options(max_concurrency=4).remote(
            config.buffer_capacity, prioritized=False, seed=config.seed,
            warmup=config.learning_starts,
        )
        runner_cls = rt.remote(SACEnvRunner)
        self.runners = [
            runner_cls.remote(
                config.env, config.num_envs_per_runner, self.buffer, act_scale,
                len(config.hidden), seed=config.seed * 5_000 + i,
            )
            for i in range(config.num_env_runners)
        ]
        w = self.learner.get_policy_weights()
        rt.get([r.set_weights.remote(w) for r in self.runners], timeout=120)
        self._inflight = {
            i: r.collect.remote(config.collect_steps) for i, r in enumerate(self.runners)
        }
        self._ref_to_runner = {ref: i for i, ref in self._inflight.items()}
        self.iteration = 0
        self._recent_returns: list[float] = []
        self._env_steps = 0

    def train(self) -> dict:
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        cfg = self.cfg
        aux = {}
        # Drain every finished collect; relaunch with fresh weights (async).
        while True:
            done, _ = rt.wait(list(self._inflight.values()), num_returns=1, timeout=120)
            if not done:
                raise TimeoutError("no SAC collect task completed within 120s")
            ref = done[0]
            idx = self._ref_to_runner.pop(ref)
            stats = rt.get(ref)
            self._env_steps += stats["steps"]
            self._recent_returns.extend(stats["episode_returns"])
            self.runners[idx].set_weights.remote(self.learner.get_policy_weights())
            new_ref = self.runners[idx].collect.remote(cfg.collect_steps)
            self._inflight[idx] = new_ref
            self._ref_to_runner[new_ref] = idx
            if self._env_steps >= cfg.learning_starts:
                break
        n_updates = 0
        for _ in range(cfg.updates_per_iter):
            batch = rt.get(self.buffer.sample.remote(cfg.batch_size), timeout=60)
            if batch is None:
                break
            batch = {k: np.asarray(v) for k, v in batch.items()
                     if k in ("obs", "actions", "rewards", "next_obs", "terms")}
            aux = self.learner.update_batch(batch)
            n_updates += 1
        self._recent_returns = self._recent_returns[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
            ),
            "env_steps_total": self._env_steps,
            "updates_this_iter": n_updates,
            "alpha": float(aux.get("alpha", np.nan)),
            "q_loss": float(aux.get("q_loss", np.nan)),
            "entropy": float(aux.get("entropy", np.nan)),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        import ray_tpu_torch as rt

        for ref in list(self._inflight.values()):
            try:
                rt.get(ref, timeout=10)
            except Exception:
                pass
        self._inflight = {}
        for r in self.runners:
            try:
                rt.get(r.close.remote(), timeout=10)
            except Exception:
                pass
        for a in list(self.runners) + [self.buffer]:
            try:
                rt.kill(a)
            except Exception:
                pass
