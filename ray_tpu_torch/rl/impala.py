"""IMPALA: decoupled actor-learner with v-trace off-policy correction.

Role-equivalent to the reference's IMPALA (rllib/algorithms/impala/
impala.py:521 — async EnvRunner sampling feeding a central learner, v-trace
per "IMPALA: Scalable Distributed Deep-RL with Importance Weighted
Actor-Learner Architectures", Espeholt et al. 2018). Redesigned for this
runtime: env-runner actors keep collect tasks permanently in flight (the
learner never blocks sampling), weights broadcast ASYNCHRONOUSLY (a notify,
not an rt.get barrier) right before each runner's next rollout, and the
learner is one torch update over the whole [T, N] trajectory on its device —
v-trace targets by a reverse loop over T.

Why v-trace: decoupling makes every consumed rollout 1+ policy versions
stale. Importance ratios rho_t = pi(a|x)/mu(a|x), clipped at rho_bar/c_bar,
re-weight the policy gradient and bend the value targets toward V^pi, so the
off-policy gap costs variance, not bias (up to the clip).

Episode-boundary conventions shared with compute_gae (learner.py): `dones`
cut the trace recursion; `terms` (true termination) zero the bootstrap while
a time-limit truncation bootstraps V(values[t+1]) — which in next-step
autoreset mode IS V(final_obs).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ray_tpu_torch.rl.learner import adam, apply_grads, clip_by_global_norm, grads_of
from ray_tpu_torch.rl.module import batch_tensors, learner_device, to_numpy, to_tensors, torch_logits_values


def vtrace_targets(values, last_v, rewards, dones, terms, log_rhos,
                   gamma: float, rho_bar: float, c_bar: float):
    """V-trace value targets + bootstrapped action targets over [T, N].

    Returns (vs, q): vs_t is the v-trace target for V(x_t); q_t = r_t +
    gamma*(1-term_t)*next-target is the action-value target whose advantage
    (q_t - V_t), weighted by the clipped rho_t, drives the policy gradient.
    Episode conventions match compute_gae: dones cut the trace recursion,
    terms zero the bootstrap (a truncation bootstraps V(x_{t+1}) =
    V(final_obs) in next-step autoreset mode).

    Inputs are tensors (or numpy arrays, taken as CPU tensors); the outputs
    are tensors on their device. The recursion is a reverse loop over T
    (``ray_tpu``'s is a reverse ``lax.scan``), one [N] step at a time.
    """
    import torch

    values, last_v, rewards, dones, terms, log_rhos = (
        torch.as_tensor(x) for x in (values, last_v, rewards, dones, terms, log_rhos))
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=rho_bar)
    cs = torch.clamp(rhos, max=c_bar)
    values_next = torch.cat([values[1:], last_v[None]], dim=0)
    not_term = 1.0 - terms
    not_done = 1.0 - dones
    deltas = clipped_rhos * (rewards + gamma * not_term * values_next - values)

    acc = torch.zeros_like(last_v)
    vs_minus_v = torch.empty_like(deltas)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * cs[t] * acc  # acc = vs_t - V_t
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    # Across a boundary the next-episode vs must not leak into q — bootstrap
    # V(values_next) there instead.
    vs_next = torch.cat([vs[1:], last_v[None]], dim=0)
    boot_next = torch.where(dones > 0, values_next, vs_next)
    q = rewards + gamma * not_term * boot_next
    return vs, q


@dataclasses.dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_len: int = 64
    # Rollouts consumed per train() call (each is one learner update).
    batches_per_iter: int = 8
    gamma: float = 0.99
    lr: float = 1e-3
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    rho_bar: float = 1.0  # v-trace importance-ratio clip (delta term)
    c_bar: float = 1.0    # v-trace trace-cutting clip
    hidden: tuple = (64, 64)
    max_grad_norm: float = 0.5
    seed: int = 0
    device: Optional[str] = None  # the learner's; None = the GPU

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALALearner:
    """One v-trace update over a [T, N] trajectory batch, in torch on the
    learner's device (``device=None`` means the GPU)."""

    def __init__(self, params: dict, cfg: IMPALAConfig, device=None):
        self.device = learner_device(device, "IMPALALearner")
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        # optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5)).
        self.optimizer = adam(self._leaves, cfg.lr, eps=1e-5)
        self.cfg = cfg

    def _loss(self, batch: dict):
        import torch

        cfg = self.cfg
        rho_bar = cfg.rho_bar
        T, N = batch["rewards"].shape
        obs = batch["obs"].reshape(T * N, -1)
        logits, values = torch_logits_values(self.params, obs)
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        _, last_v = torch_logits_values(self.params, batch["last_obs"])

        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1, batch["actions"][..., None])[..., 0]
        # Behavior policy mu produced the actions; ratios correct the lag.
        log_rhos = logp - batch["behavior_logp"]
        rhos = torch.exp(log_rhos)
        with torch.no_grad():
            vs, q = vtrace_targets(
                values, last_v, batch["rewards"], batch["dones"], batch["terms"],
                log_rhos, cfg.gamma, rho_bar, cfg.c_bar,
            )
            pg_adv = torch.clamp(rhos, max=rho_bar) * (q - values)

        valid = batch["valids"]
        n_valid = torch.clamp(valid.sum(), min=1.0)
        pg_loss = -(valid * logp * pg_adv).sum() / n_valid
        vf_loss = 0.5 * (valid * (values - vs) ** 2).sum() / n_valid
        entropy = (valid * -(torch.exp(logp_all) * logp_all).sum(-1)).sum() / n_valid
        total = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * entropy
        aux = {
            "pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy,
            "mean_rho": (valid * rhos).sum() / n_valid,
        }
        return total, aux

    def update_batch(self, batch: dict) -> dict:
        loss, aux = self._loss(batch_tensors(batch, self.device))
        grads = grads_of(loss, self._leaves)
        apply_grads(self.optimizer, self._leaves, clip_by_global_norm(grads, self.cfg.max_grad_norm))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return aux

    def get_weights(self) -> dict:
        # Deliberately HOST arrays: env runners are pure numpy and never
        # load torch or touch the card, and the learner updates its tensors
        # in place, so a shipped live alias would change under the runner.
        return to_numpy(self.params)


class IMPALA:
    """Tune-trainable-shaped driver: train() consumes asynchronously arriving
    rollouts, each corrected by v-trace."""

    def __init__(self, config: IMPALAConfig):
        import gymnasium as gym

        import ray_tpu_torch as rt
        from ray_tpu_torch.rl.env_runner import EnvRunner
        from ray_tpu_torch.rl.module import init_params

        self.cfg = config
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        n_actions = int(probe.action_space.n)
        probe.close()
        rng = np.random.default_rng(config.seed)
        self.learner = IMPALALearner(
            init_params(rng, obs_dim, n_actions, config.hidden), config,
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
        # Prime the pipeline: weights out, one collect task in flight per
        # runner — and it STAYS in flight across train() calls (the IMPALA
        # decoupling; PPO's train() barriers on all runners instead).
        w = self.learner.get_weights()
        rt.get([r.set_weights.remote(w) for r in self.runners], timeout=120)
        self._inflight = {i: r.sample.remote() for i, r in enumerate(self.runners)}
        self._ref_to_runner = {ref: i for i, ref in self._inflight.items()}
        self.iteration = 0
        self._recent_returns: list[float] = []
        self._env_steps_total = 0

    def train(self) -> dict:
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        cfg = self.cfg
        aux = {}
        steps = 0
        episodes = 0
        for _ in range(cfg.batches_per_iter):
            done_refs, _ = rt.wait(list(self._inflight.values()), num_returns=1, timeout=300)
            if not done_refs:
                raise TimeoutError(
                    "no env-runner rollout completed within 300s — a runner "
                    f"is hung or dead (in flight: {len(self._inflight)})"
                )
            ref = done_refs[0]
            idx = self._ref_to_runner.pop(ref)
            rollout = rt.get(ref)
            # Relaunch IMMEDIATELY: async weight broadcast (no barrier) then
            # the next collect — the runner is sampling again while the
            # learner updates on this rollout.
            self.runners[idx].set_weights.remote(self.learner.get_weights())
            new_ref = self.runners[idx].sample.remote()
            self._inflight[idx] = new_ref
            self._ref_to_runner[new_ref] = idx

            batch = {
                "obs": rollout["obs"],
                "actions": rollout["actions"],
                "behavior_logp": rollout["logp"],
                "rewards": rollout["rewards"],
                "dones": rollout["dones"],
                "terms": rollout["terms"],
                "valids": rollout["valids"],
                "last_obs": rollout["last_obs"],
            }
            aux = self.learner.update_batch(batch)
            steps += int(rollout["valids"].sum())
            episodes += len(rollout["episode_returns"])
            self._recent_returns.extend(rollout["episode_returns"])
        self._recent_returns = self._recent_returns[-100:]
        self._env_steps_total += steps
        self.iteration += 1
        dt = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(self._recent_returns)) if self._recent_returns else 0.0,
            "episodes_this_iter": episodes,
            "env_steps_this_iter": steps,
            "env_steps_total": self._env_steps_total,
            "env_steps_per_sec": steps / max(dt, 1e-9),
            "pg_loss": float(aux.get("pg_loss", np.nan)),
            "vf_loss": float(aux.get("vf_loss", np.nan)),
            "entropy": float(aux.get("entropy", np.nan)),
            "mean_rho": float(aux.get("mean_rho", np.nan)),
            "time_this_iter_s": dt,
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
