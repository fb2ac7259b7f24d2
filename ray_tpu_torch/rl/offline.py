"""Offline RL: behavior cloning (BC) + conservative Q-learning (CQL).

Role-equivalent to the reference's offline algorithms
(rllib/algorithms/bc/ — supervised policy learning from logged data — and
rllib/algorithms/cql/ — SAC plus a conservative logsumexp Q-regularizer,
Kumar et al. 2020), re-shaped for this runtime:

- Datasets are the replay-buffer transition format (dict of arrays: obs,
  actions, rewards, next_obs, terms) saved as one .npz, and batches stream
  through ray_tpu_torch.data — column blocks in the object store, shuffled and
  re-batched by the streaming executor per epoch, the same machinery that
  feeds Train (reference: BC/CQL read via ray.data input pipelines).
- Learners are torch updates on the learner's device (``device=None`` means
  the GPU): ``BCLearner`` and ``CQLLearner``, which BC and CQL drive and
  which build from parameters alone; training never touches an env. The
  env appears only in evaluate() rollouts.
- BC handles both action spaces: discrete -> cross-entropy on logits
  (module.py policy tower), continuous -> MSE to a tanh-squashed
  deterministic head (the standard BC formulation).
- CQL is continuous-control (on the SAC param layout, sac.py): twin-critic
  soft Bellman backup on dataset transitions plus the CQL(H) penalty
  alpha * (logsumexp_a Q(s, a) - Q(s, a_data)), with the logsumexp estimated
  over uniform + policy + next-policy action samples with importance
  corrections — pessimism about out-of-distribution actions is what lets it
  improve over the behavior policy where BC can only imitate it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.rl.learner import adam, apply_grads, clip_by_global_norm, grads_of, polyak_
from ray_tpu_torch.rl.module import batch_tensors, learner_device, n_hidden, to_numpy, to_tensors
from ray_tpu_torch.rl.q_runner import TransitionCollector
from ray_tpu_torch.rl.sac import sac_init_params, torch_policy, torch_q_val, torch_sample

# ---------------------------------------------------------------------------
# datasets: save/load + streaming batches through ray_tpu_torch.data
# ---------------------------------------------------------------------------

TRANSITION_KEYS = ("obs", "actions", "rewards", "next_obs", "terms")


def save_transitions(path: str, transitions: dict) -> None:
    """Persist a transition dict (replay-buffer format) as one .npz."""
    np.savez_compressed(path, **{k: np.asarray(transitions[k]) for k in TRANSITION_KEYS})


def load_transitions(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in TRANSITION_KEYS}


def transitions_dataset(transitions: dict, n_shards: int = 8):
    """Transition dict -> ray_tpu_torch.data Dataset of column blocks (rows =
    transitions), shardable/shuffleable by the streaming executor."""
    from ray_tpu_torch.data import from_blocks
    from ray_tpu_torch.data import block as B

    n = len(transitions["obs"])
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    blocks = []
    for i in range(n_shards):
        lo, hi = bounds[i], bounds[i + 1]
        if hi > lo:
            blocks.append(
                B.block_from_batch({k: np.asarray(v[lo:hi]) for k, v in transitions.items()})
            )
    return from_blocks(blocks)


def iter_offline_batches(transitions: dict, batch_size: int, epochs: int,
                         seed: int = 0, keys: tuple = TRANSITION_KEYS):
    """Yield full-size shuffled batches for `epochs` passes over the data,
    streamed through the data pipeline (shuffle + re-batch per epoch).
    Ragged tails are dropped so every batch has one shape."""
    ds = transitions_dataset(transitions)
    # Arrow tensor columns surface as float64/list — restore source dtypes.
    dtypes = {k: np.asarray(transitions[k]).dtype for k in keys}
    for ep in range(epochs):
        shuffled = ds.random_shuffle(seed=seed + ep)
        # drop_last: every batch has one shape.
        for batch in shuffled.iter_batches(batch_size=batch_size, drop_last=True):
            yield {
                k: np.asarray(np.asarray(batch[k]).tolist() if batch[k].dtype == object
                              else batch[k]).astype(dtypes[k], copy=False)
                for k in keys if k in batch
            }


class _PolicyCollector(TransitionCollector):
    """Offline dataset collection on the SHARED collect loop (the gymnasium
    autoreset invariant lives in TransitionCollector exactly once): the
    policy is a plain callable and batches accumulate locally instead of
    going to a buffer actor."""

    def __init__(self, env_name: str, num_envs: int, policy_fn: Callable, seed: int):
        self._init_collector(env_name, num_envs, buffer=None, seed=seed,
                             throttle_sleep_s=0.0)
        self._policy = policy_fn
        self.batches: list[dict] = []

    def _select_actions(self, obs):
        return self._policy(obs.astype(np.float32))

    def _push(self, batch: dict) -> bool:
        self.batches.append(batch)
        return False


def collect_transitions(env_name: str, policy_fn: Callable, n_steps: int,
                        seed: int = 0) -> dict:
    """Roll a policy (obs [N, D] -> actions) in a vector env and return the
    transition dict — the offline-dataset generation helper (the reference
    generates offline datasets from rollout workers the same way)."""
    col = _PolicyCollector(env_name, 8, policy_fn, seed)
    n = 0
    while n < n_steps:
        n += col.collect(64)["steps"]
    col.close()
    return {
        k: np.concatenate([b[k] for b in col.batches])[:n_steps]
        for k in TRANSITION_KEYS
    }


def evaluate_policy(env_name: str, act_fn: Callable, episodes: int = 10,
                    seed: int = 0) -> float:
    """Mean episode return of a deterministic policy (obs [N,D] -> actions)."""
    import gymnasium as gym

    envs = gym.make_vec(env_name, num_envs=episodes, vectorization_mode="sync")
    obs, _ = envs.reset(seed=seed)
    done = np.zeros(episodes, bool)
    returns = np.zeros(episodes, np.float64)
    for _ in range(1000):
        actions = act_fn(obs.astype(np.float32))
        obs, rew, term, trunc, _ = envs.step(actions)
        returns += np.where(done, 0.0, rew)
        done |= np.logical_or(term, trunc)
        if done.all():
            break
    envs.close()
    return float(returns.mean())


# ---------------------------------------------------------------------------
# BC
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# BC
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BCConfig:
    env: str = "CartPole-v1"
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    batch_size: int = 256
    epochs_per_iter: int = 5
    seed: int = 0
    device: Optional[str] = None  # the learner's; None = the GPU

    def build(self, transitions: dict) -> "BC":
        return BC(self, transitions)


class BCLearner:
    """BC's update: discrete actions (``act_scale`` None) -> the policy
    tower's logits and the negative log-likelihood of the logged actions;
    continuous -> a tanh-squashed deterministic head and the MSE to them.
    Plain adam(lr), no clipping; torch on the learner's device
    (``device=None`` means the GPU)."""

    def __init__(self, params: dict, lr: float, act_scale=None, device=None):
        import torch

        self.device = learner_device(device, "BCLearner")
        self.discrete = act_scale is None
        self.hidden_n = n_hidden(params)
        self.scale = None if self.discrete else torch.tensor(np.asarray(act_scale, np.float32),
                                                            device=self.device)
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        self.optimizer = adam(self._leaves, lr)

    def _trunk(self, obs):
        import torch

        h = obs
        for i in range(self.hidden_n):
            h = torch.tanh(torch.addmm(self.params[f"pb{i}"], h, self.params[f"pw{i}"]))
        return h

    def logits(self, obs):
        import torch

        return torch.addmm(self.params["bpi"], self._trunk(obs), self.params["wpi"])

    def mu(self, obs):
        import torch

        return torch.tanh(torch.addmm(self.params["bmu"], self._trunk(obs), self.params["wmu"])) * self.scale

    def _loss(self, batch: dict):
        import torch

        if self.discrete:
            logp = torch.log_softmax(self.logits(batch["obs"]), dim=-1)
            nll = -torch.gather(logp, 1, batch["actions"][:, None].long())[:, 0]
            return nll.mean()
        return ((self.mu(batch["obs"]) - batch["actions"]) ** 2).mean()

    def update(self, batch: dict):
        """One adam step on a numpy batch; returns the loss before it."""
        loss = self._loss(batch_tensors(batch, self.device))
        apply_grads(self.optimizer, self._leaves, grads_of(loss, self._leaves))
        return loss.detach()

    def act(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic cloned policy (greedy argmax / mean action)."""
        import torch

        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
            if self.discrete:
                return self.logits(x).argmax(dim=-1).cpu().numpy().astype(np.int64)
            return self.mu(x).cpu().numpy()

    def get_weights(self) -> dict:
        return to_numpy(self.params)


class BC:
    """Behavior cloning: supervised imitation of the dataset's actions
    (reference: rllib/algorithms/bc — the policy loss is pure -logp of
    logged actions; no value function, no environment).

    Tune-trainable-shaped: train() runs epochs_per_iter passes over the
    dataset through the data pipeline; evaluate() rolls the cloned policy.
    """

    def __init__(self, config: BCConfig, transitions: dict):
        import gymnasium as gym

        self.cfg = config
        self.transitions = transitions
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        self.discrete = hasattr(probe.action_space, "n")
        rng = np.random.default_rng(config.seed)
        if self.discrete:
            n_actions = int(probe.action_space.n)
            from ray_tpu_torch.rl.module import init_params

            params = {
                k: v for k, v in init_params(rng, obs_dim, n_actions, config.hidden).items()
                if k.startswith(("pw", "pb", "wpi", "bpi"))  # policy tower only
            }
            act_scale = None
        else:
            act_dim = int(np.prod(probe.action_space.shape))
            self.act_scale = np.asarray(probe.action_space.high, np.float32).reshape(act_dim)
            full = sac_init_params(rng, obs_dim, act_dim, config.hidden)
            params = {
                k: v for k, v in full.items()
                if k.startswith(("pw", "pb", "wmu", "bmu"))  # deterministic head
            }
            act_scale = self.act_scale
        probe.close()
        self.learner = BCLearner(params, config.lr, act_scale, device=config.device)
        self.iteration = 0

    def train(self) -> dict:
        t0 = time.perf_counter()
        losses = []
        keys = ("obs", "actions")
        for batch in iter_offline_batches(
            self.transitions, self.cfg.batch_size, self.cfg.epochs_per_iter,
            seed=self.cfg.seed + 100 * self.iteration, keys=keys,
        ):
            losses.append(float(self.learner.update(batch)))
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "bc_loss": float(np.mean(losses)) if losses else float("nan"),
            "updates_this_iter": len(losses),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def act(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic cloned policy (greedy argmax / mean action)."""
        return self.learner.act(obs)

    def evaluate(self, episodes: int = 10, seed: int = 0) -> float:
        return evaluate_policy(self.cfg.env, self.act, episodes, seed)


# ---------------------------------------------------------------------------
# CQL
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CQLConfig:
    env: str = "Pendulum-v1"
    hidden: tuple = (128, 128)
    lr: float = 3e-4
    batch_size: int = 256
    updates_per_iter: int = 1000
    gamma: float = 0.99
    tau: float = 0.005
    init_alpha: float = 0.2  # SAC entropy temperature (learned)
    # CQL penalty weight + number of sampled actions for the logsumexp.
    # 1.0 measured best on the Pendulum medium-expert mixture (5.0 is so
    # conservative the policy never leaves the dataset's average behavior).
    cql_alpha: float = 1.0
    n_action_samples: int = 8
    max_grad_norm: float = 10.0
    seed: int = 0
    device: Optional[str] = None  # the learner's; None = the GPU

    def build(self, transitions: dict) -> "CQL":
        return CQL(self, transitions)


class CQLLearner:
    """One CQL update on the SAC layout: twin-critic Bellman backup on
    DATASET transitions + CQL(H) penalty pushing down logsumexp_a Q(s, a)
    while pushing up Q(s, a_data), plus the reparameterized policy and
    temperature updates and the polyak step; torch on the learner's device
    (``device=None`` means the GPU).

    Its noise comes from a ``torch.Generator`` on that device seeded
    ``cfg.seed + 11`` (``update_batch``); ``_update`` takes the draws as an
    argument, so the same draws can drive another implementation."""

    def __init__(self, params: dict, act_scale, cfg: CQLConfig, device=None):
        import torch

        self.device = learner_device(device, "CQLLearner")
        self.cfg = cfg
        self.hidden_n = len(cfg.hidden)
        self.act_dim = int(np.asarray(params["bmu"]).shape[0])
        self.target_entropy = -float(self.act_dim)
        self.scale = torch.tensor(np.asarray(act_scale, np.float32), device=self.device)
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        self.target = {k: v.detach().clone() for k, v in self.params.items() if k.startswith("q")}
        self.log_alpha = torch.log(torch.tensor(cfg.init_alpha, dtype=torch.float32,
                                                device=self.device)).requires_grad_(True)
        # optax.chain(clip_by_global_norm(max_grad_norm), adam(lr)); the
        # temperature has its own adam(lr).
        self.optimizer = adam(self._leaves, cfg.lr)
        self.alpha_opt = adam([self.log_alpha], cfg.lr)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 11)

    def draw_noise(self, batch_size: int) -> dict:
        """The update's draws: standard normals "next" (the backup's action
        at next_obs), "cur" (the policy's action at obs), "pol" and "nxt"
        (n_action_samples policy actions per row at obs and next_obs: each
        row repeated n_action_samples times in a row), and "rand" [B, n, A],
        uniform in [-1, 1)."""
        import torch

        B, N, A = batch_size, self.cfg.n_action_samples, self.act_dim
        g, dev = self._gen, self.device
        return {
            "next": torch.randn((B, A), generator=g, device=dev),
            "cur": torch.randn((B, A), generator=g, device=dev),
            "rand": torch.rand((B, N, A), generator=g, device=dev) * 2.0 - 1.0,
            "pol": torch.randn((B * N, A), generator=g, device=dev),
            "nxt": torch.randn((B * N, A), generator=g, device=dev),
        }

    def _update(self, batch: dict, noise: dict) -> dict:
        import torch

        cfg, n, scale = self.cfg, self.hidden_n, self.scale
        n_samp = cfg.n_action_samples
        p = self.params
        B = batch["obs"].shape[0]
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            # Soft Bellman backup through target critics (dataset actions).
            a2, logp2 = torch_sample(p, batch["next_obs"], noise["next"], scale, n)
            tq = torch.minimum(
                torch_q_val(self.target, "q1", batch["next_obs"], a2, scale, n),
                torch_q_val(self.target, "q2", batch["next_obs"], a2, scale, n),
            )
            backup = batch["rewards"] + cfg.gamma * (1 - batch["terms"]) * (tq - alpha * logp2)

            # CQL(H) candidate actions: uniform + current-policy at s and s',
            # with importance corrections (Kumar et al. 2020, appendix F).
            rand_a = noise["rand"] * scale
            log_unif = -math.log(2.0) * scale.shape[0]  # density of U(-1,1)^A

            def tiled_sample(obs, eps):
                obs_t = torch.repeat_interleave(obs[:, None], n_samp, dim=1).reshape(B * n_samp, -1)
                a, logp = torch_sample(p, obs_t, eps, scale, n)
                return a.reshape(B, n_samp, -1), logp.reshape(B, n_samp)

            pol_a, pol_logp = tiled_sample(batch["obs"], noise["pol"])
            nxt_a, nxt_logp = tiled_sample(batch["next_obs"], noise["nxt"])

        def q_tiled(q, obs, acts):
            """obs [B, D], acts [B, N, A] -> [B, N]."""
            Bq, N, A = acts.shape
            obs_t = torch.repeat_interleave(obs[:, None], N, dim=1).reshape(Bq * N, -1)
            return torch_q_val(p, q, obs_t, acts.reshape(Bq * N, A), scale, n).reshape(Bq, N)

        def cql_term(q, q_data):
            cat = torch.cat(
                [
                    q_tiled(q, batch["obs"], rand_a) - log_unif,
                    q_tiled(q, batch["obs"], pol_a) - pol_logp,
                    q_tiled(q, batch["obs"], nxt_a) - nxt_logp,
                ],
                dim=1,
            )
            lse = torch.logsumexp(cat, dim=1)
            return (lse - q_data).mean()

        # Q(s, a_data) once per critic: the Bellman term and the CQL term
        # read the same values (ray_tpu evaluates it in each).
        q1 = torch_q_val(p, "q1", batch["obs"], batch["actions"], scale, n)
        q2 = torch_q_val(p, "q2", batch["obs"], batch["actions"], scale, n)
        bellman = 0.5 * (((q1 - backup) ** 2).mean() + ((q2 - backup) ** 2).mean())
        conservative = cfg.cql_alpha * (cql_term("q1", q1) + cql_term("q2", q2))
        a_new, logp = torch_sample(p, batch["obs"], noise["cur"], scale, n)
        frozen = {k: v.detach() for k, v in p.items() if k.startswith("q")}
        q_pi = torch.minimum(
            torch_q_val(frozen, "q1", batch["obs"], a_new, scale, n),
            torch_q_val(frozen, "q2", batch["obs"], a_new, scale, n),
        )
        pi_loss = (alpha * logp - q_pi).mean()
        grads = grads_of(bellman + conservative + pi_loss, self._leaves)
        apply_grads(self.optimizer, self._leaves, clip_by_global_norm(grads, cfg.max_grad_norm))
        ent_gap = (-logp.detach() - self.target_entropy).mean()
        apply_grads(self.alpha_opt, [self.log_alpha], [alpha * ent_gap])
        polyak_(self.target, p, cfg.tau)
        return {"bellman_loss": bellman.detach(), "cql_loss": conservative.detach(),
                "alpha": torch.exp(self.log_alpha.detach())}

    def update_batch(self, batch: dict) -> dict:
        batch = batch_tensors(batch, self.device)
        return self._update(batch, self.draw_noise(batch["obs"].shape[0]))

    def act(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic mean policy for evaluation."""
        import torch

        with torch.no_grad():
            mu, _ = torch_policy(self.params, torch.as_tensor(np.asarray(obs, np.float32), device=self.device),
                                 self.hidden_n)
        return np.tanh(mu.cpu().numpy()) * np.asarray(self.scale.cpu())

    def get_weights(self) -> dict:
        return to_numpy(self.params)


class CQL:
    """Conservative Q-learning on the SAC layout (reference:
    rllib/algorithms/cql — SACConfig subclass adding the CQL loss terms).

    One CQLLearner update per batch. Entirely offline; evaluate() rolls the
    mean policy."""

    def __init__(self, config: CQLConfig, transitions: dict):
        import gymnasium as gym

        self.cfg = config
        self.transitions = transitions
        probe = gym.make(config.env)
        obs_dim = int(np.prod(probe.observation_space.shape))
        act_dim = int(np.prod(probe.action_space.shape))
        self.act_scale = np.asarray(probe.action_space.high, np.float32).reshape(act_dim)
        probe.close()
        rng = np.random.default_rng(config.seed)
        params = sac_init_params(rng, obs_dim, act_dim, config.hidden)
        self.learner = CQLLearner(params, self.act_scale, config, device=config.device)
        self._batches = iter_offline_batches(
            self.transitions, config.batch_size, epochs=10_000, seed=config.seed
        )
        self.iteration = 0

    def train(self) -> dict:
        t0 = time.perf_counter()
        aux = {}
        for _ in range(self.cfg.updates_per_iter):
            aux = self.learner.update_batch(next(self._batches))
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "bellman_loss": float(aux.get("bellman_loss", np.nan)),
            "cql_loss": float(aux.get("cql_loss", np.nan)),
            "alpha": float(aux.get("alpha", np.nan)),
            "updates_this_iter": self.cfg.updates_per_iter,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def act(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic mean policy for evaluation."""
        return self.learner.act(obs)

    def evaluate(self, episodes: int = 10, seed: int = 0) -> float:
        return evaluate_policy(self.cfg.env, self.act, episodes, seed)
