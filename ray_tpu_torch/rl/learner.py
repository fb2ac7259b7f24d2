"""PPO Learner: clipped-surrogate updates in torch on the learner's device.

Role-equivalent to the reference's Learner/LearnerGroup
(rllib/core/learner/learner.py:112, learner_group.py:101): one update is a
function of (params, optimizer state, minibatch), here in eager torch on one
device (``device=None`` means the GPU). The parameters are leaf tensors
updated in place; ``get_weights`` hands out host numpy copies.

The optimizer is ``optax.chain(clip_by_global_norm, adam(eps=1e-5))``'s
update: ``clip_by_global_norm`` (optax's rule, not
``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6`` at
every norm) then ``torch.optim.Adam`` (``adam``), whose bias-corrected step
is optax's.
"""
from __future__ import annotations

import numpy as np

from ray_tpu_torch.rl.module import batch_tensors, learner_device, to_numpy, to_tensors, torch_logits_values


def adam(params: list, lr: float, eps: float = 1e-8):
    """optax.adam(lr, eps=eps) as ``torch.optim.Adam`` (beta 0.9 / 0.999, eps
    added to sqrt of the bias-corrected second moment), its fused form: one
    kernel a leaf, no per-element Python dispatch (the learners' leaves are
    many and small)."""
    import torch

    return torch.optim.Adam(params, lr=lr, eps=eps, fused=True)


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: the gradients as they are when their
    global L2 norm is below ``max_norm``, else each scaled by
    ``max_norm / norm``."""
    import torch

    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, scale)


def polyak_(targets: dict, source: dict, tau: float) -> None:
    """targets <- (1 - tau) * targets + tau * source, in place, leaf by
    leaf of ``targets``."""
    import torch

    with torch.no_grad():
        ts = list(targets.values())
        torch._foreach_mul_(ts, 1 - tau)
        torch._foreach_add_(ts, [source[k] for k in targets], alpha=tau)


def grads_of(loss, params: list) -> list:
    """d loss / d params, zeros for a parameter the loss does not use (as
    jax.grad gives: DQN reads only the policy tower)."""
    import torch

    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def apply_grads(optimizer, params: list, grads) -> None:
    """One optimizer step with ``grads`` as the parameters' gradients."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()


class PPOLearner:
    def __init__(self, params: dict, lr: float = 3e-4, clip: float = 0.2,
                 vf_coef: float = 0.5, ent_coef: float = 0.01, max_grad_norm: float = 0.5,
                 device=None):
        self.device = learner_device(device, "PPOLearner")
        self.params = to_tensors(params, self.device, requires_grad=True)
        self._leaves = list(self.params.values())
        self.optimizer = adam(self._leaves, lr, eps=1e-5)
        self.clip, self.vf_coef, self.ent_coef = clip, vf_coef, ent_coef
        self.max_grad_norm = max_grad_norm

    def _loss(self, batch: dict):
        import torch

        clip = self.clip
        logits, values = torch_logits_values(self.params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, 1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = 0.5 * ((values - batch["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        total = pg + self.vf_coef * vf - self.ent_coef * entropy
        return total, {"pg_loss": pg, "vf_loss": vf, "entropy": entropy}

    def update_minibatch(self, batch: dict) -> dict:
        """One clipped-surrogate step on a numpy minibatch; returns the
        losses (0-d tensors on the learner's device) before the step."""
        loss, aux = self._loss(batch_tensors(batch, self.device))
        grads = grads_of(loss, self._leaves)
        apply_grads(self.optimizer, self._leaves, clip_by_global_norm(grads, self.max_grad_norm))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return aux

    def get_weights(self) -> dict:
        return to_numpy(self.params)


def compute_gae(rewards, values, dones, terms, last_values, gamma: float, lam: float):
    """GAE over [T, N] rollouts.

    ``dones`` (termination OR truncation) cuts the advantage chain — no
    credit flows across episode boundaries. ``terms`` (true termination only)
    zeroes the value bootstrap; a time-limit TRUNCATION still bootstraps
    gamma*V(final_obs) — in next-step autoreset mode values[t+1] IS
    V(final_obs), so the recursion's next_values provides it for free.
    Conflating the two underestimates values near the time limit.
    """
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_values = last_values
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * next_values * (1.0 - terms[t]) - values[t]
        last_gae = delta + gamma * lam * (1.0 - dones[t]) * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    return adv, returns
