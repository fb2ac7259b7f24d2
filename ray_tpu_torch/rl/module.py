"""Policy/value module: one param dict, two forwards.

The learner differentiates a torch forward on its device; env runners
(separate worker processes) run the same tiny MLP in numpy — no torch in
rollout workers, no device contention with the learner (reference: RLModule
with framework-specific forwards, rllib/core/rl_module/).

The learner side's helpers live here too: ``learner_device`` (``device=None``
means the GPU; a GPU that is not visible raises ``DeviceUnavailableError``,
the learner never trains on the CPU in its place), and the moves of a
parameter dict between numpy and the learner's tensors. torch is imported
inside them, so a runner that imports this module loads no torch.
"""
from __future__ import annotations

import numpy as np


def init_params(rng: np.random.Generator, obs_dim: int, n_actions: int, hidden=(64, 64)) -> dict:
    """Orthogonal init, SEPARATE actor and critic MLPs (a shared trunk lets
    the large-magnitude value-regression gradients drown the policy gradient
    — the standard separate-networks PPO choice for control tasks). Plain
    numpy dict so it ships through the object store and converts to torch
    on the learner."""
    def dense(fan_in, fan_out, scale):
        w = rng.standard_normal((fan_in, fan_out)).astype(np.float32)
        q, _ = np.linalg.qr(w) if fan_in >= fan_out else np.linalg.qr(w.T)
        q = q if fan_in >= fan_out else q.T
        return (scale * q[:fan_in, :fan_out]).astype(np.float32), np.zeros(fan_out, np.float32)

    params = {}
    for prefix in ("p", "v"):  # policy / value towers
        d = obs_dim
        for i, h in enumerate(hidden):
            params[f"{prefix}w{i}"], params[f"{prefix}b{i}"] = dense(d, h, np.sqrt(2.0))
            d = h
    params["wpi"], params["bpi"] = dense(hidden[-1], n_actions, 0.01)
    params["wvf"], params["bvf"] = dense(hidden[-1], 1, 1.0)
    return params


def n_hidden(params) -> int:
    return sum(1 for k in params if k.startswith("pw"))


def _np_trunk(params, obs, prefix):
    h = obs
    for i in range(n_hidden(params)):
        h = np.tanh(h @ params[f"{prefix}w{i}"] + params[f"{prefix}b{i}"])
    return h


def np_logits_values(params, obs):
    """obs [N, obs_dim] -> (logits [N, A], values [N]). numpy, runner-side."""
    logits = _np_trunk(params, obs, "p") @ params["wpi"] + params["bpi"]
    values = (_np_trunk(params, obs, "v") @ params["wvf"] + params["bvf"])[:, 0]
    return logits, values


def np_sample(params, obs, rng: np.random.Generator):
    """Sample actions (vectorized Gumbel-max categorical draw — one numpy op
    instead of a per-env Python loop in the rollout hot path); returns
    (actions, logp, values)."""
    logits, values = np_logits_values(params, obs)
    gumbel = rng.gumbel(size=logits.shape).astype(np.float32)
    actions = np.argmax(logits + gumbel, axis=1).astype(np.int64)
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    logp = np.log(p[np.arange(len(actions)), actions] + 1e-10).astype(np.float32)
    return actions, logp, values.astype(np.float32)


def torch_logits_values(params, obs):
    """Same math in torch (learner-side, differentiable): ``params`` a dict
    of tensors, ``obs`` [N, obs_dim] on their device. Each layer is one
    ``addmm`` (the bias added inside the GEMM: one pass over the output
    fewer, which eager torch would otherwise spend on every layer)."""
    import torch

    def trunk(prefix):
        h = obs
        for i in range(n_hidden(params)):
            h = torch.tanh(torch.addmm(params[f"{prefix}b{i}"], h, params[f"{prefix}w{i}"]))
        return h

    logits = torch.addmm(params["bpi"], trunk("p"), params["wpi"])
    values = torch.addmm(params["bvf"], trunk("v"), params["wvf"])[:, 0]
    return logits, values


def learner_device(device, caller: str):
    """The torch.device a learner runs on: ``device``, or the GPU when it is
    None. Raises ``DeviceUnavailableError`` when that is a CUDA device and
    none is visible."""
    import torch

    from ray_tpu_torch.core.serialization import DeviceUnavailableError

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"{caller} runs on the GPU by default and no CUDA device is visible; "
            "pass device='cpu' to run on the CPU")
    return dev


def to_tensors(params: dict, device, requires_grad: bool = False) -> dict:
    """numpy parameter dict -> float32 tensors on ``device``, each a copy
    (a learner updates them in place; the caller's arrays stay as they
    are)."""
    import torch

    return {k: torch.tensor(np.asarray(v, np.float32), device=device, requires_grad=requires_grad)
            for k, v in params.items()}


def to_numpy(params: dict) -> dict:
    """Tensor dict -> host numpy copies (what env runners and callers get:
    the learner's tensors go on changing in place)."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in params.items()}


def batch_tensors(batch: dict, device) -> dict:
    """A numpy minibatch on the learner's device, dtypes kept (float32
    columns, int64 actions). Copies: a batch out of the object store is
    read-only."""
    import torch

    return {k: torch.tensor(np.asarray(v), device=device) for k, v in batch.items()}
