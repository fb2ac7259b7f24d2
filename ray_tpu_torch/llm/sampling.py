"""Per-request sampling parameters and the batched sampler, in PyTorch.

Counterpart of ``ray_tpu/llm/sampling.py``. Every decode step samples all
slots in one call, so the parameters ride as [B] tensors and one mixed batch
can hold greedy, temperature, top-k and nucleus rows at once. JAX's PRNG keys
become an explicit ``torch.Generator`` (the engine owns one, seeded from
``EngineConfig.seed``): greedy rows match the JAX sampler exactly, sampled
rows follow the same distribution but not the same random stream.
"""
from __future__ import annotations

import dataclasses

import torch

# Candidate cap for truncated (top-k / top-p) rows; see the JAX module for
# the nucleus-width caveat (a high-entropy row with top_p just below 1 samples
# the renormalised top-`cap`). Rows with top_p >= 1 and top_k off sample the
# full distribution exactly.
TOPK_CAP = 128


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls (every field optional).

    temperature: 0 => greedy. top_k: 0 => disabled. top_p: 1.0 => disabled.
    stop_token_ids: extra per-request stop tokens (checked host-side, like
    the engine-global eos). stop: stop STRINGS, applied by a text layer after
    detokenization (the engine speaks tokens). max_tokens: generation budget.
    """

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    max_tokens: int = 64
    stop_token_ids: tuple = ()
    stop: tuple = ()
    # Engine-global eos still applies; set ignore_eos for benchmarks that
    # must generate exactly max_tokens.
    ignore_eos: bool = False

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_tokens <= 0:
            raise ValueError(f"max_tokens must be > 0, got {self.max_tokens}")


def _categorical(logits, generator):
    """One draw per row from softmax(logits) (Gumbel-max; -inf never wins)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + gumbel).argmax(dim=-1)


def sample_batch(logits, temps, top_ps, top_ks, generator, cap: int | None = None):
    """Sample one token per row of logits [B, V] (fp32) under per-row params.

    Rows with temps <= 0 take argmax. Truncated rows (top_k > 0 or
    top_p < 1) sample among the top-`cap` candidates after top-k and nucleus
    masking; plain-temperature rows sample the full distribution."""
    V = logits.shape[-1]
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    cap = min(TOPK_CAP if cap is None else cap, V)
    top_vals, top_idx = torch.topk(scaled, cap, dim=-1)  # [B, cap], descending
    ks = torch.where(top_ks <= 0, cap, top_ks.clamp_max(cap))
    pos = torch.arange(cap, device=logits.device)[None, :]
    neg_inf = logits.new_full((), float("-inf"))  # made on the device: no host copy (graph capture)
    masked = torch.where(pos < ks[:, None], top_vals, neg_inf)
    probs = torch.softmax(masked, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep = (cum - probs) < top_ps[:, None]  # prefix mass before the token
    masked = torch.where(keep, masked, neg_inf)  # first candidate always kept
    choice = _categorical(masked, generator)
    truncated = top_idx.gather(-1, choice[:, None])[:, 0]
    full = _categorical(scaled, generator)
    plain = (top_ps >= 1.0) & (top_ks <= 0)
    out = torch.where(plain, full, truncated)
    return torch.where(temps <= 0.0, greedy, out.to(torch.int32))
