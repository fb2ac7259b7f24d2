"""Faults planted in the program underneath a run, to show that the
comparison catches them (``correct`` comes out false). Each is a context
manager that patches the port's module attributes while it is open; build
the cell inside it.

- ``unchanged_state``: the training step computes its loss and gradients
  but its optimizer step leaves the parameters and its state as they were.
- ``half_batch``: the training loss is the mean over the first half of the
  batch's rows only.
- ``altered_token``: every sampling call of the engine hands back the first
  row's token plus one (the prefill group's first request, slot 0 in decode).

A single-chip cell has no exchange between chips, so that fault has no
place here.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged_state():
    import torch

    from ray_tpu_torch.models import transformer

    class _Frozen(torch.optim.AdamW):
        def step(self, closure=None):
            return None

    orig = transformer.adamw
    transformer.adamw = lambda params: _Frozen(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    try:
        yield
    finally:
        transformer.adamw = orig


@contextlib.contextmanager
def half_batch():
    from ray_tpu_torch.models import transformer

    orig = transformer.cross_entropy_loss

    def half(params, batch, cfg):
        rows = batch["tokens"].shape[0] // 2
        return orig(params, {k: v[:rows] for k, v in batch.items()}, cfg)

    transformer.cross_entropy_loss = half
    try:
        yield
    finally:
        transformer.cross_entropy_loss = orig


@contextlib.contextmanager
def altered_token():
    from ray_tpu_torch.llm.engine import LLMEngine

    orig = LLMEngine._sample

    def sample(self, logits, *args, **kwargs):
        out = orig(self, logits, *args, **kwargs).clone()
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    LLMEngine._sample = sample
    try:
        yield
    finally:
        LLMEngine._sample = orig


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch, "altered_token": altered_token}
