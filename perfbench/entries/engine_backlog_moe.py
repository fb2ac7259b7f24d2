"""``engine_backlog``'s offline backlog for a routed-expert model, with the
bound of the experts' kernel (K6) recorded beside K1's and K4's.

While the profiled slice of a traced run runs (the profiler is on), each
prefill group adds one (bound seconds, launches) pair per layer to
``host["moe_bounds"]``: the model type's ``moe_bound`` on its real prompt
tokens x top k rows, over the four kernels of one K6 call (align, gate-up,
down, combine); each decode block one pair per layer and token step on its
active slots x top k rows. The engine's own code is not changed: its two
methods are wrapped on the instance, as ``EngineHooks`` wraps them. A
traced window that recorded no bound raises: the profiler's flag this
reads is private to torch, and a rename must not leave the metric empty.
"""
from __future__ import annotations

import torch

from perfbench.entries import engine_backlog

KERNELS_PER_CALL = 4  # moe_align_kernel, moe_gemm_kernel (gate-up, down), moe_combine_kernel


def _profiling() -> bool:
    """Whether a profiler runs in this process: the traced slice's profiler
    records all threads, and then the thread-local flag stays off."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
                or torch._C._autograd._profiler_enabled())


class Entry(engine_backlog.Entry):
    def build(self, seed: int):
        super().build(seed)
        self.moe_bounds = []
        self._recording = False
        eng, model, m = self.engine, self.model, self.m
        L, k = m["n_layers"], m["expert_top_k"]
        orig_prefill, orig_decode = eng._prefill_batch_impl, eng._decode

        def prefill(tokens, lengths, third, gen, idxs):
            if self._recording and _profiling():
                rows = k * sum(int(x) for x in lengths)
                self.moe_bounds.extend([(model.moe_bound(m, rows), KERNELS_PER_CALL)] * L)
            return orig_prefill(tokens, lengths, third, gen, idxs)

        def decode(n, gen):
            if self._recording and _profiling():
                active = sum(1 for i, s in enumerate(eng.slots) if s is not None and i not in eng._prefilling)
                if active:
                    self.moe_bounds.extend([(model.moe_bound(m, k * active), KERNELS_PER_CALL)] * (L * n))
            return orig_decode(n, gen)

        eng._prefill_batch_impl, eng._decode = prefill, decode

    def window(self, seed: int, seconds: float, trace: bool = False) -> dict:
        self.moe_bounds, self._recording = [], trace
        out = super().window(seed, seconds, trace)
        self._recording = False
        if trace:
            if not self.moe_bounds:
                raise RuntimeError("a traced window recorded no K6 bound: the profiler's flag "
                                   "(torch.autograd.profiler._is_profiler_enabled) read off in the traced slice")
            out["host"]["moe_bounds"] = self.moe_bounds
        return out
