"""What the entries share: the port's config from the benchmark's keywords,
the serving comparison, and the traced run's hooks on an engine.

The hooks wrap, as attributes of one engine instance and only in a traced
run, the calls the benchmark measures around: ``step`` (wall time, slots
occupied), ``_prefill_batch_impl`` (one prefill group: its real prompt
lengths, CUDA events before and after it), ``_decode`` (one decode block:
the active slots' lengths). With ``poll`` the step wrapper also starts and
stops the profiled slice, so the thread that launches the work starts the
profiler. Each wrapper also opens a ``record_function`` span
(``engine.step``, ``engine.prefill_group``, ``engine.decode_block``) that
names the host's time in the trace's idle gaps. The program's code is
not changed.
"""
from __future__ import annotations

import time

import torch

from perfbench import weights
from perfbench.metrics import _counts

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def model_config(m: dict) -> dict:
    """TransformerConfig keywords with torch dtypes."""
    return {**m, "dtype": DTYPES[m["dtype"]], "param_dtype": DTYPES[m["param_dtype"]]}


def served_readings(cell, m: dict, seed: int, device, judged: list, control: bool = False) -> dict:
    """The serving comparison's numbers: the widest gap of the judged
    requests' served tokens below the plain reference's best (``program``)
    and, with ``control``, the same of the fp8 control's first choices. The
    cell's reference draws the seed's weights again."""
    params = weights.make_params(cell.model().leaves(m), seed, torch.bfloat16, device)
    recs = cell.reference().served_gaps(params, m, [(list(map(int, d["prompt"])), d["tokens"]) for d in judged],
                                        control)
    del params
    free_cuda()
    out = {"program": {"max_logit_gap": max(r["gap"] for r in recs)},
           "tokens": sum(r["tokens"] for r in recs), "requests": len(recs)}
    if control:
        out["control"] = {"max_logit_gap": max(r["control_gap"] for r in recs)}
    return out


def free_cuda():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class EngineHooks:
    """Records, while ``counting`` is set, what the per-layer metrics read:
    ``step_s`` per step outside the profiled slice, ``occupancy`` per step; ``prefill`` per step with a
    prefill: (prompt FLOPs, first group's start event, last group's end
    event); ``window_flops`` of the prompt and generated tokens; and, while
    the schedule's slice is active, the bounds of the K1 and K4 launches
    (``k1``/``k4``: (summed bound seconds, launches))."""

    def __init__(self, eng, model, m: dict, sched, poll: bool = False):
        self.eng, self.model, self.m, self.sched = eng, model, m, sched
        self.counting = False
        self.step_s, self.occupancy, self.prefill = [], [], []
        self.window_flops = 0.0
        self.k1, self.k4 = [], []
        self._groups = []
        self._events = eng.device.type == "cuda"
        orig_step, orig_prefill, orig_decode = eng.step, eng._prefill_batch_impl, eng._decode

        def step():
            if poll:
                sched.poll(time.perf_counter())  # the stepping thread starts and stops the slice
            t = time.perf_counter()
            with torch.profiler.record_function("engine.step"):
                events = orig_step()
            if self.counting and not (self.sched is not None and self.sched.active):
                # Steps under the profiler run slower: their times are left out.
                self.step_s.append(time.perf_counter() - t)
                finished = sum(1 for e in events.values() if e.get("finished"))
                busy = sum(1 for s in eng.slots if s is not None) + finished
                self.occupancy.append(min(busy, eng.ec.max_slots) / eng.ec.max_slots)
                if self._groups:
                    self.prefill.append((sum(g[0] for g in self._groups), self._groups[0][1], self._groups[-1][2]))
            self._groups = []
            return events

        def prefill(tokens, lengths, third, gen, idxs):
            lens = [int(x) for x in lengths]
            start = self._event()
            with torch.profiler.record_function("engine.prefill_group"):
                out = orig_prefill(tokens, lengths, third, gen, idxs)
            end = self._event()
            if self.counting:
                flops = _counts.prefill_flops(model, m, lens)
                self.window_flops += flops
                self._groups.append((flops, start, end))
                if self.sched is not None and self.sched.active:
                    self.k1.append(model.k1_bound(m, lens))
            return out

        def decode(n, gen):
            if self.counting:
                self._count_decode(n)
            with torch.profiler.record_function("engine.decode_block"):
                return orig_decode(n, gen)

        eng.step, eng._prefill_batch_impl, eng._decode = step, prefill, decode

    def _event(self):
        if not self._events:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _count_decode(self, n: int):
        eng = self.eng
        active = [i for i, s in enumerate(eng.slots) if s is not None and i not in eng._prefilling]
        lens = [int(eng.lengths[i]) for i in active]
        owed = [eng.slots[i].max_tokens - eng.slots[i].n_generated for i in active]
        for j in range(n):
            # Tokens the block computes that are handed over: a slot whose
            # budget ends inside the block computes the rest for nothing.
            self.window_flops += sum(_counts.decode_token_flops(self.model, self.m, ln + j + 1)
                                     for ln, o in zip(lens, owed) if j < o)
        if self.sched is not None and self.sched.active and lens:
            self.k4.append(self.model.k4_bound(self.m, [[ln + j + 1 for ln in lens] for j in range(n)],
                                               eng.ec.page_size))

    def prefill_spans(self):
        """[(prompt FLOPs, device seconds from the first to the last kernel
        of the step's prefill)] (CUDA events; needs the work finished)."""
        if not self._events:
            return []
        torch.cuda.synchronize()
        return [(f, a.elapsed_time(b) * 1e-3) for f, a, b in self.prefill]

    def host(self) -> dict:
        return {"step_s": self.step_s, "occupancy": self.occupancy, "prefill_spans": self.prefill_spans(),
                "window_flops": self.window_flops, "k1_bounds": self.k1, "k4_bounds": self.k4}
