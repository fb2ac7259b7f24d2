"""An offline backlog through ``LLMEngine.add_request`` / ``step``, driven
as ``llm/batch.py``'s ``_EngineUDF.__call__`` drives it, in process and
without the Data pool: requests are admitted ahead of the slots, the loop
steps the engine and collects each finished request's tokens.

Set-up fills every slot with the first wave (answer lengths staggered, so
the slots turn over at spread times) and takes the engine's first step,
which prefills it; the window then steps the engine for ``seconds``, keeping
the waiting queue at the mix's ``backlog`` after every step, and counts the
output tokens the steps handed over.
"""
from __future__ import annotations

import time

import torch

from perfbench import trace as tracing
from perfbench import traffic as gen
from perfbench import weights
from perfbench.entries import _common


class Entry:
    def __init__(self, cell, device):
        self.cell, self.device = cell, torch.device(device)
        self.model = cell.model()
        self.m = self.model.port_kwargs(cell.config)
        self.mix = cell.traffic
        self.engine = None

    def build(self, seed: int):
        from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
        from ray_tpu_torch.models.transformer import TransformerConfig

        params = weights.make_params(self.model.leaves(self.m), seed, torch.bfloat16, self.device)
        self.engine = LLMEngine(TransformerConfig(**_common.model_config(self.m)), params=params,
                                engine_config=EngineConfig(**self.mix["engine"]), device=str(self.device))
        del params
        self.engine.warmup(buckets=tuple(self.mix["warmup_buckets"]))

    def _sampling(self, r):
        from ray_tpu_torch.llm.sampling import SamplingParams

        return SamplingParams(temperature=0.0, max_tokens=r.max_tokens, ignore_eos=True)

    def window(self, seed: int, seconds: float, trace: bool = False) -> dict:
        eng = self.engine
        slots = eng.ec.max_slots
        reqs = gen.backlog(self.mix, seed, self.m["vocab_size"], slots)
        backlog = int(self.mix["backlog"])
        nxt = 0
        done = []

        def top_up():
            nonlocal nxt
            while len(eng.waiting) < backlog and nxt < len(reqs):
                r = reqs[nxt]
                eng.add_request(str(r.idx), r.prompt, sampling=self._sampling(r))
                nxt += 1

        def collect(events):
            tokens = 0
            for rid, ev in events.items():
                tokens += len(ev.get("new_tokens", ()))
                if ev.get("finished"):
                    r = reqs[int(rid)]
                    done.append({"prompt": r.prompt, "tokens": ev["tokens"], "max_tokens": r.max_tokens})
            return tokens

        # Set-up: the first wave takes every slot, and the first step prefills it.
        for r in reqs[:slots]:
            eng.add_request(str(r.idx), r.prompt, sampling=self._sampling(r))
        nxt = slots
        top_up()
        collect(eng.step())
        top_up()
        done.clear()

        t0 = time.perf_counter()
        sched = tracing.Schedule(t0, seconds, self.mix.get("trace", {}), trace)
        hooks = _common.EngineHooks(eng, self.model, self.m, sched) if trace else None
        if hooks:
            hooks.counting = True
        out_tokens, steps = 0, 0
        now = t0
        while now - t0 < seconds:
            sched.poll(now)
            out_tokens += collect(eng.step())
            steps += 1
            top_up()
            now = time.perf_counter()
        window_s = now - t0 - sched.overhead_s
        if hooks:
            hooks.counting = False
        summary = sched.finish()
        if nxt >= len(reqs):
            raise RuntimeError(f"the pool of {len(reqs)} requests ran dry: the backlog did not hold")
        failed = sum(1 for d in done if len(d["tokens"]) != d["max_tokens"])
        host = {"t_open": t0, "window_s": window_s, "output_tokens": out_tokens, "steps": steps, "finished": len(done)}
        if hooks:
            host.update(hooks.host())
        picked = gen.judge_sample(done, seed, int(self.mix["judge"]["min_tokens"]))
        return {"attempted": len(done), "failed": failed, "host": host, "trace": summary,
                "judged": [done[i] for i in picked]}

    def free(self):
        self.engine = None
        _common.free_cuda()

    def readings(self, seed: int, judged: list, control: bool = False) -> dict:
        return _common.served_readings(self.cell, self.m, seed, self.device, judged, control)
