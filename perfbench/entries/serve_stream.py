"""Open-loop streaming callers of ``LLMServer.generate_stream``.

The server is built as a serve replica builds it (the port's ``LLMServer``:
an ``LLMEngine``, its warm-up of the mix's buckets, its stepping thread).
Each request of the mix is a caller on a thread of its own, submitted at
its due time however late the server runs; it records when each event with
tokens reached it. Time to first token runs from the due time to the first
token at the caller; the time per output token is (last - first) / (n - 1)
at the caller. A request that fails, times out or comes back short counts as
missing. Requests due near the window's end are waited for, up to the mix's
``drain_s``.
"""
from __future__ import annotations

import concurrent.futures as cf
import math
import sys
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
        self.server = None

    def build(self, seed: int):
        from ray_tpu_torch.llm.deployment import LLMServer

        params = weights.make_params(self.model.leaves(self.m), seed, torch.bfloat16, self.device)
        self.server = LLMServer(_common.model_config(self.m), dict(self.mix["engine"]),
                                warmup_buckets=tuple(self.mix["warmup_buckets"]), params=params,
                                device=str(self.device))

    def window(self, seed: int, seconds: float, trace: bool = False, rate=None) -> dict:
        from ray_tpu_torch.llm.sampling import SamplingParams

        srv, eng = self.server, self.server.engine
        reqs = gen.open_loop(self.mix, seed, seconds, self.m["vocab_size"], rate)
        drain = float(self.mix.get("drain_s", 120))
        n = len(reqs)
        rec = [None] * n

        def consume(i: int, due: float):
            r = reqs[i]
            t_call = time.perf_counter()
            got, toks, ttft_engine, err = [], [], None, None
            try:
                sp = SamplingParams(temperature=0.0, max_tokens=r.max_tokens, ignore_eos=True)
                for ev in srv.generate_stream(r.prompt, r.max_tokens, timeout_s=seconds + drain, sampling=sp):
                    now = time.perf_counter()
                    if ev["new_tokens"]:
                        got.append((now, len(ev["new_tokens"])))
                        toks.extend(ev["new_tokens"])
                    if ttft_engine is None and ev.get("ttft_s") is not None:
                        ttft_engine = ev["ttft_s"]
            except Exception as e:  # noqa: BLE001  (a failed request is counted, not raised)
                err = f"{type(e).__name__}: {e}"
            rec[i] = {"due": due, "call": t_call, "got": got, "tokens": toks, "ttft_engine": ttft_engine,
                      "error": err}

        pool = cf.ThreadPoolExecutor(max_workers=n, thread_name_prefix="caller")
        t0 = time.perf_counter() + 0.01
        t_end = t0 + seconds
        sched = tracing.Schedule(t0, seconds, self.mix.get("trace", {}), trace)
        hooks = _common.EngineHooks(eng, self.model, self.m, sched, poll=True) if trace else None
        late, futs = [], []

        def wait_until(when: float):
            while True:
                now = time.perf_counter()
                if now >= when:
                    return now
                time.sleep(when - now)

        queue_start = None
        if hooks:
            hooks.counting = True
        for r in reqs:
            due = t0 + r.due_s
            now = wait_until(due)
            if queue_start is None:
                queue_start = len(eng.waiting)
            late.append(now - due)
            futs.append(pool.submit(consume, r.idx, due))
        wait_until(t_end)
        queue_end = len(eng.waiting)
        if hooks:
            hooks.counting = False
        cf.wait(futs, timeout=seconds + drain + 30)
        pool.shutdown(wait=True)
        summary = sched.finish()  # after the callers: reducing the trace holds the interpreter for seconds
        for f in futs:
            f.result()  # consume records its request's failure; anything else is the harness's
        errors = [x["error"] for x in rec if x is not None and x["error"]]
        if errors:
            print(f"{len(errors)} requests failed, the first: {errors[0]}", file=sys.stderr, flush=True)
        late.sort()
        print(f"generator: {n} requests, late by p50 {late[n // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms; "
              f"waiting queue {queue_start} at the first arrival, {queue_end} at the window's end",
              file=sys.stderr, flush=True)

        ttft, tpot, gaps, done, out_tokens, failed = [], [], [], [], 0, 0
        for i, r in enumerate(reqs):
            x = rec[i]
            out_tokens += sum(k for t, k in (x["got"] if x else ()) if t0 <= t < t_end)
            ok = x is not None and x["error"] is None and len(x["tokens"]) == r.max_tokens
            if not ok:
                failed += 1
                ttft.append(math.inf)
                continue
            first, last = x["got"][0][0], x["got"][-1][0]
            ttft.append(first - x["due"])
            # The per-layer readings of a traced run leave out the requests
            # the profiler held up.
            if not sched.overlaps(x["call"], last):
                if r.max_tokens > 1:
                    tpot.append((last - first) / (r.max_tokens - 1))
                if x["ttft_engine"] is not None:
                    gaps.append((first - x["call"]) - x["ttft_engine"])
            done.append({"prompt": r.prompt, "tokens": x["tokens"]})
        host = {"t_open": t0, "window_s": seconds, "output_tokens": out_tokens, "ttft_s": ttft, "tpot_s": tpot,
                "ttft_gap_s": gaps, "late_s": late, "queue_start": queue_start, "queue_end": queue_end,
                "requests": n, "drain_limit_s": seconds + drain}
        if hooks:
            host.update(hooks.host())
        picked = gen.judge_sample(done, seed, int(self.mix["judge"]["min_tokens"]))
        return {"attempted": n, "failed": failed, "host": host, "trace": summary,
                "judged": [done[i] for i in picked]}

    def free(self):
        if self.server is not None:
            self.server.__raytpu_exit__()
            self.server = None
        _common.free_cuda()

    def readings(self, seed: int, judged: list, control: bool = False) -> dict:
        return _common.served_readings(self.cell, self.m, seed, self.device, judged, control)
