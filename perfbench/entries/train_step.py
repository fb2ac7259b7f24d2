"""Training steps through ``make_train_step``'s step.

Set-up builds the one training object the window uses: the port's
``init_state`` (its parameters and AdamW), with the benchmark's weights for
the seed copied into its parameters. It then takes the first
``checked_steps`` steps through the same call and feed as the window, and
reads what the comparison needs: each step's loss, the first gradient as
AdamW holds it after step 1 (``exp_avg / (1 - beta1)``), and the
parameters' change over the checked steps. The window then steps on, fresh
rows every step, and closes with a synchronize.
"""
from __future__ import annotations

import time

import torch

from perfbench import trace as tracing
from perfbench import weights
from perfbench.entries import _common
from perfbench.harness import seed_for
from perfbench.metrics import _counts


class Entry:
    def __init__(self, cell, device):
        self.cell, self.device = cell, torch.device(device)
        self.model = cell.model()
        self.m = self.model.port_kwargs(cell.config)
        self.mix = cell.traffic
        self.B, self.S = int(self.mix["batch"]), int(self.mix["seq"])
        self.state = None

    def _params(self, seed: int) -> dict:
        """The seed's weights in float32, the trained master type."""
        return weights.make_params(self.model.leaves(self.m), seed, torch.float32, self.device)

    def _feed(self, seed: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_for(seed, "batches"))
        V = self.m["vocab_size"]
        while True:
            yield {"tokens": torch.randint(0, V, (self.B, self.S + 1), generator=g, device=self.device)}

    def build(self, seed: int):
        from ray_tpu_torch.models.transformer import TransformerConfig, make_train_step

        cfg = TransformerConfig(**_common.model_config(self.m), ce_chunk=int(self.mix.get("ce_chunk", 0)))
        init_state, self.train_step = make_train_step(cfg)
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_for(seed, "init"))
        self.state = st = init_state(g, device=self.device)
        # The seed's weights into the state's parameters, then the checked steps and their readings.
        prog = dict(weights.leaf_items(st["params"]))
        mine = dict(weights.leaf_items(self._params(seed)))
        with torch.no_grad():
            for n, dst in prog.items():
                dst.copy_(mine[n])
        del mine
        self.feed = self._feed(seed)
        beta1 = st["opt"].param_groups[0]["betas"][0]
        losses, grad_norms = [], None
        for _ in range(int(self.mix["checked_steps"])):
            out = self.train_step(st, next(self.feed))
            losses.append(float(out["loss"]))
            if grad_norms is None:
                # A step that left AdamW's state empty read as a zero gradient.
                grad_norms = {n: float(torch.linalg.vector_norm(st["opt"].state[p]["exp_avg"])) / (1 - beta1)
                              if "exp_avg" in st["opt"].state.get(p, {}) else 0.0 for n, p in prog.items()}
        start = dict(weights.leaf_items(self._params(seed)))
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(p - start[n])) for n, p in prog.items()}
        del start
        self.checked = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    def window(self, seed: int, seconds: float, trace: bool = False) -> dict:
        st = self.state
        losses = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched = tracing.Schedule(t0, seconds, self.mix.get("trace", {}), trace)
        steps = 0
        bounds = None
        now = t0
        while now - t0 < seconds:
            was_active = sched.active
            sched.poll(now)
            if sched.active and not was_active:
                bounds = self.model.train_attn_bounds(self.m, self.B, self.S)
            losses.append(self.train_step(st, next(self.feed))["loss"])
            steps += 1
            now = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0 - sched.overhead_s
        summary = sched.finish()
        finite = torch.isfinite(torch.stack(losses)).tolist()
        host = {"t_open": t0, "window_s": window_s, "steps": steps, "tokens": steps * self.B * self.S,
                "window_flops": steps * _counts.train_step_flops(self.model, self.m, self.B, self.S)}
        if bounds:
            host["attn_bounds"] = bounds
        return {"attempted": steps, "failed": finite.count(False), "host": host, "trace": summary,
                "judged": self.checked}

    def free(self):
        self.state = None
        self.train_step = None
        _common.free_cuda()

    def readings(self, seed: int, judged: dict, control: bool = False) -> dict:
        """Runs the plain reference over the checked steps from the seed's
        weights and batches; with ``control`` the fp8 reference as well."""
        from perfbench import check

        params0 = self._params(seed)
        feed = self._feed(seed)
        batches = [next(feed)["tokens"] for _ in range(int(self.mix["checked_steps"]))]
        rows = int(self.mix.get("reference_rows", 2))
        reference = self.cell.reference()
        ref = reference.train_steps(params0, self.m, batches, rows)
        _common.free_cuda()
        out = {"program": check.training_numbers(judged, ref), "reference": ref, "measured": judged}
        if control:
            ctl = reference.train_steps(params0, self.m, batches, rows, fp8=True)
            out["control"] = check.training_numbers(ctl, ref)
            out["control_raw"] = ctl
        del params0, batches
        _common.free_cuda()
        return out
