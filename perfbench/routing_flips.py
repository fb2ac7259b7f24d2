"""Where a routed model's served logits part from the plain reference's.

    python3 perfbench/routing_flips.py --workload serve.mellum2.repo_offline --seeds 1,2 --seconds 12

For each seed: the cell's window, then its longest judged request that fits
a prefill bucket, teacher-forced through the engine's own prefill (K1, the
router, K6). Per layer, against the float32 reference on the same weights:
the median relative gap of the hidden state, that gap on tokens whose
routing has not yet differed, the share of token-layers whose top-k sets
differ, the share whose first difference is at that layer, and the
reference's margin (k-th minus (k+1)-th router logit) there and overall.
Then the same shares for perturbed copies of the reference alone (no code
of the port): ``one_bf16`` rounds the residual to bf16 once, after layer 0;
``res_bf16`` rounds it after every sublayer; ``mm_bf16`` rounds every weight
product's operands and result to bf16 and keeps the residual in fp32;
``fp8`` is the control. For each: the widest and the mean gap of the picked
token's logit below the reference's best at the answer's positions (the
program's picks are its served tokens), and the share of positions where
it is not the reference's first. One JSON line per seed.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import harness  # noqa: E402

MODES = ("one_bf16", "res_bf16", "mm_bf16", "fp8")


def _bf(x):
    return x.bfloat16().float()


def ref_layer(ref, x, lp, m: dict, li: int, mode: str):
    """Layer ``li`` of ``reference/<model_type>.py``'s routed block on x [1,
    S, D] with ``mode``'s rounding -> (x, the router's top k + 1 logits)."""
    import torch

    from perfbench.reference import plain

    fp8 = mode == "fp8"
    mm = (lambda a, w, fp8=False: _bf(plain.mm(_bf(a), w))) if mode == "mm_bf16" else plain.mm
    saved, ref.mm = ref.mm, mm  # the experts' products too
    try:
        Hd = m["head_dim"]
        window = m["sliding_window"] if m["layer_types"][li] == "sliding" else 0
        h = plain.rms_norm(x, lp["attn_norm"])
        q, k, v = mm(h, lp["wq"], fp8), mm(h, lp["wk"], fp8), mm(h, lp["wv"], fp8)
        if window:
            freqs = (m["rope_theta"] ** (-2.0 * torch.arange(Hd // 2, dtype=torch.float64) / Hd)).float()
            q, k = ref.rotate(q, freqs), ref.rotate(k, freqs)
        else:
            y = m["rope_scaling"]
            freqs = ref.yarn_freqs(Hd, y["rope_theta"], y)
            q, k = ref.rotate(q, freqs, y["attention_factor"]), ref.rotate(k, freqs, y["attention_factor"])
        o = ref.attention(q, k, v, window)
        if mode == "mm_bf16":
            o = _bf(o)
        x = x + mm(o.reshape(*o.shape[:2], -1), lp["wo"].reshape(-1, lp["wo"].shape[-1]), fp8)
        if mode == "res_bf16":
            x = _bf(x)
        h2 = plain.rms_norm(x, lp["ffn_norm"])
        if mode == "mm_bf16":
            h2 = _bf(h2)
        logits = plain.mm(h2.reshape(-1, h2.shape[-1]), lp["router"], fp8)  # fp32, as the program's router
        top = torch.topk(logits, m["expert_top_k"] + 1, dim=-1)
        x = x + ref.experts(h2, lp, m, fp8)
        if mode == "res_bf16" or (mode == "one_bf16" and li == 0):
            x = _bf(x)
        return x, top
    finally:
        ref.mm = saved


def _program(entry, d, bucket_of):
    """The engine's prefill over d's prompt and answer (but its last token):
    per-layer hidden states (on the host) and top-k ids, and the picks of
    its logits at the answer's positions."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import moe

    eng = entry.engine
    P = len(d["prompt"])
    seq = np.asarray(list(d["prompt"]) + list(d["tokens"][:-1]), np.int32)
    T, b = len(seq), bucket_of(len(seq))
    xs, ids = [], []
    route, ffn = moe.route, eng._attn_out_ffn

    def routed(h, r, k):
        out = route(h, r, k)
        ids.append(out[1][:T].long().sort(dim=-1).values.cpu())
        return out

    def layer_out(x, li, os, prefill=False):
        out = ffn(x, li, os, prefill)
        xs.append(out[0][0, :T].cpu())
        return out

    moe.route, eng._attn_out_ffn = routed, layer_out
    try:
        pad = np.zeros((1, b), np.int32)
        pad[0, :T] = seq
        with torch.no_grad():
            eng._prefill_logits(pad, np.array([T], np.int32), np.zeros((1, b // eng.ec.page_size), np.int32))
            picks = eng._head([xs[-1][None].to(eng.device)], lambda x: x[0, P - 1:T]).argmax(dim=-1).cpu()
    finally:
        moe.route = route
        del eng._attn_out_ffn  # the instance attribute; the class's method again
    return seq, xs, ids, picks


def flips(cell, seed: int, seconds: float, device: str) -> dict:
    """One seed's record (the module's docstring says what it holds)."""
    import torch

    from perfbench import weights
    from perfbench.entries import _common
    from perfbench.reference import plain

    ref = cell.reference()
    t0 = time.perf_counter()
    entry = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"]).Entry(cell, device)
    entry.build(seed)
    judged = entry.window(seed, seconds)["judged"]
    buckets = entry.engine.buckets
    d = max((d for d in judged if len(d["prompt"]) + len(d["tokens"]) - 1 <= max(buckets)),
            key=lambda d: len(d["prompt"]) + len(d["tokens"]))
    seq, prog_x, prog_ids, prog_picks = _program(entry, d, lambda n: next(x for x in buckets if x >= n))
    entry.free()
    m, dev = entry.m, device
    T, P, L, k = len(seq), len(d["prompt"]), m["n_layers"], m["expert_top_k"]
    params = weights.make_params(cell.model().leaves(m), seed, torch.bfloat16, dev)
    ids_t = torch.as_tensor(seq, device=dev).long()
    at = torch.arange(P - 1, T, device=dev)
    rec = {"seed": seed, "judged": len(judged), "tokens": T, "prompt": P, "answer": len(d["tokens"])}

    def forward(mode):
        x = params["embed"][ids_t].float()[None]
        states, ids, margins = [], [], []
        for i in range(L):
            lp = {name: t[i].float() for name, t in params["layers"].items()}
            x, top = ref_layer(ref, x, lp, m, i, mode)
            states.append(x[0] if mode == "fp32" else x[0].bfloat16())
            ids.append(top.indices[:, :k].sort(dim=-1).values.cpu())
            margins.append((top.values[:, k - 1] - top.values[:, k]).cpu())
            del lp
        lg = plain.mm(plain.rms_norm(x[0, at], params["final_norm"].float()), params["lm_head"].float(),
                      mode == "fp8")
        return lg, states, ids, margins

    with torch.no_grad(), plain.exact_fp32():
        logits, ref_x, ref_ids, margins = forward("fp32")
        best = logits.max(dim=-1).values

        def gaps(picks):
            g = best - logits.gather(-1, picks.to(dev)[:, None])[:, 0]
            return {"max_gap": float(g.max()), "mean_gap": float(g.mean()), "not_first": float((g > 0).float().mean())}

        def layers(xs, ids):
            seen = torch.zeros(T, dtype=torch.bool)
            rows = []
            for i in range(L):
                rel = ((xs[i].to(dev).float() - ref_x[i]).norm(dim=-1) / ref_x[i].norm(dim=-1)).cpu()
                differ = (ids[i] != ref_ids[i]).any(dim=-1)
                first = differ & ~seen
                rows.append({"rel_gap": float(rel.median()),
                             "rel_gap_unflipped": float(rel[~seen].median()) if (~seen).any() else None,
                             "flipped": float(differ.float().mean()), "first_flip": float(first.float().mean()),
                             "margin": float(margins[i].median()),
                             "margin_at_first_flip": float(margins[i][first].median()) if first.any() else None})
                seen |= differ
            return {"tokens_flipped": float(seen.float().mean()), "layers": rows}

        rec["program"] = {**layers(prog_x, prog_ids), **gaps(torch.as_tensor(d["tokens"]).long()),
                          "prefill_picks": gaps(prog_picks)}
        del prog_x
        for mode in MODES:
            lg, xs, ids, _ = forward(mode)
            rec[mode] = {**layers(xs, ids), **gaps(lg.argmax(dim=-1))}
            del lg, xs, ids
            _common.free_cuda()
    del params, ref_x
    _common.free_cuda()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(flips(cell, seed, a.seconds, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
