"""The knee of an open-loop cell, found once by a sweep of fixed rates.

    python3 perfbench/sweep.py --workload <name> --rates 4,6,8 --seconds <s> --seed <n>

Builds the cell once, then runs a window of the cell's traffic at each rate
in turn (the server drained between them) and prints one JSON line per rate:
the waiting queue at the first arrival and at the window's end, the time to
first token and per output token at p50 and p95, output tokens/s, and the
requests missing. The knee is the highest rate whose queue at the window's
end is no longer than at its start. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.metrics._counts import percentile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(a.workload)
    entry = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"]).Entry(cell, "cuda")
    entry.build(a.seed)
    for rate in (float(r) for r in a.rates.split(",")):
        out = entry.window(a.seed, a.seconds, rate=rate)
        h = out["host"]
        ttft = sorted(h["ttft_s"])
        line = {"rate_per_s": rate, "requests": h["requests"], "missing": out["failed"],
                "queue_start": h["queue_start"], "queue_end": h["queue_end"],
                "ttft_p50_ms": 1e3 * percentile(ttft, 50), "ttft_p95_ms": 1e3 * percentile(ttft, 95),
                "tpot_p50_ms": 1e3 * percentile(h["tpot_s"], 50) if h["tpot_s"] else None,
                "tpot_p95_ms": 1e3 * percentile(h["tpot_s"], 95) if h["tpot_s"] else None,
                "output_tok_s": h["output_tokens"] / h["window_s"], "late_max_ms": 1e3 * max(h["late_s"])}
        print(json.dumps(line), flush=True)
    entry.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
