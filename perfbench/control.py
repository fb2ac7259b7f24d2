"""Readings behind the limits of ``correct``, many seeds in one process.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds <s> [--fault <name>]

For each seed in turn, builds the cell with that seed's weights, runs a
window of the cell's own traffic at its own sizes, frees the program's
state as a run does before the reference runs, and prints one JSON line:
the comparison's numbers for the program (the lower reading's candidates)
and for the control, the plain reference computed in float8 e4m3 matrix
products (the upper reading's candidates). With ``--fault`` a fault of
``faults.py`` is planted in the program first: its numbers are the
program's. The benchmark's own runs never run this.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default="")
    p.add_argument("--no-control", action="store_true")
    a = p.parse_args(argv)

    import contextlib

    import torch

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(a.workload)
    entry = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"]).Entry(cell, "cuda")
    seeds = [int(s) for s in a.seeds.split(",")]
    with (faults.FAULTS[a.fault]() if a.fault else contextlib.nullcontext()):
        for seed in seeds:
            t0 = time.perf_counter()
            entry.build(seed)
            out = entry.window(seed, a.seconds)
            entry.free()
            t1 = time.perf_counter()
            r = entry.readings(seed, out["judged"], control=not a.no_control)
            line = {"seed": seed, "fault": a.fault or None, "program": r["program"], "control": r.get("control"),
                    "attempted": out["attempted"], "failed": out["failed"],
                    "judged_tokens": r.get("tokens"), "judged_requests": r.get("requests"),
                    "build_and_window_s": round(t1 - t0, 2), "reference_s": round(time.perf_counter() - t1, 2)}
            print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
