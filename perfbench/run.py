"""Runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the window's opening: imports, weights made
on the card from the seed, the program built and warmed on the cell's own
shapes) is ``setup_s``. The window then runs for ``--seconds``. Once it has
closed, the peak device memory is read, the program's state is freed, and
the plain reference judges a sample of what the window produced against the
cell's limits. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profiled
slice of the window and from the benchmark's own hooks.

Exits non-zero with no result when no CUDA device is visible, when fewer
cards are visible than the cell asks for, or when a forbidden module (JAX,
its companions, or the JAX package ``ray_tpu``, compared by whole top-level
name) is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The port's kernels build once per checkout into ray_tpu_torch/ops/_build_out/
# (a fixed path inside the checkout); it keeps no other build or kernel cache.


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """Runs the cell (a ``harness.Cell``) once on ``device`` and returns the
    result object (not printed). The look for a chip is the caller's."""
    import torch

    from perfbench import check, harness

    entry_mod = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"])
    entry = entry_mod.Entry(cell, device)
    t_build = time.perf_counter()
    entry.build(seed)
    print(f"set-up: {t_build - t_start:.2f} s to the build (imports), {time.perf_counter() - t_build:.2f} s "
          f"to build (weights, program, warm-up{', checked steps' if cell.traffic['entry'] == 'train_step' else ''})",
          file=sys.stderr, flush=True)
    if trace:
        from perfbench import trace as tracing

        tracing.warm_up()
    out = entry.window(seed, seconds, trace)
    setup_s = out["host"]["t_open"] - t_start  # the window opens inside the entry, after its own set-up
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    entry.free()
    readings = entry.readings(seed, out["judged"])
    correct, compared = check.judge(readings["program"], cell.limits)

    rec = harness.Record(cell=cell, setup_s=setup_s, host=out["host"], trace=out["trace"])
    metrics = harness.read_metrics(rec, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        s = out["trace"]
        print(f"trace: {json.dumps(s.diag)}", file=sys.stderr, flush=True)
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["compared"] = compared
    result["_readings"] = readings
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from perfbench import harness

    man = harness.manifest()
    wl = next((w for w in man["workloads"] if w["name"] == a.workload), None)
    if wl is None:
        log(f"unknown workload {a.workload!r}")
        return 2
    import torch

    log(f"imports: {time.perf_counter() - T_START:.2f} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        log(f"this cell needs {wl['chips']} CUDA device(s); visible: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(harness.load_cell(a.workload, man), a.seed, a.seconds, bool(a.trace), "cuda")
    log(f"card: {card_line()}; torch {torch.__version__}, cuda {torch.version.cuda}")
    readings = result.pop("_readings")
    found = harness.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded in the measuring process: {', '.join(found)}")
        return 4
    log(f"readings: {json.dumps(readings, default=str)}")
    for k, c in result["compared"].items():
        log(f"compared {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
