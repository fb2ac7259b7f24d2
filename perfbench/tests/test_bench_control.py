"""The control: the plain reference computed in float8 e4m3 matrix products
(the next precision below the configurations' bfloat16). Marked ``cuda``, at
the cells' own sizes on the card (control.py, three seeds), it reads past
each cell's limit where the program reads within it; at a tiny size on the
CPU it reads far above the program."""
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import check, harness
from perfbench.run import REPO

SERVING = ("serve.mistral7b.rag", "serve.mistral7b.offline")
TRAINING = ("train.lm250m.s2048", "train.mistral7b-pp8.s4096")


@pytest.mark.parametrize("workload", SERVING + TRAINING)
def test_control_reads_far_above_the_program_tiny(tiny, workload):
    """At a tiny size on the CPU the limits (set at the cells' sizes) do not
    apply to the control; what holds is that the program passes them and
    the control reads at least three times the program on some number."""
    cell = tiny(workload)
    entry = __import__(f"perfbench.entries.{cell.traffic['entry']}", fromlist=["Entry"]).Entry(cell, "cpu")
    seed = 424242
    entry.build(seed)
    out = entry.window(seed, 2.0)
    entry.free()
    r = entry.readings(seed, out["judged"], control=True)
    ok, compared = check.judge(r["program"], cell.limits)
    assert ok, compared
    names = [k for k in r["program"] if not k.startswith("_")]
    assert any(r["control"][k] >= 3 * r["program"][k] for k in names), (r["program"], r["control"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVING + TRAINING)
def test_control_fails_at_the_cells_own_size_on_three_seeds(workload):
    _card()
    cell = harness.load_cell(workload)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "perfbench/control.py", "--workload", workload, "--seeds",
                          "9001,9002,9003", "--seconds", "12"], capture_output=True, text=True, cwd=str(REPO),
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3, time.perf_counter() - t0
    for line in lines:
        assert check.judge(line["program"], cell.limits)[0], line
        assert not check.judge(line["control"], cell.limits)[0], line
