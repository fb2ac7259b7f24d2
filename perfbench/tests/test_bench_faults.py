"""The comparison catches a broken timed path: a run of the harness on the
CPU (the look for a chip skipped) at a tiny size, first sound, then with
each fault of ``faults.py`` the cell can have planted underneath, and
``correct`` comes out true, then false. The cells' own limits are used."""
import time

import pytest

from perfbench import faults
from perfbench.run import run_cell

CASES = [("serve.mistral7b.rag", None), ("serve.mistral7b.rag", "altered_token"),
         ("serve.mistral7b.offline", None), ("serve.mistral7b.offline", "altered_token"),
         ("train.lm250m.s2048", None), ("train.lm250m.s2048", "unchanged_state"),
         ("train.lm250m.s2048", "half_batch"), ("train.mistral7b-pp8.s4096", None),
         ("train.mistral7b-pp8.s4096", "unchanged_state"), ("train.mistral7b-pp8.s4096", "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_is_true_when_sound_and_false_under_each_fault(tiny, workload, fault):
    cell = tiny(workload)
    if fault is None:
        result = run_cell(cell, 2**31 + 17, 2.0, False, "cpu", t_start=time.perf_counter())
        assert result["correct"], result["compared"]
        return
    with faults.FAULTS[fault]():
        result = run_cell(cell, 2**31 + 17, 2.0, False, "cpu", t_start=time.perf_counter())
    assert not result["correct"], result["compared"]
    assert list(result)[-2:] == ["compared", "_readings"]
