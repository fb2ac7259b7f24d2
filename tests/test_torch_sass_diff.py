"""ray_tpu_torch.ops.sass_diff's reading of a cuobjdump listing, on
listings written out here (the tool itself needs the CUDA toolkit)."""
import subprocess

import pytest

from ray_tpu_torch.ops import sass_diff

LISTING = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN37_INTERNAL_{h}_12_flash_bwd_cu_{h}20flash_bwd_dkv_kernelILi64EEEv14CUtensorMap_st
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/{pad}LDC R1, c[0x0][0x28] ;{pad}/* 0x00000a00ff017b82 */
                                                  /* 0x000e220000000800 */
        /*0010*/{pad}{op} ;{pad}/* 0x0000000000047919 */
\t\t..........

Fatbin elf code:
================
\t\tFunction : _ZN37_INTERNAL_{h}_12_flash_bwd_cu_{h}19flash_bwd_dq_kernelILi256EEEv14CUtensorMap_st
        /*0000*/{pad}EXIT ;{pad}/* 0x000000000000794d */
\t\t..........
"""


def _functions(monkeypatch, text):
    def run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 0, stdout=text, stderr="")

    monkeypatch.setattr(sass_diff.subprocess, "run", run)
    monkeypatch.setattr(sass_diff, "_cuobjdump", lambda: "cuobjdump")
    return sass_diff.functions("lib.so")


def test_functions_are_keyed_by_kernel_and_argument(monkeypatch):
    f = _functions(monkeypatch, LISTING.format(h="8d1a0c2f", pad=" " * 19, op="S2R R4, SR_CTAID.X"))
    assert sorted(f) == ["flash_bwd_dkv_kernel<64>", "flash_bwd_dq_kernel<256>"]
    # The listing's end and the next fatbin's header belong to no function.
    assert f["flash_bwd_dkv_kernel<64>"][-1] == "/*0010*/ S2R R4, SR_CTAID.X ; /* 0x0000000000047919 */"
    assert f["flash_bwd_dq_kernel<256>"] == ["/*0000*/ EXIT ; /* 0x000000000000794d */"]


@pytest.mark.parametrize("op, same", [("S2R R4, SR_CTAID.X", True), ("S2R R4, SR_CTAID.Y", False)])
def test_hash_and_padding_do_not_count_but_code_does(monkeypatch, op, same):
    a = _functions(monkeypatch, LISTING.format(h="8d1a0c2f", pad=" " * 19, op="S2R R4, SR_CTAID.X"))
    b = _functions(monkeypatch, LISTING.format(h="77e0b1aa", pad=" " * 23, op=op))
    assert (a == b) is same
