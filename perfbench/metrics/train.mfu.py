"""train.mfu: FLOPs of the window's training steps (_counts.train_step_flops:
6 per matmul weight per token, untied head included, embedding lookup not,
plus 3 x the causal attention; recomputation not counted) over the window's
seconds times the bf16 peak, in %."""
from perfbench.metrics._counts import PEAK_FLOPS


def read(rec):
    h = rec.host
    if not h.get("steps"):
        return None
    return 100.0 * h["window_flops"] / (h["window_s"] * PEAK_FLOPS)
