"""serve.mfu: FLOPs of the window's prompt tokens and handed-over output
tokens (_counts.prefill_flops, decode_token_flops) over the window's seconds
times the bf16 peak, in %."""
from perfbench.metrics._counts import PEAK_FLOPS


def read(rec):
    h = rec.host
    if not h.get("window_flops"):
        return None
    return 100.0 * h["window_flops"] / (h["window_s"] * PEAK_FLOPS)
