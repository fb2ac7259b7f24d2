"""serve.prefill_mfu: the prompts' FLOPs (real lengths; _counts.prefill_flops)
over the device time from the first to the last kernel of each step's
prefill (CUDA events around the prefill groups) times the bf16 peak, in %."""
from perfbench.metrics._counts import PEAK_FLOPS


def read(rec):
    spans = rec.host.get("prefill_spans")
    if not spans:
        return None
    flops = sum(f for f, _ in spans)
    secs = sum(s for _, s in spans)
    return 100.0 * flops / (secs * PEAK_FLOPS) if secs > 0 else None
