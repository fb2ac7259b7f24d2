"""k4_roofline: kernel K4 (ops/csrc/paged_decode.cu, symbol
paged_decode_kernel) in the traced slice: its launches' bound (the model type's
k4_bound on the KV each decode step reads at the active slots' lengths) over its
device time by name, in %."""
SYMBOL = "paged_decode_kernel"


def read(rec):
    bounds = rec.host.get("k4_bounds")
    if rec.trace is None or not bounds:
        return None
    n, secs = rec.trace.kernel_time(SYMBOL)
    if not n or secs <= 0:
        return None
    per_launch = sum(b for b, _ in bounds) / sum(k for _, k in bounds)
    return 100.0 * per_launch * n / secs
