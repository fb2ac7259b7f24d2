"""k1_roofline: kernel K1 (ops/csrc/flash_fwd.cu, symbol flash_fwd_kernel) in
the traced slice: its launches' bound (the model type's k1_bound on each
prefill group's real prompt lengths, the larger of operations over the bf16 peak and
bytes over the HBM peak) over its device time by name, in %."""
SYMBOL = "flash_fwd_kernel"


def read(rec):
    bounds = rec.host.get("k1_bounds")
    if rec.trace is None or not bounds:
        return None
    n, secs = rec.trace.kernel_time(SYMBOL)
    if not n or secs <= 0:
        return None
    per_launch = sum(b for b, _ in bounds) / sum(k for _, k in bounds)
    return 100.0 * per_launch * n / secs
