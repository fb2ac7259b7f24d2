"""moe_roofline: kernel K6 (ops/csrc/moe_gemm.cu: moe_align_kernel,
moe_gemm_kernel twice, moe_combine_kernel) in the traced slice: its calls'
bound (the model type's moe_bound on the routed rows of each prefill group
and decode step, the larger of operations over the bf16 peak and bytes over
the HBM peak) over the device time of the kernels whose name holds the
symbol, in %."""
SYMBOL = "moe_"


def read(rec):
    bounds = rec.host.get("moe_bounds")
    if rec.trace is None or not bounds:
        return None
    n, secs = rec.trace.kernel_time(SYMBOL)
    if not n or secs <= 0:
        return None
    per_launch = sum(b for b, _ in bounds) / sum(k for _, k in bounds)
    return 100.0 * per_launch * n / secs
