"""attn_roofline.train: the attention kernels of training in the traced
slice, K1 (flash_fwd_kernel, forward and remat's recompute), K3
(flash_bwd_dq_kernel) and K2 (flash_bwd_dkv_kernel): each launch's bound
(the model type's train_attn_bounds at the step's shape) summed, over their
summed device time by name, in %."""


def read(rec):
    bounds = rec.host.get("attn_bounds")
    if rec.trace is None or not bounds:
        return None
    total_bound = total_time = 0.0
    for symbol, per_launch in bounds.items():
        n, secs = rec.trace.kernel_time(symbol)
        total_bound += n * per_launch
        total_time += secs
    return 100.0 * total_bound / total_time if total_time > 0 else None
