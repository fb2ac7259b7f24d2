"""ray_tpu_torch.util: the metrics registry and the tracing span API (stdlib
only; counterparts of ``ray_tpu.util.metrics`` and the span API of
``ray_tpu.util.tracing``)."""
