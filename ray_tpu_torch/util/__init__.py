"""ray_tpu_torch.util: the metrics registry, tracing (spans, the task-event
buffer, timeline export) and background-task helpers (stdlib only;
counterparts of ``ray_tpu.util.metrics``, ``ray_tpu.util.tracing`` and
``ray_tpu.util.bgtasks``)."""
