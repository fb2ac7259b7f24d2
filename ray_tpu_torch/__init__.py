"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu`` (the JAX reference, which it never
imports). Importing this package is light: torch is imported by the
subpackages, not here.

- ``ray_tpu_torch.models``  the transformer's forward pieces and its params
- ``ray_tpu_torch.ops``     attention kernels (CUDA C++ for sm_90a, built at
                            first use) and their plain PyTorch versions
- ``ray_tpu_torch.llm``     the continuous-batching serving engine, and the
                            in-process serving surface on it (tokenizer,
                            LLMServer, OpenAIServer, the batch UDF)
- ``ray_tpu_torch.qos``     the request context: deadline, priority, cancel
- ``ray_tpu_torch.serve``   the HTTP request/response types of a deployment
- ``ray_tpu_torch.util``    the metrics registry and the tracing span API
- ``ray_tpu_torch.convert`` a ``ray_tpu`` parameter tree -> the port's
"""
