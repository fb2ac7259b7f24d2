"""Attention ops of the port: each CUDA kernel beside its plain PyTorch
version (``attention``: flash forward, kernel K1; ``paged_attention``: paged
decode, kernel K4). As in ``ray_tpu.ops``, the paged op is not re-exported,
so ``ray_tpu_torch.ops.paged_attention`` is always the module."""
from ray_tpu_torch.ops.attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
