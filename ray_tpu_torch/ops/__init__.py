"""Attention ops of the port: each CUDA kernel beside its plain PyTorch
version (``attention``: flash forward K1 and backward K3/K2;
``paged_attention``: paged decode, kernel K4; ``splash``: splash's contract
onto the flash kernels). As in ``ray_tpu.ops``, the paged op is not
re-exported, so ``ray_tpu_torch.ops.paged_attention`` is always the module."""
from ray_tpu_torch.ops.attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
