"""Flash attention forward: the hand-written CUDA kernel K1 and its plain
PyTorch version.

Counterpart of ``ray_tpu/ops/attention.py`` (forward only). ``mha_reference``
is the plain version: einsum attention with an fp32 softmax, the oracle the
kernel is held against and the path CPU tensors take. ``flash_attention``
is the wrapper: for a CUDA tensor it launches ``csrc/flash_fwd.cu`` (kernel
K1, which replaces the Pallas ``_fwd_kernel``) or raises; there is no
fallback from the card to the plain version. The kernel masks a ragged S
itself, so it runs for every S, where the TPU wrapper needed S % 128 == 0.
The backward kernels (K2, K3) are a later slice: asking for a gradient
through the kernel raises.

Layouts are the JAX package's: q [B, S, H, D], k/v [B, S, KV, D] with KV
dividing H (GQA: q head h reads kv head h // (H // KV), never repeated in
the kernel), optional segment_ids [B, S] masking attention to same-segment
pairs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Launches of kernel K1 (incremented where the kernel is launched, nowhere else).
LAUNCHES = 0


def mha_reference(q, k, v, causal=True, scale=None, segment_ids=None, return_lse=False):
    """q: [B, S, H, D]; k, v: [B, S, KV, D] (KV divides H) -> [B, S, H, D].
    Softmax in fp32. segment_ids: optional [B, S] int; attention is masked
    to same-segment pairs. ``return_lse`` also returns the per-row
    log-sum-exp [B, H, S] (fp32) that the kernel writes."""
    *_, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    S_q, S_k = s.shape[-2], s.shape[-1]
    if causal:
        mask = torch.ones(S_q, S_k, dtype=torch.bool, device=q.device).tril(S_k - S_q)
        s = s.masked_fill(~mask, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = s.masked_fill(~seg, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_fwd_bf16.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_fwd(q, k, v, segment_ids=None, causal=True, scale=None):
    """Launches kernel K1 on CUDA tensors. Returns (o [B, S, H, D] bf16,
    lse [B * H, S] fp32)."""
    global LAUNCHES
    B, S, H, D = q.shape
    KV = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be a contiguous, 16-byte aligned bf16 CUDA tensor")
        if t.device != q.device:
            raise ValueError("flash kernel: q, k, v must be on one device")
    if k.shape != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D != 64:
        raise ValueError(f"flash kernel: head_dim {D} unsupported (the kernel is built for 64)")
    if H % KV:
        raise ValueError(f"n_heads {H} not divisible by kv_heads {KV}")
    seg = None
    if segment_ids is not None:
        if segment_ids.shape != (B, S):
            raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != {(B, S)}")
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr() if seg is not None else None,
        o.data_ptr(), lse.data_ptr(), B, S, H, KV, D, int(bool(causal)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash kernel launch failed: {lib.flash_fwd_error_string(err).decode()}")
    LAUNCHES += 1
    return o, lse


def flash_attention(q, k, v, causal=True, scale=None, segment_ids=None):
    """Flash attention. q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D].

    CPU tensors take the plain version; CUDA tensors launch kernel K1."""
    H, D = q.shape[2], q.shape[3]
    if H % k.shape[2]:
        raise ValueError(f"n_heads {H} not divisible by kv_heads {k.shape[2]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward on the GPU yet: kernels K2/K3 are a later slice "
            "of the port (call it under torch.no_grad(), or use mha_reference)"
        )
    o, _ = flash_fwd(q, k, v, segment_ids=segment_ids, causal=causal, scale=scale)
    return o
