"""Paged decode attention: the hand-written CUDA kernel K4 and its plain
PyTorch version.

Counterpart of ``ray_tpu/ops/paged_attention.py`` without the tensor-parallel
``mesh`` branch. The serving engine's KV cache is a pool of fixed-size pages
([KV, P_total, page_size, D]); each sequence owns a page-table row, and one
query token per sequence attends to its first ``length`` cached tokens.
``paged_attention_reference`` is the plain version (it gathers the pages);
``paged_attention`` is the wrapper, which launches ``csrc/paged_decode.cu``
(kernel K4, replacing the Pallas ``_paged_kernel``) for CUDA tensors or
raises, and takes the plain version only for CPU tensors.

Length 0: the TPU kernel writes 0 for a sequence with no valid token (its
jnp reference gave the mean of V instead). Both versions here follow the
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Launches of kernel K4 (incremented where the kernel is launched, nowhere else).
LAUNCHES = 0


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """q: [B, H, D]; k_pages/v_pages: [KV, P_total, ps, D]; lengths: [B]
    (valid tokens per sequence, INCLUDING the current position);
    page_indices: [B, pages_per_seq] -> [B, H, D]."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    group = H // KV
    ppseq = page_indices.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()
    # [KV, B, ppseq, ps, D] -> [B, KV, S_virt, D]
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KV, ppseq * ps, D)
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KV, ppseq * ps, D)
    qg = q.reshape(B, KV, group, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k).float() * scale
    pos = torch.arange(ppseq * ps, device=q.device)
    valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bksd->bkgd", p, v)
    o = o.masked_fill((lengths <= 0)[:, None, None, None], 0)
    return o.reshape(B, H, D)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.paged_decode_bf16.restype = i
        lib.paged_decode_error_string.argtypes = [i]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def paged_decode(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Launches kernel K4 on CUDA tensors -> [B, H, D] bf16."""
    global LAUNCHES
    B, H, D = q.shape
    KV, P_total, ps, Dk = k_pages.shape
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged kernel: {name} must be a contiguous, 16-byte aligned bf16 CUDA tensor")
    for name, t in (("lengths", lengths), ("page_indices", page_indices)):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"paged kernel: {name} must be a contiguous int32 CUDA tensor")
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"paged kernel: pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    if H % KV or (H // KV) not in (1, 2, 4, 8) or D % 8 or D > 256:
        raise ValueError(f"paged kernel: H={H}, KV={KV}, D={D} unsupported (group in 1/2/4/8, D % 8 == 0, D <= 256)")
    if lengths.shape != (B,) or page_indices.dim() != 2 or page_indices.shape[0] != B:
        raise ValueError("paged kernel: lengths must be [B] and page_indices [B, pages_per_seq]")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lib = _lib()
    err = lib.paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
        page_indices.data_ptr(), o.data_ptr(), B, H, KV, D, P_total, ps,
        page_indices.shape[1], float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged kernel launch failed: {lib.paged_decode_error_string(err).decode()}")
    LAUNCHES += 1
    return o


def paged_attention(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Paged decode attention. q: [B, H, D] (one query token per sequence);
    k_pages/v_pages: [KV, P_total, page_size, D]; lengths: [B] valid tokens
    per sequence including the current one; page_indices: [B, pages_per_seq]
    (entries past a sequence's length must still be valid page ids: use 0).

    CPU tensors take the plain version; CUDA tensors launch kernel K4."""
    H, KV = q.shape[1], k_pages.shape[0]
    if H % KV:
        raise ValueError(f"n_heads {H} not divisible by kv_heads {KV}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, scale)
    return paged_decode(q, k_pages, v_pages, lengths, page_indices, scale)
