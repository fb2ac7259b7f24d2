"""Paged decode attention: the hand-written CUDA kernel K4 and its plain
PyTorch versions.

Counterpart of ``ray_tpu/ops/paged_attention.py`` without the tensor-parallel
``mesh`` branch. The serving engine's KV cache is a pool of fixed-size pages
([KV, P_total, page_size, D]); each sequence owns a page-table row, and one
query token per sequence attends to its first ``length`` cached tokens.
``paged_attention_reference`` is the plain version (it gathers the pages);
``paged_attention`` is the wrapper, which launches ``csrc/paged_decode.cu``
(kernel K4, replacing the Pallas ``_paged_kernel``) for CUDA tensors or
raises, and takes the plain version only for CPU tensors.

K4 splits each sequence's pages into runs of ``pages_per_block`` pages, one
block per (sequence, kv head, run), and merges the runs' partial softmax
states in page order. ``paged_attention_split_reference`` is that algebra in
plain PyTorch (per-run partials, ``merge_partials``); tests hold it against
the TPU kernel and the plain version, the main path never calls it.

Length 0: the TPU kernel writes 0 for a sequence with no valid token (its
jnp reference gave the mean of V instead). Every version here follows the
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


# K4's plan: a run holds at least MIN_RUN_TOKENS tokens, and the grid at most
# BLOCKS_PER_SM blocks per SM (blocks past a sequence's length exit at once).
MIN_RUN_TOKENS = 128
BLOCKS_PER_SM = 16


def pages_per_block(batch, kv_heads, pages_per_seq, page_size, n_sm):
    """Pages in each run of kernel K4 (one block per sequence, kv head and
    run), from the launch's shape alone: the lengths live on the device and
    are not read back. A run starts at ceil(MIN_RUN_TOKENS / page_size)
    pages, so a block loads at least ~32 KB of K and V at D 64, and doubles
    while the grid (batch x kv_heads x runs) would exceed BLOCKS_PER_SM per
    SM. At the engine's decode shape (32 sequences, 4 kv heads, 16 pages of
    128 tokens, 132 SMs) a run is one page: the ~5 valid pages of each
    (sequence, kv head) load in parallel, ~640 valid blocks."""
    ppb = max(1, -(-MIN_RUN_TOKENS // page_size))
    while ppb < pages_per_seq and batch * kv_heads * -(-pages_per_seq // ppb) > BLOCKS_PER_SM * n_sm:
        ppb *= 2
    return min(ppb, pages_per_seq)


def merge_partials(m, l, acc):
    """Merges per-run softmax partials in run (page) order, as K4's last
    block does. m, l: [..., R] (m the run's max score, -inf for a run with
    no valid token; l the sum of exp(s - m)); acc: [..., R, D] (the sum of
    exp(s - m) V). Returns [..., D]: sum_r e^(m_r - M) acc_r / sum_r
    e^(m_r - M) l_r with M = max_r m_r; 0 where no run saw a token."""
    M = m[..., 0]
    for r in range(1, m.shape[-1]):
        M = torch.maximum(M, m[..., r])
    M = torch.where(torch.isinf(M), torch.zeros_like(M), M)  # all runs empty: every weight 0
    num = torch.zeros_like(acc[..., 0, :])
    den = torch.zeros_like(l[..., 0])
    for r in range(m.shape[-1]):
        w = torch.exp(m[..., r] - M)  # empty run: exp(-inf) = 0
        num = num + w[..., None] * acc[..., r, :]
        den = den + w * l[..., r]
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], torch.zeros_like(num))


def paged_attention_split_reference(q, k_pages, v_pages, lengths, page_indices, scale=None, pages_per_run=1):
    """K4's split-page algebra in plain PyTorch, fp32: the pages of each
    sequence in runs of ``pages_per_run``, each run's partial (m, l, acc)
    over its valid tokens, merged in page order (``merge_partials``). Same
    arguments and result as ``paged_attention_reference``; tests only."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    group = H // KV
    ppseq = page_indices.shape[1]
    n_runs = -(-ppseq // pages_per_run)
    pad = n_runs * pages_per_run - ppseq
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).float()  # [B, KV, ppseq, ps, D]
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).float()
    qg = q.reshape(B, KV, group, D).float()
    s = torch.einsum("bkgd,bkjtd->bkgjt", qg, k) * scale  # [B, KV, G, ppseq, ps]
    pos = torch.arange(ppseq * ps, device=q.device).reshape(ppseq, ps)
    valid = pos[None] < lengths.reshape(B, 1, 1)  # [B, ppseq, ps]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    s = torch.nn.functional.pad(s, (0, 0, 0, pad), value=float("-inf")).reshape(B, KV, group, n_runs, -1)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B, KV, n_runs, -1, D)
    m = s.amax(-1)  # [B, KV, G, R]; -inf for a run past the length
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
    o = merge_partials(m, p.sum(-1), torch.einsum("bkgrt,bkrtd->bkgrd", p, v))
    return o.reshape(B, H, D).to(q.dtype)


_LIB = None
_COUNTERS: dict = {}  # device -> int32 ticket counters, zero at rest
_N_SM: dict = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_bf16.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, p]
        lib.paged_decode_bf16.restype = i
        lib.paged_decode_error_string.argtypes = [i]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _counters(device, n):
    """K4's ticket counters on `device`: one int32 per (sequence, kv head),
    zeroed once when the buffer is made or grown; each launch's merging
    blocks set theirs back to 0. Launches on one stream run in order, so
    one buffer per device serves them all."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _n_sm(device):
    if device not in _N_SM:
        _N_SM[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _N_SM[device]


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
    ppseq = page_indices.shape[1]
    ppb = pages_per_block(B, KV, ppseq, ps, _n_sm(q.device))
    o = torch.empty_like(q)
    # Partials [B, KV, runs, group, D + 2] fp32: (m, l, acc) per run and q head.
    part = torch.empty(B * -(-ppseq // ppb) * H * (D + 2), dtype=torch.float32, device=q.device)
    cnt = _counters(q.device, B * KV)
    lib = _lib()
    err = lib.paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
        page_indices.data_ptr(), o.data_ptr(), part.data_ptr(), cnt.data_ptr(), B, H, KV, D, P_total, ps,
        ppseq, ppb, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
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
