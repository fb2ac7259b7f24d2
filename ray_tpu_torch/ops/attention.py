"""Flash attention: the hand-written CUDA kernels K1 (forward), K3 (dQ) and
K2 (dK, dV), and their plain PyTorch versions.

Counterpart of ``ray_tpu/ops/attention.py``. ``mha_reference`` is the plain
forward: einsum attention with an fp32 softmax, the oracle K1 is held against
and the path CPU tensors take. ``flash_bwd_reference`` is the plain backward
in the TPU backward's recompute form (P from the saved LSE, delta from dO and
O, the GQA sum over each kv head's group), the oracle of K2 and K3.
``flash_attention`` is the wrapper: for a CUDA tensor it runs
``_FlashAttention``, a ``torch.autograd.Function`` whose forward launches
``csrc/flash_fwd.cu`` (K1, which replaces the Pallas ``_fwd_kernel``) and
whose backward launches ``csrc/flash_bwd.cu`` (K3 and K2, which replace
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), or raises; there is no fallback
from the card to the plain version. CPU tensors take ``mha_reference``, which
autograd differentiates. The kernels mask a ragged S themselves, so they run
for every S, where the TPU wrapper needed S % 128 == 0.

Layouts are the JAX package's: q [B, S, H, D], k/v [B, S, KV, D] with KV
dividing H (GQA: q head h reads kv head h // (H // KV), never repeated in
the kernels), optional segment_ids [B, S] masking attention to same-segment
pairs. LSE and delta are fp32 [B * H, S]. The kernels are built for the head
dims in ``HEAD_DIMS`` (64, 128 and 256, the head dims the TPU kernels
document); ``check_head_dim`` is the one test of that, read by the
kernels' wrappers and by the constructors that would
launch them (``LLMEngine``, ``make_train_step``'s ``init_state``), so a model
at another head dim fails when it is built on the card, not at its first
step. The plain versions take every D.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# Head dims the CUDA kernels K1, K3 and K2 are built for (template
# instances in csrc/flash_fwd.cu and csrc/flash_bwd.cu).
HEAD_DIMS = (64, 128, 256)
# The head dim of K1's sliding-window instance.
WINDOW_HEAD_DIM = 128

# Launches of each kernel (incremented where it is launched, nowhere else):
# K1 flash forward, K3 backward dQ, K2 backward dK/dV.
LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0


def check_head_dim(head_dim, device):
    """Raises ValueError when the flash kernels would run on ``device`` at a
    head dim they are not built for. CPU devices take the plain versions,
    which accept every head dim."""
    if torch.device(device).type == "cuda" and head_dim not in HEAD_DIMS:
        raise ValueError(
            f"head_dim {head_dim} is not supported by the flash kernels on CUDA "
            f"(supported: {', '.join(map(str, HEAD_DIMS))})")


def _valid_pairs(S_q, S_k, causal, segment_ids, device, window=0):
    """[B or 1, 1, S_q, S_k] bool: the (query, key) pairs that attend under
    the causal, window and segment masks, or None when nothing is masked.
    ``window`` > 0 keeps the keys j of query i with i - window < j (query
    and key positions aligned at the end, as the causal mask's)."""
    valid = None
    if causal:
        valid = torch.ones(S_q, S_k, dtype=torch.bool, device=device).tril(S_k - S_q)
    if window:
        near = torch.ones(S_q, S_k, dtype=torch.bool, device=device).triu(S_k - S_q - window + 1)
        valid = near if valid is None else valid & near
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        valid = seg if valid is None else valid & seg
    return valid


def mha_reference(q, k, v, causal=True, scale=None, segment_ids=None, return_lse=False, window=0):
    """q: [B, S, H, D]; k, v: [B, S, KV, D] (KV divides H) -> [B, S, H, D].
    Softmax in fp32. segment_ids: optional [B, S] int; attention is masked
    to same-segment pairs. ``window`` > 0: query i sees keys j > i - window
    only (a sliding layer). ``return_lse`` also returns the per-row
    log-sum-exp [B, H, S] (fp32) that the kernel writes."""
    *_, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    valid = _valid_pairs(s.shape[-2], s.shape[-1], causal, segment_ids, q.device, window)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def flash_bwd_reference(q, k, v, o, lse, do, segment_ids=None, causal=True, scale=None):
    """The plain backward of flash attention, in the recompute form of the TPU
    backward: P = exp(scale * Q K^T - LSE) from the forward's saved LSE
    [B * H, S], masked; delta = rowsum(dO * O); dS = P * (dO V^T - delta) *
    scale; dQ = dS K; dK, dV = dS^T Q, P^T dO summed over each kv head's
    group of q heads. Computes in fp32 and returns (dq, dk, dv) in the dtypes
    of q, k and v. Masked pairs (and rows that see no key) get P = 0."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    group = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    # In place where it can: at the training shape each [B, H, S, S] fp32
    # tensor is 4.3 GB.
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale).sub_(lse.reshape(B, H, S, 1)).exp_()
    valid = _valid_pairs(S, S, causal, segment_ids, q.device)
    if valid is not None:
        p.masked_fill_(~valid, 0.0)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # [B, H, S, 1]
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf).sub_(delta).mul_(p).mul_(scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, S, KV, group, D).sum(3)
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, S, KV, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_LIB = None
_BWD_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_fwd_bf16.restype = i
        lib.flash_fwd_window_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_fwd_window_bf16.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, t, dtype, device):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        raise ValueError(f"flash kernel: {name} must be a contiguous, 16-byte aligned {kind} CUDA tensor")
    if t.device != device:
        raise ValueError("flash kernel: every input must be on one device")


def _check_qkv(q, k, v):
    B, S, H, D = q.shape
    KV = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, torch.bfloat16, q.device)
    if k.shape != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    check_head_dim(D, q.device)
    if H % KV:
        raise ValueError(f"n_heads {H} not divisible by kv_heads {KV}")


def _seg_arg(segment_ids, B, S, device):
    if segment_ids is None:
        return None
    if segment_ids.shape != (B, S):
        raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)} != {(B, S)}")
    return segment_ids.to(device=device, dtype=torch.int32).contiguous()


_BOUND = threading.local()  # per thread: the devices whose context _stream bound


def _stream(t):
    """The handle of the current stream on t's device, for a launch.

    K1, K3 and K2 encode their TMA tensor maps through the driver API
    before any runtime call, and the driver needs the device's primary
    context current on the calling thread. torch makes it current only on a
    thread where it has called the runtime, so on a thread whose first work
    on the card is one of these kernels (its tensors restored on another
    thread, its outputs served from the allocator's cache) the encoding
    fails with cudaErrorInvalidValue unless something binds it first. A
    stream query, a runtime call, binds it: once per thread and device."""
    stream = torch.cuda.current_stream(t.device)
    bound = _BOUND.__dict__.setdefault("devices", set())
    if t.device.index not in bound:
        with torch.cuda.device(t.device):
            stream.query()
        bound.add(t.device.index)
    return stream.cuda_stream


def flash_fwd(q, k, v, segment_ids=None, causal=True, scale=None, window=0):
    """Launches kernel K1 on CUDA tensors. Returns (o [B, S, H, D] bf16,
    lse [B * H, S] fp32). ``window`` > 0 (causal only) launches K1's window
    instance: KV tiles wholly left of a q tile's window are never loaded."""
    global LAUNCHES
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_qkv(q, k, v)
    if window and (not causal or D != WINDOW_HEAD_DIM):
        raise ValueError(f"flash kernel: a window needs causal attention at head dim {WINDOW_HEAD_DIM}")
    seg = _seg_arg(segment_ids, B, S, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr() if seg is not None else None,
            o.data_ptr(), lse.data_ptr(), B, S, H, KV, D, int(bool(causal)), float(scale))
    if window:
        err = lib.flash_fwd_window_bf16(*args, int(window), _stream(q))
    else:
        err = lib.flash_fwd_bf16(*args, _stream(q))
    if err:
        raise RuntimeError(f"flash kernel launch failed: {lib.flash_fwd_error_string(err).decode()}")
    LAUNCHES += 1
    return o, lse


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("flash_bwd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd_dq_bf16.argtypes = [p] * 8 + [i] * 6 + [f, p]
        lib.flash_bwd_dq_bf16.restype = i
        lib.flash_bwd_dkv_bf16.argtypes = [p] * 9 + [i] * 6 + [f, p]
        lib.flash_bwd_dkv_bf16.restype = i
        lib.flash_bwd_error_string.argtypes = [i]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _check_bwd(q, k, v, do, lse, delta):
    B, S, H, _ = q.shape
    _check_qkv(q, k, v)
    _check("do", do, torch.bfloat16, q.device)
    if do.shape != q.shape:
        raise ValueError(f"flash kernel: do shape {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(name, t, torch.float32, q.device)
        if t.shape != (B * H, S):
            raise ValueError(f"flash kernel: {name} shape {tuple(t.shape)} != {(B * H, S)}")


def _launch_bwd(entry, outs, q, k, v, do, lse, delta, segment_ids, causal, scale):
    """Checks the inputs and launches one backward kernel writing ``outs``."""
    _check_bwd(q, k, v, do, lse, delta)
    B, S, H, D = q.shape
    seg = _seg_arg(segment_ids, B, S, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _bwd_lib()
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        seg.data_ptr() if seg is not None else None, *(t.data_ptr() for t in outs),
        B, S, H, k.shape[2], D, int(bool(causal)), float(scale), _stream(q),
    )
    if err:
        raise RuntimeError(f"{entry} launch failed: {lib.flash_bwd_error_string(err).decode()}")


def flash_bwd_dq(q, k, v, do, lse, delta, segment_ids=None, causal=True, scale=None):
    """Launches kernel K3 on CUDA tensors: dq [B, S, H, D] bf16."""
    global BWD_DQ_LAUNCHES
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq_bf16", (dq,), q, k, v, do, lse, delta, segment_ids, causal, scale)
    BWD_DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, segment_ids=None, causal=True, scale=None):
    """Launches kernel K2 on CUDA tensors: (dk, dv) [B, S, KV, D] bf16, each
    summed over its kv head's group of q heads inside the kernel."""
    global BWD_DKV_LAUNCHES
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv_bf16", (dk, dv), q, k, v, do, lse, delta, segment_ids, causal, scale)
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, segment_ids=None, causal=True, scale=None):
    """The backward on the card: delta = rowsum(dO * O) in fp32 (a plain
    reduction, as in the TPU wrapper), then kernel K3, then kernel K2, on the
    current stream. dO may arrive non-contiguous (from the output
    projection's reshape); it is made contiguous bf16 here. Returns
    (dq, dk, dv) in bf16."""
    B, S, H, _ = q.shape
    do = do.to(torch.bfloat16).contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, segment_ids, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, segment_ids, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K3 + K2 backward (the TPU code's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        o, lse = flash_fwd(q, k, v, segment_ids=segment_ids, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, segment_ids=seg, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, segment_ids=None, window=0):
    """Flash attention. q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D].

    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors run kernel K1, and their gradient kernels K3 and K2. ``window``
    > 0 (a sliding layer: query i sees keys i - window < j <= i) is
    forward-only on the card: K3/K2 take no window, so a CUDA input that
    needs a gradient raises."""
    H, D = q.shape[2], q.shape[3]
    if H % k.shape[2]:
        raise ValueError(f"n_heads {H} not divisible by kv_heads {k.shape[2]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids, window=window)
    if window:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError("flash attention with a window has no backward: K3/K2 take no window yet")
        return flash_fwd(q, k, v, segment_ids=segment_ids, causal=causal, scale=scale, window=window)[0]
    return _FlashAttention.apply(q, k, v, segment_ids, causal, scale)
