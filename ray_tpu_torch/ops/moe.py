"""Routed experts of a top-k MoE layer: the hand-written CUDA kernel K6
(``csrc/moe_gemm.cu``) and its plain PyTorch version.

``route`` is the router (a matmul, an fp32 softmax over the experts, the
top k, renormalised), in plain PyTorch on every device. ``moe_experts`` is
the wrapper of what follows: for CUDA tensors it launches K6 (the rows
sorted by expert on the device, a grouped SwiGLU GEMM per expert over its
rows, the weighted combine back to tokens) or raises; CPU tensors take
``moe_experts_reference``, the same algebra in plain PyTorch (fp32
products, the intermediate rounded to the input's type as the kernel
rounds it). Nothing on the CUDA path reads the device or makes a shape
from the routing, so the engine's decode graphs capture it.

K6 replaces no TPU kernel: the JAX package's MoE is the dense dispatch of
``models.transformer.moe_ffn`` (every expert on every token), which stays
the training path.
"""
from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

# Launches of K6's grouped GEMM kernel (two per call: gate-up, then down;
# incremented where they are launched, nowhere else).
LAUNCHES = 0
GEMM_LAUNCHES_PER_CALL = 2
TILE = 64  # the kernel's tile: hidden and expert widths must be multiples


def route(h, router, top_k: int):
    """h [T, D] against router [D, E] -> (weights [T, k] fp32, ids [T, k]
    int32): the router's product and the softmax over the experts in fp32,
    its top k renormalised. The product is taken in fp32 (bf16 inputs are
    exact there): logits rounded to bf16 would flip the near-ties at the
    k-th place that an fp32 reference does not."""
    logits = h.float() @ router.float()
    weights, ids = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    return weights / weights.sum(dim=-1, keepdim=True), ids.to(torch.int32)


def align_reference(ids, n_experts: int):
    """ids [T, k] -> (offsets [E + 1], sorted [T * k], counts [E]), int64:
    the flat (token, k) indices in expert order (stable), each expert's
    rows at offsets[e] .. offsets[e + 1]."""
    flat = ids.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.long, device=ids.device).scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return offsets, torch.argsort(flat, stable=True), counts


def moe_experts_reference(x, weights, ids, w_gate, w_up, w_down):
    """The experts' part of the layer, plain: x [T, D]; weights [T, k]
    fp32 and ids [T, k] from ``route``; w_gate/w_up [E, D, F], w_down
    [E, F, D] -> (y [T, D] in x's type, counts [E]). Each expert's rows
    (sorted by ``align_reference``) run through its SwiGLU in fp32, the
    intermediate rounded to x's type, the k rows of a token summed in fp32
    times their weights."""
    T, k = ids.shape
    E = w_gate.shape[0]
    offsets, order, counts = align_reference(ids, E)
    xs = x[order // k].float()
    y2 = torch.empty(T * k, x.shape[1], dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()  # host values: the CPU path only
    for e in range(E):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        rows = xs[a:b]
        h = (torch.nn.functional.silu(rows @ w_gate[e].float()) * (rows @ w_up[e].float())).to(x.dtype)
        y2[order[a:b]] = (h.float() @ w_down[e].float()).to(x.dtype)
    y = (y2.view(T, k, -1).float() * weights[..., None]).sum(dim=1)
    return y.to(x.dtype), counts


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_gemm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_ffn_bf16.argtypes = [p] * 12 + [i] * 5 + [p]
        lib.moe_ffn_bf16.restype = i
        lib.moe_gemm_error_string.argtypes = [i]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def moe_gemm(x, weights, ids, w_gate, w_up, w_down):
    """Launches K6 on CUDA tensors -> (y [T, D] bf16, counts [E] int32)."""
    global LAUNCHES
    T, k = ids.shape
    E, D, F = w_gate.shape
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe kernel: {name} must be a contiguous, 16-byte aligned bf16 CUDA tensor")
    if x.shape != (T, D) or w_up.shape != (E, D, F) or w_down.shape != (E, F, D):
        raise ValueError(f"moe kernel: shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} do not match")
    if D % TILE or F % TILE or E > 256:
        raise ValueError(f"moe kernel: hidden {D} and expert width {F} must be multiples of {TILE}, experts <= 256")
    dev = x.device
    ids = ids.to(torch.int32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    offsets = torch.empty(E + 1, dtype=torch.int32, device=dev)
    order = torch.empty(T * k, dtype=torch.int32, device=dev)
    counts = torch.empty(E, dtype=torch.int32, device=dev)
    h = torch.empty(T * k, F, dtype=torch.bfloat16, device=dev)
    y2 = torch.empty(T * k, D, dtype=torch.bfloat16, device=dev)
    y = torch.empty(T, D, dtype=torch.bfloat16, device=dev)
    lib = _lib()
    err = lib.moe_ffn_bf16(
        x.data_ptr(), ids.data_ptr(), weights.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        offsets.data_ptr(), order.data_ptr(), counts.data_ptr(), h.data_ptr(), y2.data_ptr(), y.data_ptr(),
        T, D, F, E, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"moe kernel launch failed: {lib.moe_gemm_error_string(err).decode()}")
    LAUNCHES += GEMM_LAUNCHES_PER_CALL
    return y, counts


def moe_experts(x, weights, ids, w_gate, w_up, w_down):
    """The routed experts of a top-k MoE layer. x [T, D]; weights [T, k]
    and ids [T, k] from ``route``; w_gate/w_up [E, D, F], w_down [E, F, D]
    -> (y [T, D], counts [E]: rows each expert received).

    CPU tensors take the plain version; CUDA tensors launch kernel K6."""
    if x.device.type == "cpu":
        return moe_experts_reference(x, weights, ids, w_gate, w_up, w_down)
    return moe_gemm(x, weights, ids, w_gate, w_up, w_down)


def moe_ffn(x, router, w_gate, w_up, w_down, top_k: int):
    """The layer's feed-forward: ``route``, then ``moe_experts``. x [..., D]
    -> (y [..., D], counts [E])."""
    flat = x.reshape(-1, x.shape[-1])
    weights, ids = route(flat, router, top_k)
    y, counts = moe_experts(flat, weights, ids, w_gate, w_up, w_down)
    return y.reshape(x.shape), counts
