"""EQuARX-style int8 block quantization codec for ring collectives.

One hop's payload is ``[fp32 per-block absmax scales | int8 codes]``: the
tensor chunk is cut into fixed-size blocks, each block ships
``scale = absmax / 127`` plus its elements rounded to ``[-127, 127]``
(symmetric; -128 unused so negation is exact). Both sides compute the
payload length from ``(n_elements, block)`` alone, which is what lets the
receiver pre-register its raw-lane landing buffer before any byte arrives
(the zero-handshake ring pipeline depends on deterministic frame sizes).

Error contract (documented for the tolerance test gate): dequantized
element error is at most ``absmax_block / 254`` per quantize step (round
half-step of the code grid). A ring allreduce quantizes W-1 reduce-scatter
hops plus one allgather encode, so the final per-element absolute error is
bounded by ``W * max_partial_absmax / 254`` where ``max_partial_absmax`` is
the largest block absmax any partial sum reached — for sum-of-W inputs
that is at most ``W * absmax_input``, giving the loose-but-honest bound
``|err| <= W^2 * absmax_input / 254``. Relative to the fp32 result this is
a ~0.4% * W^2 worst case and far smaller in practice (EQuARX, arxiv
2506.17615, measures negligible quality loss at 2x wall-clock recovery).
"""
from __future__ import annotations

import numpy as np

# Scales travel as fp32 regardless of the tensor dtype: 4 bytes per block.
_SCALE_DTYPE = np.dtype("<f4")


def n_blocks(n: int, block: int) -> int:
    return (n + block - 1) // block


def quant_nbytes(n: int, block: int) -> int:
    """Wire size of one quantized chunk of ``n`` elements (scales + codes)."""
    return n_blocks(n, block) * _SCALE_DTYPE.itemsize + n


def quantize_into(x: np.ndarray, out: memoryview, block: int) -> None:
    """Encode fp32 ``x`` (1-D) into ``out`` (exactly quant_nbytes long)."""
    n = x.shape[0]
    nb = n_blocks(n, block)
    scales = np.frombuffer(out, dtype=_SCALE_DTYPE, count=nb)
    codes = np.frombuffer(out, dtype=np.int8, offset=nb * 4, count=n)
    if n == nb * block:
        blocks = x.reshape(nb, block)
        absmax = np.abs(blocks).max(axis=1)
    else:
        pad = np.zeros(nb * block, dtype=np.float32)
        pad[:n] = x
        blocks = pad.reshape(nb, block)
        absmax = np.abs(blocks).max(axis=1)
    np.divide(absmax, 127.0, out=scales)
    # A zero block quantizes to zeros with scale 0; divide by 1 to stay finite.
    inv = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    q = np.rint(blocks / inv[:, None])
    np.clip(q, -127, 127, out=q)
    codes[:] = q.reshape(-1)[:n].astype(np.int8)


def dequantize(buf: memoryview, n: int, block: int) -> np.ndarray:
    """Decode one quantized chunk back to fp32 (new array, length ``n``)."""
    nb = n_blocks(n, block)
    scales = np.frombuffer(buf, dtype=_SCALE_DTYPE, count=nb)
    codes = np.frombuffer(buf, dtype=np.int8, offset=nb * 4, count=n)
    if n == nb * block:
        out = codes.astype(np.float32).reshape(nb, block)
        out *= scales[:, None]
        return out.reshape(-1)
    pad = np.zeros(nb * block, dtype=np.float32)
    pad[:n] = codes.astype(np.float32)
    out = pad.reshape(nb, block)
    out *= scales[:, None]
    return out.reshape(-1)[:n].copy()


def max_abs_error_bound(world: int, absmax_input: float) -> float:
    """The documented worst-case per-element absolute error of a quantized
    ring allreduce (see module docstring) — the test gate asserts against
    this, so loosening it is an API change, not a test tweak."""
    return (world ** 2) * absmax_input / 254.0
