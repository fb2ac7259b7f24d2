"""Shard-rectangle intersection math + N→M redistribution planning.

This is the shared geometry core of two planes (arxiv 2112.01075's framing:
array redistribution as maximal contiguous byte runs between shard
rectangles):

* the checkpoint plane (``ckpt/restore.py``) maps the runs through chunk
  lists and ``pread``s byte ranges off disk;
* the elastic train plane (``elastic/transfer.py``) ships the same runs
  host-to-host over the raw-frame RPC lane against LIVE arrays — no disk
  round-trip.

``overlap_spans`` is exact, not heuristic: a run is contiguous in the
source buffer iff every dim right of its leading partial dim is fully
covered in BOTH rectangles, so runs are as long as the layouts allow and
never split a copy that could be one ``memcpy``.

``plan_pull`` adds the multi-source layer the live plane needs: given one
destination rectangle and MANY (possibly overlapping — replication is
legal) source rectangles, it assigns every destination byte to exactly one
source, preferring sources in the caller's order (self first, then rotated
across peers for load spread). The exact-once tiling is the invariant the
property test (tests/test_elastic.py) hammers with randomized layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional


def norm_index(index, shape) -> list[tuple[int, int]]:
    """Manifest/json index ([[start, stop], ...]) to tuples. An empty index
    means "the whole array"; a scalar array gets one 1-element dim so the
    span math is rank-uniform."""
    if not index:
        return [(0, int(d)) for d in shape] if shape else [(0, 1)]
    return [(int(a), int(b)) for a, b in index]


def _strides(extents: list[int]) -> list[int]:
    out = [1] * len(extents)
    for i in range(len(extents) - 2, -1, -1):
        out[i] = out[i + 1] * extents[i + 1]
    return out


def overlap_spans(src_index, dst_index, itemsize: int, shape=None):
    """Yield (src_byte_off, dst_byte_off, nbytes) runs copying the overlap
    of two index rectangles between their row-major region buffers."""
    src = norm_index(src_index, shape)
    dst = norm_index(dst_index, shape)
    over = [(max(s0, d0), min(s1, d1)) for (s0, s1), (d0, d1) in zip(src, dst)]
    if any(a >= b for a, b in over):
        return
    src_ext = [s1 - s0 for s0, s1 in src]
    dst_ext = [d1 - d0 for d0, d1 in dst]
    over_ext = [b - a for a, b in over]
    rank = len(over)
    # k = leading edge of the fully-covered suffix (full in BOTH regions).
    k = rank
    while k > 0 and over_ext[k - 1] == src_ext[k - 1] == dst_ext[k - 1]:
        k -= 1
    src_strides = _strides(src_ext)
    dst_strides = _strides(dst_ext)
    suffix = 1
    for j in range(k, rank):
        suffix *= over_ext[j]
    if k == 0:
        run = suffix * itemsize
        yield 0, 0, run
        return
    # Each emitted run covers dim k-1's overlap extent times the full
    # suffix; the outer dims' overlap coordinates are iterated one by one.
    run_elems = over_ext[k - 1] * suffix
    outer = over[:k - 1]
    counters = [a for a, _b in outer]
    while True:
        src_off = sum((c - s0) * st for c, (s0, _s1), st
                      in zip(counters, src[:k - 1], src_strides[:k - 1]))
        src_off += (over[k - 1][0] - src[k - 1][0]) * src_strides[k - 1]
        dst_off = sum((c - d0) * st for c, (d0, _d1), st
                      in zip(counters, dst[:k - 1], dst_strides[:k - 1]))
        dst_off += (over[k - 1][0] - dst[k - 1][0]) * dst_strides[k - 1]
        yield src_off * itemsize, dst_off * itemsize, run_elems * itemsize
        # odometer over the outer overlap rectangle
        i = len(outer) - 1
        while i >= 0:
            counters[i] += 1
            if counters[i] < outer[i][1]:
                break
            counters[i] = outer[i][0]
            i -= 1
        if i < 0:
            return


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def window_rect(n: int, world: int, rank: int) -> list[tuple[int, int]]:
    """Rank ``rank``'s 1-D shard window over a length-``n`` flat array under
    the ``ceil(n/world)`` partitioning (the grad_sync/ZeRO window rule,
    clipped to ``n`` — pad elements never ship). Trailing ranks past the
    array's end get an empty [n, n) rectangle."""
    shard = -(-n // world) if world > 0 else n
    lo = min(n, rank * shard)
    return [(lo, min(n, lo + shard))]


def rect_nbytes(rect: Iterable[tuple[int, int]], itemsize: int) -> int:
    total = itemsize
    for a, b in rect:
        total *= max(0, b - a)
    return total


# ---------------------------------------------------------------------------
# Multi-source pull planning (exact-once tiling)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Run:
    """One contiguous byte copy: [src_off, src_off+nbytes) of src_rank's
    region buffer into [dst_off, dst_off+nbytes) of the destination region
    buffer. Offsets are region-buffer-relative, exactly as overlap_spans
    emits them."""

    path: str
    src_rank: int
    src_off: int
    dst_off: int
    nbytes: int


class CoverageError(ValueError):
    """The offered source rectangles cannot tile the destination — failing
    loud beats handing back zeros-as-weights (same contract as the ckpt
    plane's fetch_region)."""


def plan_pull(path: str, shape, itemsize: int,
              src_rects: dict, dst_rect, prefer: Iterable[int],
              uncovered: Optional[list] = None) -> list[Run]:
    """Assign every byte of ``dst_rect``'s region buffer to exactly one
    source. ``src_rects``: {src_rank: rect}; ``prefer``: ranks in preference
    order (callers put self first, then rotate peers by their own rank so
    concurrent pullers spread load). Sources may overlap (replication);
    later sources only contribute bytes earlier ones didn't cover.

    ``uncovered``: destination byte intervals still needing coverage —
    None plans the whole region; a failover retry passes just the failed
    intervals (and an empty list plans nothing).

    Returns runs tiling the requested intervals exactly once; raises
    CoverageError when bytes remain uncovered."""
    dst_rect = norm_index(dst_rect, shape)
    total = rect_nbytes(dst_rect, itemsize)
    runs: list[Run] = []
    if total == 0:
        return runs
    if uncovered is None:
        uncovered = [(0, total)]
    else:
        uncovered = sorted((int(a), int(b)) for a, b in uncovered if b > a)
    for s in prefer:
        if not uncovered:
            break
        rect = src_rects.get(s)
        if rect is None:
            continue
        for src_off, dst_off, nbytes in overlap_spans(rect, dst_rect, itemsize, shape):
            lo, hi = dst_off, dst_off + nbytes
            nxt: list[tuple[int, int]] = []
            for a, b in uncovered:
                t0, t1 = max(a, lo), min(b, hi)
                if t0 >= t1:
                    nxt.append((a, b))
                    continue
                # A sub-interval of a span stays contiguous in BOTH buffers.
                runs.append(Run(path, s, src_off + (t0 - lo), t0, t1 - t0))
                if a < t0:
                    nxt.append((a, t0))
                if t1 < b:
                    nxt.append((t1, b))
            uncovered = nxt
    if uncovered:
        missing = sum(b - a for a, b in uncovered)
        raise CoverageError(
            f"{path}: {missing}/{total} destination bytes uncovered by the "
            f"offered sources (ranks {sorted(src_rects)})")
    runs.sort(key=lambda r: r.dst_off)
    return runs


def rotated(ranks: Iterable[int], start: int) -> list[int]:
    """Ranks rotated to begin at the first rank >= start (load-spread
    preference order for concurrent pullers)."""
    rs = sorted(ranks)
    if not rs:
        return rs
    i = 0
    while i < len(rs) and rs[i] < start:
        i += 1
    return rs[i:] + rs[:i]
