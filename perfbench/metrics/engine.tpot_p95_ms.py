"""engine.tpot_p95_ms: 95th percentile over the window's complete requests
of (last token - first token) / (tokens - 1) at the caller (host clock): the
pace of the engine's decode blocks as a caller sees it, leaving out the
requests in flight while the profiler ran. A per-layer metric: its two sets
spread by more than half the largest bound allowed."""
from perfbench.metrics._counts import percentile


def read(rec):
    xs = rec.host.get("tpot_s")
    return 1e3 * percentile(xs, 95.0) if xs else None
