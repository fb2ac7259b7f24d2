"""ttft_p95_ms: 95th percentile, over every request due in the window, of
the time from its due time to its first token at the caller (host clock).
A missing request (failed, timed out, short) ranks above every other; if
the percentile falls on one, the value is the caller's wait limit."""
import math

from perfbench.metrics._counts import percentile


def read(rec):
    xs = rec.host.get("ttft_s")
    if not xs:
        return None
    p = percentile(xs, 95.0)
    return 1e3 * (rec.host["drain_limit_s"] if math.isinf(p) else p)
