"""server.ttft_gap_ms: median over complete requests of the caller's time
to first token, from its call of generate_stream, minus the engine event's
own ttft_s (host clock): what the serving surface adds to the engine's stamp.
Requests in flight while the profiler ran are left out."""
from perfbench.metrics._counts import median


def read(rec):
    xs = rec.host.get("ttft_gap_s")
    return 1e3 * median(xs) if xs else None
