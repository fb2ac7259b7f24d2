"""The port's streaming semantics under the batched generator-item fast
lane (serve's token path): the cases of ``tests/test_stream_batching.py`` on
a port session.

The executor ships generator yields through a bounded per-stream buffer
drained by a loop-side pump into ``generator_items`` BATCH frames
(worker._StreamShipper). These tests pin the contract that batching must
not change: order across batch boundaries, backpressure pause/resume with
batch-granular acks, mid-stream close cancelling the user generator exactly
once, single-item flush latency (TTFT path), and duplicate-index dedup when
a dropped batch frame rides the connection-loss retry (seeded chaos).
"""
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.core import worker as worker_mod


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


@rt.remote(num_returns="streaming")
def burst(n):
    for i in range(n):
        yield i


@rt.remote(num_returns="streaming")
def paced(n, delay):
    for i in range(n):
        if i and delay:
            time.sleep(delay)
        yield i


def test_order_preserved_across_batch_boundaries():
    """A producer faster than the pump forces multi-item batch frames; the
    consumer must still observe every index exactly once, in order."""
    worker_mod.stream_batch_stats(reset=True)
    got = [rt.get(ref, timeout=120) for ref in burst.remote(400)]
    assert got == list(range(400))
    hist = worker_mod.stream_batch_stats()
    assert sum(hist.values()) >= 1
    assert any(size > 1 for size in hist), (
        f"a 400-item burst never coalesced a batch frame: {hist}"
    )
    # The histogram also ships as a first-class metric via the reporter.
    from ray_tpu_torch.core import api as _api

    series = [r for r in _api._require_worker()._runtime_series()
              if r["name"] == "stream.batch.items"]
    assert series and series[0]["n"] == sum(hist.values())


def test_single_item_flushes_same_tick():
    """A lone item must not wait for batchmates: the first yield reaches the
    consumer while the producer is still sleeping toward its second (the
    TTFT contract of the serve/LLM token path)."""
    list(paced.remote(1, 0))  # warm: worker spawned, callable cached
    t0 = time.monotonic()
    gen = paced.remote(2, 1.2)
    first = rt.get(next(gen), timeout=60)
    t_first = time.monotonic() - t0
    rest = [rt.get(r, timeout=60) for r in gen]
    t_total = time.monotonic() - t0
    assert first == 0 and rest == [1]
    assert t_first < t_total - 0.8, (
        f"first item buffered behind the stream ({t_first:.2f}s vs {t_total:.2f}s total)"
    )


def test_backpressure_pauses_and_resumes_with_batch_acks(tmp_path):
    """generator_backpressure=2 under the batched lane: the producer stalls
    whenever it runs more than bp items ahead of ACKED consumption (acks are
    coalesced per consumed burst), and resumes as acks land."""
    stamp = str(tmp_path / "yields")
    bp = 2

    @rt.remote(num_returns="streaming", generator_backpressure=bp)
    def gated(path, n):
        for i in range(n):
            with open(path, "a") as f:
                f.write(f"{i} {time.time()}\n")
            yield i

    consumed_at = {}
    gen = gated.remote(stamp, 8)
    for ref in gen:
        i = rt.get(ref, timeout=60)
        consumed_at[i] = time.time()
        time.sleep(0.15)
    assert sorted(consumed_at) == list(range(8))
    produced_at = {}
    with open(stamp) as f:
        for line in f:
            i, ts = line.split()
            produced_at[int(i)] = float(ts)
    assert sorted(produced_at) == list(range(8)), "replay/duplicate yields"
    for i in range(bp + 2, 8):
        # The stamp for item i lands before put(i) — it is gated by put(i-1),
        # which needs the ack covering consumption of item i-bp-1 (small
        # slack for same-host clock granularity).
        gate = i - bp - 1
        assert produced_at[i] >= consumed_at[gate] - 0.05, (
            f"producer ran ahead of the ack window at item {i}: "
            f"produced {produced_at[i]:.3f} vs consumed[{gate}] {consumed_at[gate]:.3f}"
        )


def test_midstream_close_cancels_user_generator_exactly_once(tmp_path):
    """Consumer close mid-stream: the user generator's finally runs exactly
    once (cancellation reaches the producer; no double-close, no run-on)."""
    marker = str(tmp_path / "closes")

    @rt.remote(num_returns="streaming")
    def slow(path, n):
        try:
            for i in range(n):
                time.sleep(0.05)
                yield i
        finally:
            with open(path, "a") as f:
                f.write("CLOSED\n")

    gen = slow.remote(marker, 200)
    assert rt.get(next(gen), timeout=60) == 0
    gen.close()
    deadline = time.time() + 8
    while time.time() < deadline:
        try:
            with open(marker) as f:
                if f.read().count("CLOSED") >= 1:
                    break
        except FileNotFoundError:
            pass
        time.sleep(0.1)
    time.sleep(0.5)  # settle: catch a late double-close
    with open(marker) as f:
        closes = f.read().count("CLOSED")
    assert closes == 1, f"user generator closed {closes} times"


# The seeded dropped-batch-frame replay test needs a cluster armed with a
# chaos spec BEFORE the driver connects, so it lives in its own module
# (tests/test_torch_serve_stream_chaos.py) — rt.init here would shadow it.
