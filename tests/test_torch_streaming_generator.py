"""The port's streaming generators: the cases of
``tests/test_streaming_generator.py`` on a port cluster, plus torch tensors
as streamed returns (inline and through the store).

Streaming generator tasks/actor methods (reference: streaming generators,
ReportGeneratorItemReturns + TaskManager streaming returns)."""
import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@rt.remote(num_returns="streaming")
def count_to(n):
    for i in range(n):
        yield i * 10


@rt.remote(num_returns="streaming")
def big_blocks(n, nbytes):
    for i in range(n):
        yield np.full(nbytes // 8, i, dtype=np.int64)


@rt.remote(num_returns="streaming")
def explodes_midway():
    yield "ok-0"
    yield "ok-1"
    raise ValueError("stream blew up")


@rt.remote(num_returns="streaming")
def not_a_generator():
    return 7


@rt.remote
class Streamer:
    def gen(self, n):
        for i in range(n):
            yield f"item-{i}"

    async def agen(self, n):
        for i in range(n):
            yield i + 100


def test_task_streaming_basic():
    gen = count_to.remote(5)
    assert isinstance(gen, rt.ObjectRefGenerator)
    got = [rt.get(ref, timeout=60) for ref in gen]
    assert got == [0, 10, 20, 30, 40]


def test_task_streaming_incremental_consumption():
    """Items are consumable before the producer finishes (the point of
    streaming): the first ref resolves while later items are still being
    produced."""
    gen = count_to.remote(50)
    first = rt.get(next(gen), timeout=60)
    assert first == 0
    rest = [rt.get(r, timeout=60) for r in gen]
    assert rest == [i * 10 for i in range(1, 50)]


def test_task_streaming_large_items_via_shm():
    gen = big_blocks.remote(3, 1 << 20)  # 1MB blocks: over the inline cap
    vals = [rt.get(r, timeout=120) for r in gen]
    assert [int(v[0]) for v in vals] == [0, 1, 2]
    assert all(v.nbytes == 1 << 20 for v in vals)


@rt.remote(num_returns="streaming")
def big_tensor_blocks(n, nbytes):
    import torch

    for i in range(n):
        yield torch.full((nbytes // 2,), i, dtype=torch.bfloat16)


def test_task_streaming_large_torch_items_via_shm():
    """The torch case of test_task_streaming_large_items_via_shm: bf16
    tensors (out of band as a uint8 view) streamed through the store."""
    import torch

    gen = big_tensor_blocks.remote(3, 1 << 20)
    vals = [rt.get(r, timeout=120) for r in gen]
    assert all(v.dtype == torch.bfloat16 and v.numel() == 1 << 19 for v in vals)
    assert [float(v[0]) for v in vals] == [0.0, 1.0, 2.0]
    assert all(bool((v == i).all()) for i, v in enumerate(vals))


def test_task_streaming_error_after_items():
    gen = explodes_midway.remote()
    assert rt.get(next(gen), timeout=60) == "ok-0"
    assert rt.get(next(gen), timeout=60) == "ok-1"
    with pytest.raises(Exception, match="stream blew up"):
        next(gen)


def test_task_streaming_non_generator_is_an_error():
    gen = not_a_generator.remote()
    with pytest.raises(Exception, match="not a generator"):
        next(gen)


def test_actor_streaming_sync_method():
    a = Streamer.remote()
    gen = a.gen.options(num_returns="streaming").remote(4)
    assert [rt.get(r, timeout=60) for r in gen] == [f"item-{i}" for i in range(4)]


def test_actor_streaming_async_method():
    a = Streamer.remote()
    gen = a.agen.options(num_returns="streaming").remote(3)
    assert [rt.get(r, timeout=60) for r in gen] == [100, 101, 102]


def test_streaming_generator_empty():
    gen = count_to.remote(0)
    assert list(gen) == []


def test_streaming_backpressure_paces_producer():
    """generator_backpressure=2: the producer may run at most 2 items ahead
    of consumption."""
    import time

    @rt.remote(num_returns="streaming", generator_backpressure=2)
    def paced():
        for i in range(6):
            yield (i, time.time())

    gen = paced.remote()
    first_ref = next(gen)
    time.sleep(1.5)  # producer should stall at ~index 2 while we sit idle
    vals = [rt.get(first_ref, timeout=60)] + [rt.get(r, timeout=60) for r in gen]
    assert [v[0] for v in vals] == list(range(6))
    # Item 3+ must have been produced AFTER the consumer-side sleep started,
    # i.e. its timestamp is >= item0's + ~1.5s (unbounded streaming would
    # produce all 6 immediately).
    assert vals[5][1] - vals[0][1] > 1.0, "producer ran ahead despite backpressure"


def test_method_decorator_num_returns():
    @rt.remote
    class Declared:
        @rt.method(num_returns=2)
        def pair(self):
            return 1, 2

        @rt.method(num_returns="streaming")
        def stream(self):
            yield "a"
            yield "b"

    d = Declared.remote()
    r1, r2 = d.pair.remote()
    assert rt.get([r1, r2], timeout=60) == [1, 2]
    assert [rt.get(r, timeout=60) for r in d.stream.remote()] == ["a", "b"]


def _count_lines(path):
    try:
        with open(path) as f:
            return len(f.read().splitlines())
    except FileNotFoundError:
        return 0


def test_stream_close_cancels_task_producer(tmp_path):
    """gen.close() reaches the producing worker: the generator stops at its
    next yield instead of running to completion (reference: CancelTask
    applied to streaming generators)."""
    import time

    marker = str(tmp_path / "task_progress")

    @rt.remote(num_returns="streaming")
    def slow_stream(path, n):
        for i in range(n):
            with open(path, "a") as f:
                f.write(f"{i}\n")
            time.sleep(0.05)
            yield i

    gen = slow_stream.remote(marker, 200)
    assert rt.get(next(gen), timeout=60) == 0
    gen.close()
    time.sleep(1.0)
    settled = _count_lines(marker)
    assert settled < 100, f"producer ran on after close ({settled} items)"
    time.sleep(0.7)
    assert _count_lines(marker) == settled, "producer still running after close"


def test_stream_close_cancels_actor_producer(tmp_path):
    import time

    marker = str(tmp_path / "actor_progress")

    @rt.remote
    class Slow:
        def stream(self, path, n):
            for i in range(n):
                with open(path, "a") as f:
                    f.write(f"{i}\n")
                time.sleep(0.05)
                yield i

    a = Slow.remote()
    gen = a.stream.options(num_returns="streaming").remote(marker, 200)
    assert rt.get(next(gen), timeout=60) == 0
    gen.close()
    time.sleep(1.0)
    settled = _count_lines(marker)
    assert settled < 100, f"producer ran on after close ({settled} items)"
    time.sleep(0.7)
    assert _count_lines(marker) == settled, "producer still running after close"
    # The actor itself stays healthy and serves new calls.
    gen2 = a.stream.options(num_returns="streaming").remote(str(tmp_path / "p2"), 3)
    assert [rt.get(r, timeout=60) for r in gen2] == [0, 1, 2]


def test_stream_close_after_exhaustion_is_noop():
    gen = count_to.remote(3)
    assert [rt.get(r, timeout=60) for r in gen] == [0, 10, 20]
    gen.close()  # finished stream: nothing to cancel
