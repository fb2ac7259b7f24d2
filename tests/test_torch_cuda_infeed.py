"""``ray_tpu_torch.data.prefetch_to_device`` on the GPU: batches staged in
pinned memory and copied on a side stream arrive with every value equal to
a synchronous copy, however the consumer's stream is loaded.

Runs only where a CUDA device exists (``-m cuda``); elsewhere each test
skips with the reason. On the card, run with ``--noconftest`` (the repo
conftest imports jax).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N_BATCHES = 4
ELEMS = 16 << 20  # 64 MiB of fp32 per batch: each copy takes milliseconds


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the infeed's side-stream copies run only on the GPU")
    return torch.device("cuda", 0)


def _batches():
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal(ELEMS, dtype=np.float32), "step": np.int64(i)}
            for i in range(N_BATCHES)]


def _sync_copies(host, dev):
    want = [torch.from_numpy(b["x"]).to(dev) for b in host]
    torch.cuda.synchronize(dev)
    return want


def test_prefetch_equals_sync_copy_behind_a_busy_default_stream(dev):
    """A long kernel is queued on the default stream first; the infeed's
    copies run beside it on their own stream, and what the consumer reads on
    the default stream equals the synchronous copy in every value."""
    from ray_tpu_torch.data import prefetch_to_device

    host = _batches()
    want = _sync_copies(host, dev)
    torch.cuda._sleep(1 << 30)  # ~0.5 s of spinning on the default stream
    got = []
    for b in prefetch_to_device(iter(host), size=2, device=dev):
        assert b["x"].device == dev and b["step"].device == dev
        got.append((b["x"].clone(), b["step"].clone()))
    torch.cuda.synchronize(dev)
    assert [int(s) for _, s in got] == list(range(N_BATCHES))
    assert all(torch.equal(x, w) for (x, _), w in zip(got, want))


def test_prefetch_orders_the_copy_before_an_idle_consumer_stream(dev):
    """All four copies are in flight before the first batch is handed over,
    and the consumer reads each one at once on an idle stream of its own:
    the read waits for that batch's copy (wait_event), so every value
    equals the synchronous copy."""
    from ray_tpu_torch.data import prefetch_to_device

    host = _batches()
    want = _sync_copies(host, dev)
    consumer = torch.cuda.Stream(dev)
    got = []
    with torch.cuda.stream(consumer):
        for b in prefetch_to_device(iter(host), size=N_BATCHES, device=dev):
            got.append(b["x"].clone())
    torch.cuda.synchronize(dev)
    assert all(torch.equal(x, w) for x, w in zip(got, want))

