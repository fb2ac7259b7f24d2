"""The train plane's seams on the GPU: a checkpoint snapshot of a CUDA leaf
is a device copy that the next in-place update cannot tear, and a CUDA
tensor crosses a 2-rank ring allreduce and comes back on its own device.

Runs only where a CUDA device exists (``-m cuda``); elsewhere each test
skips with the reason. On the card, run with ``--noconftest`` (the repo
conftest imports jax).
"""
import numpy as np
import pytest
import torch

from _torch_runtime_fixtures import _aa_port_leak_sentinel  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the snapshot's device clone and the ring's "
                    "device-to-host crossing run only on the GPU")
    return torch.device("cuda", 0)


def test_snapshot_of_a_cuda_leaf_survives_an_in_place_update(dev, tmp_path):
    from ray_tpu_torch import ckpt
    from ray_tpu_torch.ckpt.saver import snapshot_tree
    from ray_tpu_torch.util.dtypes import host_array

    x = torch.randn(1 << 22, device=dev)
    w = torch.randn(1 << 20, device=dev).to(torch.bfloat16)
    want_x, want_w = x.cpu().numpy().copy(), w.cpu().view(torch.int16).numpy().copy()
    snap = snapshot_tree({"x": x, "w": w})
    x.add_(1.0)  # the next step, queued right behind the snapshot
    w.mul_(2.0)
    parked_x = snap["x"]["shards"][0][1]
    assert parked_x.is_cuda and parked_x.data_ptr() != x.data_ptr()
    assert np.array_equal(host_array(parked_x), want_x)
    assert np.array_equal(host_array(snap["w"]["shards"][0][1]).view(torch.int16).numpy(), want_w)

    # The same through the async saver: the device-to-host copy runs on the
    # writer thread while the step keeps updating the leaf in place.
    y = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    saver = ckpt.AsyncSaver(str(tmp_path))
    try:
        fut = saver.save_async(1, {"y": y})
        for _ in range(8):
            y.add_(1.0)
        m = fut.result(timeout=120)
    finally:
        saver.close()
    got = ckpt.restore(m, saver.chunks)["y"]
    assert np.array_equal(got, np.arange(1 << 20, dtype=np.float32))


def test_cuda_tensor_allreduce_comes_back_on_its_device(dev):
    import ray_tpu_torch as rt
    from ray_tpu_torch import collective as col

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def run(self, rank):
            import torch

            x = torch.full((1 << 16,), float(rank + 1), device="cuda")
            h = torch.full((4096,), float(rank + 1), device="cuda").to(torch.bfloat16)
            s = col.allreduce(x, group_name="cuda-ring")
            b = col.allreduce(h, group_name="cuda-ring")
            g = col.allgather(x[:8], group_name="cuda-ring")
            return (s.device.type, s.dtype == x.dtype, float(s.min()), float(s.max()),
                    b.device.type, b.dtype == torch.bfloat16, float(b[0]),
                    [t.device.type for t in g])

    rt.init(num_cpus=4, resources={"GPU": 1})
    try:
        members = [Member.options(max_concurrency=2).remote() for _ in range(2)]
        col.create_collective_group(members, 2, [0, 1], group_name="cuda-ring")
        outs = rt.get([m.run.remote(i) for i, m in enumerate(members)], timeout=180)
        col.destroy_collective_group("cuda-ring")
    finally:
        rt.shutdown()
    for out in outs:
        assert out == ("cuda", True, 3.0, 3.0, "cuda", True, 3.0, ["cuda", "cuda"]), out
