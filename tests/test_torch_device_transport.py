"""torch.Tensor object transport in the port (``ray_tpu_torch/core/
serialization.py``), the counterpart of ``tests/test_device_transport.py``.

A dense tensor's raw bytes ride the protocol-5 out-of-band path as one
buffer (a uint8 view, so bf16 needs no numpy dtype), with dtype, shape and
``requires_grad`` in the pickle body; a restored tensor owns its memory (the
store's objects are shared by every reader, torch tensors are mutable). Two
byte parities hold the port to ``ray_tpu.core.serialization``: a numpy array
is framed identically, and a bf16 tensor's payload equals the bytes the
reference ships for the jax array of the same bits (in its pickle body:
numpy pickles an ml_dtypes array in band). The CUDA cases are marked
``cuda``.
"""
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.core import serialization as S


@pytest.fixture(scope="module")
def port_rt():
    rt.init(num_cpus=2)
    yield rt
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA tensor transport needs the GPU")
    return torch.device("cuda", 0)


def _seeded(dtype, shape=(64, 33)):
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32))
    if dtype == torch.bool:
        return x > 0
    if dtype == torch.int64:
        return (x * 1000).to(torch.int64)
    return x.to(dtype)


def _roundtrip(t):
    parts, refs, total = S.serialize_parts(t)
    assert total == sum(len(p) for p in parts)
    return S.deserialize(b"".join(bytes(p) for p in parts)), parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.bool])
def test_cpu_tensor_out_of_band(dtype):
    t = _seeded(dtype)
    y, parts = _roundtrip(t)
    # OOB layout: tag + count, then (length, payload) per buffer, then the body.
    assert bytes(parts[0]) == b"B" + (1).to_bytes(4, "little")
    nbytes = t.numel() * t.element_size()
    assert bytes(parts[1]) == nbytes.to_bytes(8, "little")
    assert bytes(parts[2]) == t.contiguous().view(torch.uint8).numpy().tobytes()
    assert len(parts) == 4 and len(parts[3]) < 512  # metadata only in the body
    assert type(y) is torch.Tensor and y.dtype == dtype and y.device.type == "cpu"
    assert y.shape == t.shape and torch.equal(y, t)


@pytest.mark.parametrize("case", ["scalar", "non_contiguous", "requires_grad", "parameter", "empty"])
def test_cpu_tensor_shapes_and_flags(case):
    base = _seeded(torch.float32, (8, 6))
    t = {
        "scalar": torch.tensor(3.25, dtype=torch.bfloat16),
        "non_contiguous": base.t()[::2],
        "requires_grad": base.clone().requires_grad_(True),
        "parameter": torch.nn.Parameter(base.clone()),
        "empty": torch.empty(0, 5, dtype=torch.bfloat16),
    }[case]
    y, _ = _roundtrip(t)
    assert type(y) is type(t)
    assert y.shape == t.shape and y.dtype == t.dtype
    assert y.requires_grad == t.requires_grad
    assert y.is_contiguous()
    assert torch.equal(y.detach(), t.detach())


def test_restored_cpu_tensor_owns_its_memory():
    t = _seeded(torch.bfloat16)
    data, _ = S.serialize(t)
    y = S.deserialize(data)
    y.add_(1)  # an in-place op must not reach the shared bytes
    assert torch.equal(S.deserialize(data), t)


def test_sparse_tensor_takes_torchs_own_reduce():
    t = _seeded(torch.float32, (6, 6)).relu().to_sparse()
    y, parts = _roundtrip(t)
    assert y.is_sparse and torch.equal(y.to_dense(), t.to_dense())


def test_cuda_tensor_without_a_cuda_device_raises(monkeypatch):
    """A tensor that lived on the card never lands on the CPU: restoring it
    where no CUDA device is visible raises the typed error naming it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = memoryview(np.arange(8, dtype=np.float32).tobytes())
    with pytest.raises(S.DeviceUnavailableError, match="cuda:0"):
        S._restore_tensor(raw, "float32", (8,), False, "cuda:0", False)


def test_tensors_and_refs_inside_containers(port_rt):
    inner = rt.put(_seeded(torch.int64, (4,)))
    value = {"ref": inner, "w": [_seeded(torch.bfloat16), _seeded(torch.float32, (3,))]}
    parts, refs, _ = S.serialize_parts(value)
    assert refs == [inner]
    assert bytes(parts[0]) == b"B" + (2).to_bytes(4, "little")
    got = S.deserialize(b"".join(bytes(p) for p in parts))
    assert got["ref"] == inner
    assert all(torch.equal(a, b) for a, b in zip(got["w"], value["w"]))


def test_tensor_through_the_object_store_and_a_task(port_rt):
    t = _seeded(torch.bfloat16, (1024, 1024))  # 2 MiB: the shared-memory path
    ref = rt.put(t)
    y = rt.get(ref, timeout=60)
    assert y.dtype == torch.bfloat16 and torch.equal(y, t)
    y.add_(1)  # the store's sealed copy is untouched
    assert torch.equal(rt.get(ref, timeout=60), t)

    @rt.remote
    def scale(a, b):
        return (a.float() * b).to(a.dtype), a.dtype, tuple(a.shape)

    out, dtype, shape = rt.get(scale.remote(ref, 2.0), timeout=120)
    assert dtype == torch.bfloat16 and shape == (1024, 1024)
    assert torch.equal(out, (t.float() * 2.0).to(torch.bfloat16))


def test_numpy_framing_matches_ray_tpu():
    from ray_tpu.core import serialization as R

    x = np.random.default_rng(1).standard_normal((300, 7)).astype(np.float32)
    value = {"x": x, "tag": "np", "n": 3}
    mine = b"".join(bytes(p) for p in S.serialize_parts(value)[0])
    ref = b"".join(bytes(p) for p in R.serialize_parts(value)[0])
    assert mine == ref


def test_bf16_payload_matches_ray_tpu_jax_array():
    import jax.numpy as jnp

    from ray_tpu.core import serialization as R

    bits = np.random.default_rng(2).integers(0, 1 << 16, size=(96, 40), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80  # no NaN/inf patterns: 1.0 instead
    ja = jnp.asarray(bits.view(jnp.bfloat16))
    tt = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    mine = S.serialize_parts(tt)[0]
    ref = b"".join(bytes(p) for p in R.serialize_parts(ja)[0])
    assert bytes(mine[0]) == b"B" + (1).to_bytes(4, "little")
    assert bytes(mine[2]) == bits.tobytes()
    # numpy pickles an ml_dtypes bf16 array in band, so the reference's frame
    # carries the same payload bytes inside its pickle body.
    assert ref[:1] == b"P" and bits.tobytes() in ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensor_roundtrip(dtype):
    dev = _cuda()
    t = _seeded(dtype, (512, 257)).to(dev)
    y, parts = _roundtrip(t)
    assert y.device.type == "cuda" and y.dtype == dtype
    assert torch.equal(y, t)


@pytest.mark.cuda
def test_cuda_tensor_through_the_object_store(port_rt):
    dev = _cuda()
    t = _seeded(torch.bfloat16, (1024, 1024)).to(dev)
    y = rt.get(rt.put(t), timeout=60)
    assert y.device.type == "cuda" and torch.equal(y, t)
