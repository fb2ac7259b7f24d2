"""The port's ownership and borrower bookkeeping (``ray_tpu_torch.core``): the
cases of ``tests/test_ownership.py`` on a port cluster, plus a torch tensor
through the same borrower chain.

Distributed ownership / borrower-chain semantics (reference:
ReferenceCounter borrower bookkeeping, src/ray/core_worker/reference_counter.h
— the owner keeps an object alive while ANY transitive borrower holds a ref,
including borrowers that received the ref from another borrower, not from
the owner)."""
import gc
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _session():
    rt.init(num_cpus=3, object_store_memory=128 * 1024 * 1024)
    yield
    rt.shutdown()


@rt.remote
class Holder:
    def __init__(self):
        self.ref = None

    def stash(self, box):
        self.ref = box[0]
        return True

    def read(self):
        return float(rt.get(self.ref, timeout=60).sum())

    def drop(self):
        self.ref = None
        return True


@rt.remote
class Middleman:
    def __init__(self, box):
        self.r = box[0]

    def hand_over(self):
        return [self.r]  # the ref travels borrower -> borrower


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_borrower_chain_outlives_intermediate(payload):
    """driver -> A (borrower) -> B (borrower-of-borrower): after the driver
    drops its refs and A is killed, B must still resolve the value; the owner
    frees only when B drops too. The torch case puts a CPU tensor, whose
    bytes ride out of band."""
    if payload == "torch":
        import torch

        x = torch.ones(1 << 20, dtype=torch.float64)  # 8MB: shm object, not inline
    else:
        x = np.ones(1 << 20)  # 8MB: shm object, not inline
    ref = rt.put(x)
    a = Middleman.remote([ref])
    handed = rt.get(a.hand_over.remote(), timeout=60)[0]
    b = Holder.remote()
    rt.get(b.stash.remote([handed]), timeout=60)
    del ref, handed, x
    rt.kill(a)
    gc.collect()
    time.sleep(1.0)
    assert rt.get(b.read.remote(), timeout=60) == float(1 << 20)
    rt.get(b.drop.remote(), timeout=60)


def test_ref_in_container_not_resolved_bare_ref_is():
    """Top-level ObjectRef args resolve to values before the method runs;
    refs nested in containers pass through as refs (reference arg semantics)."""
    ref = rt.put(41)

    @rt.remote
    def probe(bare, boxed):
        return type(bare).__name__, type(boxed[0]).__name__

    bare_t, boxed_t = rt.get(probe.remote(ref, [ref]), timeout=60)
    assert bare_t == "int"
    assert boxed_t == "ObjectRef"
