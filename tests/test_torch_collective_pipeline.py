"""The port's collective host API on port clusters: the cases of
``tests/test_collective_pipeline.py`` except the two that test
``ray_tpu.parallel``'s pipeline over a mesh (ROADMAP Queue 1 item 6), left
out: ``test_pipeline_matches_sequential`` and
``test_pipeline_single_stage_fallback``.

Collective host API + pipeline parallelism tests (8-dev CPU mesh)."""
import numpy as np
import pytest

import ray_tpu_torch as rt
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


def test_collective_ops(shared_ray):
    from ray_tpu_torch import collective as col

    @rt.remote
    class Rank:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def run(self):
            col.init_collective_group(self.world, self.rank, group_name="g1")
            out = {}
            out["allreduce"] = col.allreduce(np.full((4,), self.rank + 1.0), group_name="g1")
            out["bcast"] = col.broadcast(
                np.arange(3.0) if self.rank == 0 else None, src_rank=0, group_name="g1"
            )
            out["allgather"] = col.allgather(np.array([self.rank]), group_name="g1")
            out["rs"] = col.reducescatter(
                np.stack([np.full((2,), float(self.rank))] * self.world), group_name="g1"
            )
            col.barrier(group_name="g1")
            if self.rank == 0:
                col.send(np.array([42.0]), dst_rank=1, group_name="g1")
            if self.rank == 1:
                out["recv"] = col.recv(src_rank=0, group_name="g1")
            return out

    world = 3
    ranks = [Rank.options(max_concurrency=2).remote(i, world) for i in range(world)]
    outs = rt.get([r.run.remote() for r in ranks], timeout=120)
    np.testing.assert_allclose(outs[0]["allreduce"], np.full((4,), 6.0))  # 1+2+3
    for o in outs:
        np.testing.assert_allclose(o["bcast"], np.arange(3.0))
        assert [int(x) for x in o["allgather"]] == [0, 1, 2]
    # reducescatter: rank r gets sum over contributors of their r-th shard
    np.testing.assert_allclose(outs[1]["rs"], np.full((2,), 0.0 + 1.0 + 2.0))
    np.testing.assert_allclose(outs[1]["recv"], np.array([42.0]))
    from ray_tpu_torch.collective.collective import _GROUP_PREFIX

    rt.kill(rt.get_actor(_GROUP_PREFIX + "g1"))


def test_create_collective_group_declarative(shared_ray):
    from ray_tpu_torch import collective as col

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def compute(self):
            return col.allreduce(np.array([1.0]), group_name="decl").tolist()

    members = [Member.options(max_concurrency=2).remote() for _ in range(2)]
    col.create_collective_group(members, 2, [0, 1], group_name="decl")
    outs = rt.get([m.compute.remote() for m in members], timeout=60)
    assert outs == [[2.0], [2.0]]
    col.destroy_collective_group("decl")


def test_world_size_mismatch_raises(shared_ray):
    from ray_tpu_torch import collective as col

    col.init_collective_group(3, 0, group_name="ws")
    with pytest.raises(ValueError, match="world_size"):
        col.init_collective_group(2, 0, group_name="ws")
    col.destroy_collective_group("ws")


def test_gang_restart_gets_fresh_epoch(shared_ray):
    """A restarted gang (same name, same world) must not read mailboxes of a
    dead gang that died mid-collective."""
    from ray_tpu_torch import collective as col

    @rt.remote
    class Member(col.CollectiveActorMixin):
        def half_collective(self, rank):
            # Rank 0 contributes to allreduce round 0 but the round never
            # completes (rank 1 stays out) — simulates a gang dying
            # mid-collective with a 99 stranded in the epoch-1 mailbox.
            g = col.collective._group("gr")
            if rank == 0:
                box = rt.get(
                    g.actor.exchange.remote(
                        f"e{g.ensure_epoch()}:allreduce:0", rank, np.array([99.0]), 0.05
                    ),
                    timeout=30,
                )
                assert box is None, "half-collective must not complete"
            return True

        def full_collective(self):
            return col.allreduce(np.array([1.0]), group_name="gr").tolist()

    gang1 = [Member.options(max_concurrency=2).remote() for _ in range(2)]
    col.create_collective_group(gang1, 2, [0, 1], group_name="gr")
    rt.get([m.half_collective.remote(i) for i, m in enumerate(gang1)], timeout=60)
    for m in gang1:
        rt.kill(m)

    gang2 = [Member.options(max_concurrency=2).remote() for _ in range(2)]
    col.create_collective_group(gang2, 2, [0, 1], group_name="gr")
    outs = rt.get([m.full_collective.remote() for m in gang2], timeout=60)
    # With stale epoch-1 mailboxes the dead gang's 99s would leak in; the
    # fresh epoch must yield exactly 1+1.
    assert outs == [[2.0], [2.0]]
    col.destroy_collective_group("gr")
