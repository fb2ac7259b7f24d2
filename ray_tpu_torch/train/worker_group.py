"""WorkerGroup: gang of train-worker actors pinned to placement-group bundles.

Role-equivalent to the reference's WorkerGroup
(python/ray/train/v2/_internal/execution/worker_group/
worker_group.py:104 — PG creation at :269, one actor per bundle at :376-391,
health barrier) plus the torch backend's rendezvous
(v2/torch/config.py `_TorchBackend.on_start`: rank-0 address broadcast then
``torch.distributed.init_process_group`` on every worker). A CPU gang, or a
gang of one process, skips the distributed init, as ``ray_tpu`` skips
``jax.distributed.initialize`` off the TPU.
"""
from __future__ import annotations

import os
import socket
import threading
import traceback
from typing import Any, Callable, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainSession, _set_session


class TrainWorker:
    """Actor hosting one rank of the SPMD gang; runs the user fn in a thread."""

    def __init__(self, world_rank: int, world_size: int, experiment_name: str,
                 storage_path: str):
        self.world_rank = world_rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self.session: Optional[TrainSession] = None
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None
        self.finished = False

    # -- rendezvous --------------------------------------------------------
    def get_address(self) -> dict:
        host = socket.gethostname()
        try:
            ip = socket.gethostbyname(host)
        except OSError:
            ip = "127.0.0.1"
        from ray_tpu_torch.core import api as _api

        core = _api._require_worker()
        # The coordinator port must be free on THIS host (rank 0 binds it);
        # picking it elsewhere (driver/controller) races other machines.
        # node_id/worker_addr: preemption-notice attribution + the elastic
        # plane's raw-lane transfer endpoint.
        return {"hostname": host, "ip": ip, "pid": os.getpid(),
                "free_port": _free_port(), "node_id": core.node_id,
                "worker_addr": core.address}

    def setup_distributed(self, coordinator_addr: str, num_processes: int,
                          process_id: int, use_gpu: bool) -> bool:
        """torch.distributed bootstrap (reference: _setup_torch_process_group,
        v2/torch/config.py). A GPU gang's worker that sees no CUDA device
        raises: it never trains on the CPU in its place. No-op when the gang
        is a single process or runs on the CPU.

        The group is NCCL, its rendezvous the TCP store at rank 0's
        ``get_address`` port. No ``device_id`` is passed, so the
        communicator is made lazily, at a first NCCL collective: ranks that
        share one card (``resources_per_worker={"GPU": 0.5}``) would be
        refused at an eager init ("Duplicate GPU detected"). Gradients move
        over the host ring (``train.grad_sync()``), never over NCCL."""
        os.environ["RAYTPU_COORDINATOR"] = coordinator_addr
        if not use_gpu:
            return True
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"train worker rank {process_id} was given a GPU bundle "
                "(ScalingConfig(use_gpu=True)) but sees no CUDA device")
        if num_processes <= 1:
            return True
        import torch.distributed as dist

        dist.init_process_group(
            "nccl", init_method=f"tcp://{coordinator_addr}",
            world_size=num_processes, rank=process_id)
        return True

    # -- training lifecycle ------------------------------------------------
    def start(self, train_fn: Callable, config: dict,
              resume_checkpoint_path: Optional[str] = None,
              dataset_shards: Optional[dict] = None,
              resume_live: Optional[dict] = None) -> bool:
        resume = Checkpoint(resume_checkpoint_path) if resume_checkpoint_path else None
        self.session = TrainSession(
            world_rank=self.world_rank,
            world_size=self.world_size,
            local_rank=0,
            experiment_name=self.experiment_name,
            storage_path=self.storage_path,
            resume_checkpoint=resume,
            dataset_shards=dataset_shards,
            resume_live=resume_live,
        )
        self.error = None
        self.finished = False

        def run():
            _set_session(self.session)
            try:
                if _fn_wants_config(train_fn):
                    train_fn(config)
                else:
                    train_fn()
            except BaseException:  # noqa: BLE001
                self.error = traceback.format_exc()
            finally:
                _teardown_distributed()
                self.finished = True
                _set_session(None)

        self.thread = threading.Thread(target=run, name="train_fn", daemon=True)
        self.thread.start()
        return True

    def poll(self) -> dict:
        reports = self.session.drain_reports() if self.session else []
        return {"reports": reports, "finished": self.finished, "error": self.error}

    def stop(self) -> bool:
        if self.session:
            self.session.stop_event.set()
        return True

    # -- elastic plane (live N->M reshard, ray_tpu_torch/elastic/) ---------------
    def reshard_export(self, tid: str) -> Optional[dict]:
        """Park this rank's last keep_live() snapshot for transfer ``tid``;
        returns the export's wire metadata (None when the fn never
        registered live state — the controller falls back to checkpoints)."""
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.elastic import transfer as _transfer

        snap = self.session.live_snapshot() if self.session else None
        if snap is None:
            return None
        # copy=False as in the reference; the port's export_state parks a
        # private host copy of every leaf all the same (torch state is
        # updated in place), here of the session's keep_live clones.
        meta = _transfer.export_state(
            tid, self.world_rank, snap["state"], snap["sharded"],
            seq=snap["seq"], meta=snap["meta"], copy=False)
        meta["addr"] = _api._require_worker().address
        return meta

    def reshard_pull(self, tid: str, sources: list, world: int, rank: int,
                     self_old_rank: Optional[int] = None) -> dict:
        """Assemble this worker's slice of the new gang's state from the
        gang's live exports (raw-lane pulls; own-export runs are local
        memcpys). The payload parks on the actor until restart_live()."""
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.elastic import transfer as _transfer

        core = _api._require_worker()
        res = core._run(
            _transfer.pull_state(core, tid, sources, world, rank,
                                 self_rank=self_old_rank),
            timeout=core.config.elastic_transfer_timeout_s * 4 + 10)
        self._resumed = res
        return res["stats"]

    def reshard_release(self, tid: str) -> bool:
        from ray_tpu_torch.elastic import transfer as _transfer

        return _transfer.release(tid)

    def restart_live(self, train_fn: Callable, config: dict, world_rank: int,
                     world_size: int,
                     dataset_shards: Optional[dict] = None) -> bool:
        """Resume the train fn on the resized gang: adopt the (possibly
        changed) rank/world, hand the fn the resharded payload via
        train.live_resume(), and leave checkpoints out of the loop."""
        resumed = getattr(self, "_resumed", None)
        self._resumed = None
        self.world_rank = world_rank
        self.world_size = world_size
        return self.start(train_fn, config, None, dataset_shards,
                          resume_live=resumed)


def _teardown_distributed() -> None:
    """Destroy this process's torch.distributed group, if setup_distributed
    made one (the train fn has ended)."""
    import sys

    if "torch.distributed" not in sys.modules:
        return
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _fn_wants_config(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    return len(sig.parameters) >= 1


class WorkerGroup:
    """Creates the PG + actors; knows how to poll and tear down the gang.

    ``gang_pg=False`` (the elastic-live mode) schedules workers by plain
    resources instead of one N-bundle placement group: a live resize keeps
    surviving actors and adds/drops members, which a fixed-bundle PG cannot
    express — elastic gangs trade strict gang placement for resize-in-place.
    """

    def __init__(self, scaling: ScalingConfig, experiment_name: str,
                 storage_path: str, gang_pg: bool = True):
        self.scaling = scaling
        self.experiment_name = experiment_name
        self.storage_path = storage_path
        self.gang_pg = gang_pg
        self.pg = None
        self.workers: list = []
        self.node_ids: list = []  # parallel to workers (preemption matching)
        self._split_coordinators: list = []

    def _spawn(self, rank: int, n: int):
        res = self.scaling.worker_resources()
        worker_cls = rt.remote(TrainWorker)
        opts: dict = {"resources": dict(res),
                      "max_concurrency": 4}  # poll/stop can't block start()
        if self.pg is not None:
            opts.update(placement_group=self.pg,
                        placement_group_bundle_index=rank)
        return worker_cls.options(**opts).remote(
            rank, n, self.experiment_name, self.storage_path)

    def start(self) -> None:
        n = self.scaling.num_workers
        res = self.scaling.worker_resources()
        if self.gang_pg:
            bundles = [dict(res) for _ in range(n)]
            self.pg = rt.placement_group(
                bundles, strategy=self.scaling.placement_strategy,
                name=f"{self.experiment_name}-gang",
            )
            if not self.pg.ready(timeout=60.0):
                raise TimeoutError(
                    f"placement group for {n} train workers not schedulable: {bundles}"
                )
        self.workers = [self._spawn(i, n) for i in range(n)]
        # Health barrier + rendezvous.
        addrs = rt.get([w.get_address.remote() for w in self.workers], timeout=60)
        self.node_ids = [a.get("node_id", "") for a in addrs]
        coordinator = f"{addrs[0]['ip']}:{addrs[0]['free_port']}"
        rt.get(
            [
                w.setup_distributed.remote(
                    coordinator, n, i, self.scaling.use_gpu
                )
                for i, w in enumerate(self.workers)
            ],
            timeout=120,
        )

    def make_shards(self, datasets: Optional[dict], n: int) -> list[dict]:
        """Fresh streaming splits per gang incarnation (and per live
        resize): a restarted/resized gang must not consume a half-drained
        epoch from the previous one (reference: DataConfig.configure runs
        per worker-group start). The PREVIOUS incarnation's split
        coordinators die here — a long-lived elastic job resizes in place
        without ever reaching shutdown(), and keeping one coordinator per
        dataset per resize alive would leak them for the run's lifetime."""
        for coord in self._split_coordinators:
            try:
                rt.kill(coord)
            except Exception:
                pass
        self._split_coordinators = []
        shards_per_worker: list[dict] = [{} for _ in range(n)]
        for ds_name, ds in (datasets or {}).items():
            iterators = ds.streaming_split(n)
            # Coordinator actors die with the gang (shutdown), not the cluster.
            self._split_coordinators.append(iterators[0]._coord)
            for i, it in enumerate(iterators):
                shards_per_worker[i][ds_name] = it
        return shards_per_worker

    def run(self, train_fn: Callable, config: dict,
            resume_checkpoint_path: Optional[str] = None,
            datasets: Optional[dict] = None) -> None:
        shards_per_worker = self.make_shards(datasets, len(self.workers))
        rt.get(
            [
                w.start.remote(train_fn, config, resume_checkpoint_path,
                               shards_per_worker[i])
                for i, w in enumerate(self.workers)
            ],
            timeout=60,
        )

    def poll(self) -> list[dict]:
        # Per-worker gets: a dead rank must not mask the survivors' reports
        # (rank 0's checkpoints especially — they are the restart point).
        refs = [w.poll.remote() for w in self.workers]
        out = []
        for i, r in enumerate(refs):
            try:
                out.append(rt.get(r, timeout=60))
            except Exception as e:
                out.append(
                    {"reports": [], "finished": False,
                     "error": f"worker {i} died: {e}"}
                )
        return out

    def stop_all(self) -> None:
        """Graceful stop: set every rank's stop event (its next report()
        raises, ending the train thread) — used by elastic resize so final
        checkpoints drain before teardown."""
        refs = [w.stop.remote() for w in self.workers]
        for r in refs:
            try:
                rt.get(r, timeout=10)
            except Exception:
                pass

    def spawn_extra(self, k: int) -> list:
        """Fresh member actors for a live grow (ranks assigned later by
        restart_live). Only valid without a gang PG — a fixed-bundle PG
        cannot grow."""
        if self.pg is not None:
            raise RuntimeError("cannot grow a PG-pinned gang in place")
        spawned = [self._spawn(len(self.workers) + i, len(self.workers) + k)
                   for i in range(k)]
        try:
            addrs = rt.get([w.get_address.remote() for w in spawned], timeout=60)
        except Exception:
            # A failed health barrier must not orphan the actors: they are
            # not yet in self.workers, so nothing else would ever kill
            # them, and their reservations would starve the fallback gang.
            for w in spawned:
                try:
                    rt.kill(w)
                except Exception:
                    pass
            raise
        self.workers += spawned
        self.node_ids += [a.get("node_id", "") for a in addrs]
        return spawned

    def adopt(self, workers: list, node_ids: list) -> None:
        """Live resize membership swap: ``workers`` (old-rank order becomes
        new-rank order) stay; every other current member is killed."""
        keep = {id(w) for w in workers}
        for w in self.workers:
            if id(w) not in keep:
                try:
                    rt.kill(w)
                except Exception:
                    pass
        self.workers = list(workers)
        self.node_ids = list(node_ids)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
        self.workers = []
        for coord in self._split_coordinators:
            try:
                rt.kill(coord)
            except Exception:
                pass
        self._split_coordinators = []
        if self.pg is not None:
            try:
                rt.remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
