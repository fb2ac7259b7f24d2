"""Tuner + TuneController: trial FSM over actors and placement groups.

Role-equivalent to the reference's Tuner (tune/tuner.py) and TuneController
(python/ray/tune/execution/tune_controller.py:68 — trial
state machine, actor-per-trial, PG-based resource booking). Trials run the
user function in a TrainWorker-style actor (thread + report queue); the
controller polls, feeds results to the scheduler, and applies decisions
(ASHA early-stop; PBT exploit/explore restarts).

``resources_per_trial`` is the trial actor's demand, so ``{"GPU": 0.5}``
books half a card, as a serve replica's ``num_gpus`` does. A trial given a
GPU share runs its function only where a CUDA device is visible: elsewhere
the trial fails with ``DeviceUnavailableError``; it never trains on the CPU
in the card's place.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.core.serialization import DeviceUnavailableError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.worker_group import TrainWorker, _fn_wants_config
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import CONTINUE, PERTURB, STOP, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import generate_variants


@dataclasses.dataclass
class TuneConfig:
    num_samples: int = 1
    metric: Optional[str] = None
    mode: str = "max"
    scheduler: Optional[TrialScheduler] = None
    # Pluggable search algorithm (ray_tpu_torch.tune.TPESearcher etc.); None =
    # grid/random variant generation from param_space (reference:
    # tune_config.search_alg -> Searcher).
    search_alg: Optional[Any] = None
    max_concurrent_trials: Optional[int] = None
    resources_per_trial: dict = dataclasses.field(default_factory=dict)
    seed: Optional[int] = None
    max_failures_per_trial: int = 0


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: dict
    metrics: dict
    metrics_history: list
    checkpoint: Optional[Checkpoint]
    best_checkpoint: Optional[Checkpoint]
    error: Optional[str]
    path: str

    @property
    def success(self) -> bool:
        return self.error is None


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (TuneConfig.metric or argument)")
        scored = [r for r in self._results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise ValueError(f"no successful trial reported metric {metric!r}")
        pick = max if mode == "max" else min
        return pick(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([
            {"trial_id": r.trial_id, **_flatten(r.config, "config"),
             **r.metrics}
            for r in self._results
        ])


def _flatten(d: dict, prefix: str) -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


class _OnGPU:
    """The trainable of a trial whose resources hold a GPU share: it checks,
    in the trial's process, that a CUDA device is visible before it runs."""

    def __init__(self, trainable: Callable):
        self.trainable = trainable

    def __call__(self, config: dict):
        import torch

        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "a trial given a GPU share (resources_per_trial) sees no CUDA device")
        if _fn_wants_config(self.trainable):
            return self.trainable(config)
        return self.trainable()


class Trial:
    """One configuration's lifecycle: PENDING -> RUNNING -> (PERTURBED ->
    RUNNING)* -> TERMINATED | ERRORED."""

    def __init__(self, trial_id: str, config: dict, storage_path: str,
                 resources: dict):
        self.trial_id = trial_id
        self.config = config
        self.path = storage_path
        self.resources = resources
        self.ckpt_manager = CheckpointManager(storage_path)
        self.state = "PENDING"
        self.actor = None
        self.pg = None
        self.metrics: dict = {}
        self.metrics_history: list[dict] = []
        self.iteration = 0
        self.error: Optional[str] = None
        self.failures = 0
        self.pbt_exploit: Optional[str] = None  # donor trial id (set by PBT)
        self.resume_path: Optional[str] = None

    def result(self) -> TrialResult:
        return TrialResult(
            trial_id=self.trial_id,
            config=self.config,
            metrics=self.metrics,
            metrics_history=self.metrics_history,
            checkpoint=self.ckpt_manager.latest,
            best_checkpoint=self.ckpt_manager.best,
            error=self.error,
            path=self.path,
        )


class TuneController:
    """Drives all trials to completion (reference: tune_controller.py:68).

    With a `searcher`, trials are created DYNAMICALLY (suggest() as capacity
    frees, so model-based searchers see completed results before proposing).
    Sweep state (trial configs/states/metrics + searcher observations) is
    checkpointed to `<storage>/tune_state.json` on every transition, so a
    controller restart resumes the sweep: finished trials keep their
    results, interrupted ones restart from their latest trial checkpoint
    (reference: the controller's experiment-state snapshots + Tuner.restore).
    """

    def __init__(self, trainable: Callable, trials: list[Trial],
                 tune_config: TuneConfig, poll_interval_s: float = 0.1,
                 searcher=None, storage: Optional[str] = None):
        self.trainable = trainable
        self.trials = trials
        self.cfg = tune_config
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.searcher = searcher
        self.storage = storage
        self.poll_interval_s = poll_interval_s
        self._by_id = {t.trial_id: t for t in trials}

    # -- sweep-state persistence -------------------------------------------
    def _state_file(self) -> Optional[str]:
        return os.path.join(self.storage, "tune_state.json") if self.storage else None

    def _save_sweep_state(self) -> None:
        path = self._state_file()
        if path is None:
            return
        import json

        state = {
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "state": t.state,
                    "iteration": t.iteration,
                    "metrics": t.metrics,
                    "metrics_history": t.metrics_history,
                    "error": t.error,
                    "path": t.path,
                    "resources": t.resources,
                }
                for t in self.trials
            ],
            "searcher": self.searcher.get_state() if self.searcher else None,
        }
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError):
            traceback.print_exc()  # unserializable config: sweep runs, resume degraded

    @staticmethod
    def load_sweep_state(storage: str) -> Optional[dict]:
        import json

        try:
            with open(os.path.join(storage, "tune_state.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _next_trial_id(self) -> str:
        return f"trial_{len(self.trials):05d}"

    def _maybe_create_trials(self, capacity_left: int) -> list[Trial]:
        """Dynamic trial creation from the searcher, bounded by num_samples
        and free capacity."""
        created: list[Trial] = []
        if self.searcher is None or self.storage is None:
            return created
        # Budget: num_samples, but a searcher carrying its OWN sample count
        # (BasicVariantGenerator.total) must not be silently truncated by the
        # config default of 1 — suggest()->None remains the hard stop.
        budget = max(self.cfg.num_samples, getattr(self.searcher, "total", 0))
        while capacity_left > 0 and len(self.trials) < budget:
            tid = self._next_trial_id()
            cfg = self.searcher.suggest(tid)
            if cfg is None:
                break
            trial = Trial(
                trial_id=tid,
                config=cfg,
                storage_path=os.path.join(self.storage, tid),
                resources=dict(self.cfg.resources_per_trial),
            )
            self.trials.append(trial)
            self._by_id[tid] = trial
            created.append(trial)
            capacity_left -= 1
        return created

    # -- lifecycle ---------------------------------------------------------
    def _try_start(self, trial: Trial) -> bool:
        res = dict(trial.resources) or {"CPU": 1.0}
        pg = rt.placement_group([res], strategy="PACK",
                                name=f"tune-{trial.trial_id}")
        if not pg.ready(timeout=2.0):
            rt.remove_placement_group(pg)
            return False
        worker_cls = rt.remote(TrainWorker)
        trial.pg = pg
        trial.actor = worker_cls.options(
            placement_group=pg, placement_group_bundle_index=0,
            resources=res, max_concurrency=4,
        ).remote(0, 1, trial.trial_id, trial.path)
        # Fire-and-forget: actor cold-start (worker spawn) must not serialize
        # trial launches. A failed start surfaces through the first poll.
        fn = _OnGPU(self.trainable) if res.get("GPU", 0) > 0 else self.trainable
        trial.actor.start.remote(fn, trial.config, trial.resume_path)
        trial.state = "RUNNING"
        return True

    def _teardown(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                rt.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        if trial.pg is not None:
            try:
                rt.remove_placement_group(trial.pg)
            except Exception:
                pass
            trial.pg = None

    # -- decisions ---------------------------------------------------------
    def _apply_perturb(self, trial: Trial) -> None:
        """PBT exploit/explore: clone donor checkpoint, mutate config,
        restart in place."""
        donor = self._by_id.get(trial.pbt_exploit or "")
        trial.pbt_exploit = None
        donor_ckpt = donor.ckpt_manager.latest if donor else None
        if donor is None or donor_ckpt is None:
            return  # nothing to exploit yet: keep running as-is
        self._teardown(trial)
        trial.config = self.scheduler.explore(dict(donor.config))
        trial.resume_path = donor_ckpt.path
        trial.state = "PENDING"  # restart via the normal scheduling path

    # -- main loop ---------------------------------------------------------
    def run(self) -> list[TrialResult]:
        cap = self.cfg.max_concurrent_trials or max(len(self.trials), 1)
        self._save_sweep_state()
        while True:
            running = [t for t in self.trials if t.state == "RUNNING"]
            pending = [t for t in self.trials if t.state == "PENDING"]
            pending += self._maybe_create_trials(cap - len(running) - len(pending))
            if not running and not pending:
                break  # nothing active and the searcher offered nothing new
            for trial in pending:
                if len(running) >= cap:
                    break
                try:
                    if self._try_start(trial):
                        running.append(trial)
                        self._save_sweep_state()
                    else:
                        break  # no capacity right now; retry next cycle
                except Exception:
                    trial.error = traceback.format_exc()
                    trial.state = "ERRORED"
                    self._teardown(trial)
                    self._save_sweep_state()
            made_progress = False
            for trial in list(running):
                made_progress |= self._poll_trial(trial)
            if not made_progress:
                time.sleep(self.poll_interval_s)
        self._save_sweep_state()
        return [t.result() for t in self.trials]

    def _poll_trial(self, trial: Trial) -> bool:
        try:
            status = rt.get(trial.actor.poll.remote(), timeout=60)
        except Exception as e:
            return self._on_trial_failed(trial, f"trial actor died: {e}")
        progressed = False
        decision = CONTINUE
        for rep in status["reports"]:
            progressed = True
            metrics = dict(rep["metrics"])
            trial.iteration += 1
            metrics.setdefault("training_iteration", trial.iteration)
            if rep.get("checkpoint_dir"):
                try:
                    trial.ckpt_manager.register(rep["checkpoint_dir"], metrics)
                except OSError:
                    traceback.print_exc()
            trial.metrics = metrics
            trial.metrics_history.append(metrics)
            if self.searcher is not None:
                self.searcher.on_trial_result(trial.trial_id, metrics)
            d = self.scheduler.on_trial_result(trial, metrics)
            if d != CONTINUE:
                decision = d
        if progressed:
            self._save_sweep_state()
        if decision == STOP:
            self._complete(trial)
            return True
        if decision == PERTURB:
            self._apply_perturb(trial)
            return True
        if status["error"]:
            return self._on_trial_failed(trial, status["error"])
        if status["finished"]:
            self._complete(trial)
            return True
        return progressed

    def _complete(self, trial: Trial) -> None:
        self._teardown(trial)
        trial.state = "TERMINATED"
        self.scheduler.on_trial_complete(trial, trial.metrics)
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id, trial.metrics)
        self._save_sweep_state()

    def _on_trial_failed(self, trial: Trial, err: str) -> bool:
        self._teardown(trial)
        trial.failures += 1
        if trial.failures > self.cfg.max_failures_per_trial:
            trial.error = err
            trial.state = "ERRORED"
            self.scheduler.on_trial_complete(trial, None)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, None)
        else:
            resume = trial.ckpt_manager.latest
            trial.resume_path = resume.path if resume else None
            trial.state = "PENDING"
        self._save_sweep_state()
        return True


class Tuner:
    """Public API (reference: tune/tuner.py Tuner.fit -> ResultGrid).

    ``resume=True`` restores a sweep from ``<storage>/tune_state.json``
    (reference: Tuner.restore): TERMINATED/ERRORED trials keep their
    recorded results without re-running; interrupted trials restart from
    their latest checkpoint; the searcher's observations are restored so
    model-based search continues where it stopped."""

    def __init__(self, trainable: Callable, *, param_space: dict,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None, resume: bool = False):
        from ray_tpu_torch.train.config import RunConfig

        self.trainable = trainable
        self.param_space = param_space
        self.cfg = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name="tune_run")
        self.resume = resume

    def _restored_trials(self, storage: str) -> Optional[list[Trial]]:
        state = TuneController.load_sweep_state(storage)
        if state is None:
            return None
        trials: list[Trial] = []
        for ts in state["trials"]:
            t = Trial(ts["trial_id"], ts["config"], ts["path"],
                      dict(ts.get("resources", {})))
            t.iteration = ts.get("iteration", 0)
            t.metrics = ts.get("metrics", {})
            t.metrics_history = ts.get("metrics_history", [])
            t.error = ts.get("error")
            if ts["state"] in ("TERMINATED", "ERRORED"):
                t.state = ts["state"]
            else:
                # Interrupted mid-flight: restart from the latest trial
                # checkpoint (the per-trial CheckpointManager reloads its
                # own persisted index).
                resume = t.ckpt_manager.latest
                t.resume_path = resume.path if resume else None
                t.state = "PENDING"
            trials.append(t)
        if self.cfg.search_alg is not None and state.get("searcher") is not None:
            self.cfg.search_alg.set_state(state["searcher"])
        return trials

    def fit(self) -> ResultGrid:
        if not rt.is_initialized():
            rt.init()
        storage = self.run_config.resolved_storage_path()
        trials: Optional[list[Trial]] = None
        if self.resume:
            trials = self._restored_trials(storage)
        if trials is None:
            if self.cfg.search_alg is not None:
                trials = []  # created dynamically by the controller
            else:
                configs = generate_variants(
                    self.param_space, self.cfg.num_samples, self.cfg.seed
                )
                trials = [
                    Trial(
                        trial_id=f"trial_{i:05d}",
                        config=cfg,
                        storage_path=os.path.join(storage, f"trial_{i:05d}"),
                        resources=dict(self.cfg.resources_per_trial),
                    )
                    for i, cfg in enumerate(configs)
                ]
        controller = TuneController(
            self.trainable, trials, self.cfg,
            searcher=self.cfg.search_alg, storage=storage,
        )
        results = controller.run()
        return ResultGrid(results, self.cfg.metric, self.cfg.mode)
