"""Job submission: supervisor actors running entrypoint subprocesses.

Role-equivalent to the reference's JobManager
(dashboard/modules/job/job_manager.py:61) + JobSupervisor
(job_supervisor.py:57): each submitted job gets a detached supervisor actor
that spawns the entrypoint as a subprocess, tees its output to a log file,
and records status transitions in the controller KV (so job state survives
the submitting client and is visible cluster-wide).
"""
from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Optional

JOB_NS = "job"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class _JobSupervisor:
    """Detached actor: owns one entrypoint subprocess."""

    def __init__(self, job_id: str, entrypoint: str, env: Optional[dict], log_path: str, controller_addr: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.log_path = log_path
        self._status = JobStatus.PENDING
        self._message = ""
        self._proc: Optional[subprocess.Popen] = None
        full_env = {**os.environ, **(env or {})}
        full_env["RAYTPU_ADDRESS"] = controller_addr  # entrypoint connects to this cluster
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        self._log_f = open(log_path, "wb")
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=full_env,
            stdout=self._log_f, stderr=subprocess.STDOUT,
        )
        self._status = JobStatus.RUNNING
        self._put_status()
        self._done = threading.Event()
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self):
        rc = self._proc.wait()
        self._log_f.flush()
        if self._status == JobStatus.STOPPED:
            pass
        elif rc == 0:
            self._status = JobStatus.SUCCEEDED
        else:
            self._status = JobStatus.FAILED
            self._message = f"entrypoint exited with code {rc}"
        self._put_status()
        self._done.set()

    def wait_finished(self, timeout_s: float = 300.0) -> str:
        """Server-side blocking wait (event-driven: set the moment the
        entrypoint exits) — clients make ONE call instead of polling status.
        Needs its own actor lane (the supervisor runs max_concurrency > 1)."""
        self._done.wait(timeout=timeout_s)
        return self._status

    def _put_status(self):
        from ray_tpu_torch.core import api

        core = api._require_worker()
        import json

        rec = json.dumps({
            "job_id": self.job_id,
            "status": self._status,
            "message": self._message,
            "entrypoint": self.entrypoint,
            "log_path": self.log_path,
            "ts": time.time(),
        }).encode()
        core._run(core.controller.call("kv_put", {"ns": JOB_NS, "key": self.job_id, "value": rec}))

    def status(self) -> str:
        return self._status

    def read_logs(self) -> str:
        """Logs read on the supervisor's own node (the log file is node-local;
        remote clients must come through this method)."""
        self._log_f.flush()
        try:
            with open(self.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop(self) -> bool:
        if self._proc and self._proc.poll() is None:
            self._status = JobStatus.STOPPED
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._put_status()
        return True


class JobSubmissionClient:
    """Submit/inspect jobs (reference: dashboard/modules/job/sdk.py)."""

    def __init__(self, log_dir: Optional[str] = None):
        import ray_tpu_torch as rt  # noqa: F401 — requires an initialized session

        self.log_dir = log_dir or os.path.join("/tmp", f"raytpu_jobs_{os.getpid()}")

    def submit_job(self, entrypoint: str, env: Optional[dict] = None, job_id: Optional[str] = None) -> str:
        import ray_tpu_torch as rt
        from ray_tpu_torch.core import api

        core = api._require_worker()
        job_id = job_id or f"raytpu-job-{os.urandom(4).hex()}"
        log_path = os.path.join(self.log_dir, f"{job_id}.log")
        sup = rt.remote(_JobSupervisor).options(
            name=f"__job_supervisor:{job_id}", namespace=JOB_NS, lifetime="detached",
            max_concurrency=4,  # wait_finished blocks a lane; status/logs keep flowing
        ).remote(job_id, entrypoint, env, log_path, core.controller_addr)
        # Surface constructor failures synchronously.
        rt.get(sup.status.remote(), timeout=60)
        return job_id

    def _kv(self, job_id: str) -> Optional[dict]:
        import json

        from ray_tpu_torch.core import api

        core = api._require_worker()
        raw = core._run(core.controller.call("kv_get", {"ns": JOB_NS, "key": job_id}))
        return None if raw is None else json.loads(raw)

    def get_job_status(self, job_id: str) -> Optional[str]:
        rec = self._kv(job_id)
        return None if rec is None else rec["status"]

    def get_job_info(self, job_id: str) -> Optional[dict]:
        return self._kv(job_id)

    def get_job_logs(self, job_id: str) -> str:
        """Logs via the supervisor actor when it is alive (the file lives on
        ITS node); falls back to the recorded path for finished jobs whose
        supervisor is gone and whose file is locally visible."""
        import ray_tpu_torch as rt

        try:
            sup = rt.get_actor(f"__job_supervisor:{job_id}", namespace=JOB_NS)
            return rt.get(sup.read_logs.remote(), timeout=30)
        except Exception:
            pass
        rec = self._kv(job_id)
        if rec is None:
            return ""
        try:
            with open(rec["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> list[dict]:
        from ray_tpu_torch.core import api

        core = api._require_worker()
        keys = core._run(core.controller.call("kv_keys", {"ns": JOB_NS, "prefix": ""}))
        return [rec for k in keys if (rec := self._kv(k)) is not None]

    def stop_job(self, job_id: str) -> bool:
        import ray_tpu_torch as rt

        try:
            sup = rt.get_actor(f"__job_supervisor:{job_id}", namespace=JOB_NS)
        except ValueError:
            return False
        return rt.get(sup.stop.remote(), timeout=30)

    def wait_until_finished(self, job_id: str, timeout_s: float = 300.0) -> str:
        import ray_tpu_torch as rt

        try:
            # Event-driven: ONE blocking call on the supervisor (set the
            # moment the entrypoint exits) instead of client-side polling.
            sup = rt.get_actor(f"__job_supervisor:{job_id}", namespace=JOB_NS)
            status = rt.get(sup.wait_finished.remote(timeout_s), timeout=timeout_s + 30)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return status
        except Exception:
            # Supervisor gone or died mid-wait (its job may still have
            # FINISHED — _put_status lands before exit): the terminal state
            # lives in the KV.
            status = self.get_job_status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return status
        raise TimeoutError(f"job {job_id} not finished after {timeout_s}s")
