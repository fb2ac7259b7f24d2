"""ray_tpu_torch.job: job submission (reference: dashboard/modules/job —
JobManager job_manager.py:61 + per-job JobSupervisor actor running the
entrypoint as a subprocess, with status + logs retrievable by job id)."""
from ray_tpu_torch.job.manager import JobStatus, JobSubmissionClient

__all__ = ["JobStatus", "JobSubmissionClient"]
