"""Runtime environments (reference: ``ray_tpu/core/runtime_env.py`` over
python/ray/_private/runtime_env/): per-task/actor ``env_vars``,
``working_dir``, ``py_modules``, ``pip``, ``conda`` and ``container``.

Not ported yet (ROADMAP Queue 1 item 2: ``runtime_env``). What the runtime
needs to stay wired is here: the package namespace, the typed setup error the
submitter checks for, and entry points that raise a typed
``NotImplementedError`` naming the item. A task or actor given a
``runtime_env`` fails at submission; nothing is silently skipped.
"""
from __future__ import annotations

PKG_NS = "runtime_env_pkg"

_DEFERRED = "runtime_env is not ported yet (ROADMAP Queue 1 item 2: runtime_env)"


class RuntimeEnvSetupError(RuntimeError):
    """A DETERMINISTIC runtime-env materialization failure: the same spec
    fails identically on every retry, so submitters fail the queued tasks
    instead of retrying the lease forever."""


def package_runtime_env(core, renv: dict) -> dict:
    raise NotImplementedError(_DEFERRED)


async def materialize(spec: dict, cache_root: str, kv_get):
    raise NotImplementedError(_DEFERRED)


def container_spawn_command(container: dict, engine: str, env: dict, session_dir: str,
                            repo_root: str, cwd=None) -> list:
    raise NotImplementedError(_DEFERRED)
