"""@remote function decorator plumbing (reference:
python/ray/remote_function.py).
"""
from __future__ import annotations

import functools
from dataclasses import replace
from typing import Any

from ray_tpu_torch.core.task_spec import TaskOptions


class RemoteFunction:
    def __init__(self, fn, options: TaskOptions | None = None):
        self._fn = fn
        self._opts = options or TaskOptions()
        self._fn_id: str | None = None
        functools.update_wrapper(self, fn)

    def options(self, **kwargs) -> "RemoteFunction":
        new = _apply_options(self._opts, kwargs)
        clone = RemoteFunction(self._fn, new)
        clone._fn_id = self._fn_id
        return clone

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core import api

        core = api._require_worker()
        # Re-export if the session changed (new controller = fresh KV).
        if self._fn_id is None or getattr(self, "_fn_session", None) is not core:
            self._fn_id = core.export_callable("fn", self._fn)
            self._fn_session = core
            if not self._opts.name:
                # Human-readable name for the state index / `raytpu list
                # tasks` (the export key is a content hash). Set once on the
                # shared options object so its interned identity is stable.
                self._opts.name = getattr(self._fn, "__name__", "") or ""
        # Reuse the handle's options object (submit treats it as immutable):
        # a stable identity lets the wire layer intern it per connection and
        # ship lean per-call frames. Runtime-env packaging is cached on the
        # handle for the same reason — a fresh options object per call would
        # grow the intern maps unboundedly and defeat the lean frames.
        opts = self._opts
        if opts.runtime_env:
            packaged = getattr(self, "_packaged_opts", None)
            if packaged is None or getattr(self, "_pkg_session", None) is not core:
                from ray_tpu_torch.core.runtime_env import package_runtime_env

                packaged = replace(opts)
                packaged.runtime_env = package_runtime_env(core, opts.runtime_env)
                self._packaged_opts = packaged
                self._pkg_session = core
            opts = packaged
        refs = core.submit_task_sync(self._fn_id, args, kwargs, opts)
        if self._opts.num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if self._opts.num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {getattr(self._fn, '__name__', '?')}() cannot be called directly; use .remote()"
        )


def _apply_options(base: TaskOptions, kwargs: dict) -> TaskOptions:
    new = replace(base)
    for k, v in kwargs.items():
        if k == "placement_group":
            from ray_tpu_torch.core.placement_group import PlacementGroup
            from ray_tpu_torch.core.task_spec import SchedulingStrategy

            if isinstance(v, PlacementGroup):
                new.scheduling_strategy = SchedulingStrategy(
                    kind="PLACEMENT_GROUP", placement_group=v.id, bundle_index=kwargs.get("placement_group_bundle_index", -1)
                )
            continue
        if k == "placement_group_bundle_index":
            continue
        if not hasattr(new, k):
            raise TypeError(f"unknown option {k!r}")
        setattr(new, k, v)
    return new
