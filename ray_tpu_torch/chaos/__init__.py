"""Chaos plane: deterministic seeded fault injection + scenario runner.

Every fault site in the tree calls one gate — ``chaos.maybe_inject(site)``
— which is a single attribute load + ``None`` check when chaos is off and
consults the installed seeded :class:`FaultSchedule` when on. Same seed =>
identical per-rule injection sequence, so every chaos failure replays from
its logged ``(seed, schedule)`` pair. See ``ray_tpu_torch/chaos/plan.py`` for the
mechanism, ``sites.py`` for the site catalog, ``scenarios.py`` for the
invariant-checked scenario runner (``python -m ray_tpu_torch chaos run ...``).
"""
from ray_tpu_torch.chaos.plan import (
    ChaosError,
    Fault,
    FaultRule,
    FaultSchedule,
    active,
    injection_log,
    install,
    install_from_json,
    log_dropped,
    maybe_inject,
    metrics_series,
    uninstall,
)
from ray_tpu_torch.chaos.sites import SITES, catalog


def add_chaos_parser(sub) -> None:
    """CLI hook (lazy: the scenario runner imports cluster machinery)."""
    from ray_tpu_torch.chaos.scenarios import add_chaos_parser as _add

    _add(sub)


def cmd_chaos(args) -> int:
    from ray_tpu_torch.chaos.scenarios import cmd_chaos as _cmd

    return _cmd(args)


__all__ = [
    "add_chaos_parser",
    "cmd_chaos",
    "ChaosError",
    "Fault",
    "FaultRule",
    "FaultSchedule",
    "SITES",
    "active",
    "catalog",
    "injection_log",
    "install",
    "install_from_json",
    "log_dropped",
    "maybe_inject",
    "metrics_series",
    "uninstall",
]
