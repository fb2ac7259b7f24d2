"""Chaos plane: deterministic seeded fault injection + scenario runner.

Every fault site in the tree calls one gate — ``chaos.maybe_inject(site)``
— which is a single attribute load + ``None`` check when chaos is off and
consults the installed seeded :class:`FaultSchedule` when on. Same seed =>
identical per-rule injection sequence, so every chaos failure replays from
its logged ``(seed, schedule)`` pair. See ``ray_tpu_torch/chaos/plan.py`` for the
mechanism and ``sites.py`` for the site catalog. The reference's
invariant-checked scenario runner and its CLI (``scenarios.py``) are not
ported yet (ROADMAP Queue 1 item 2: the CLI, dashboard and job).
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


_CLI_DEFERRED = (
    "the chaos scenario runner and its CLI are not ported yet "
    "(ROADMAP Queue 1 item 2: the CLI, dashboard and job)"
)


def add_chaos_parser(sub) -> None:
    """CLI hook of the reference; the port has no CLI yet."""
    raise NotImplementedError(_CLI_DEFERRED)


def cmd_chaos(args) -> int:
    raise NotImplementedError(_CLI_DEFERRED)


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
