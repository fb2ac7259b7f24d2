"""Chaos plane: deterministic seeded fault injection + scenario runner.

Every fault site in the tree calls one gate — ``chaos.maybe_inject(site)``
— which is a single attribute load + ``None`` check when chaos is off and
consults the installed seeded :class:`FaultSchedule` when on. Same seed =>
identical per-rule injection sequence, so every chaos failure replays from
its logged ``(seed, schedule)`` pair. See ``ray_tpu_torch/chaos/plan.py`` for the
mechanism and ``sites.py`` for the site catalog. The reference's
invariant-checked scenario runner and its CLI (``scenarios.py``) are not
ported yet (ROADMAP Queue 1 item 2c: chaos/scenarios.py): ``python -m
ray_tpu_torch chaos`` parses the reference's arguments and raises.
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
    "the chaos scenario runner is not ported yet "
    "(ROADMAP Queue 1 item 2c: chaos/scenarios.py)"
)


def add_chaos_parser(sub) -> None:
    """The reference's `chaos` arguments; ``cmd_chaos`` raises until the
    scenario runner lands."""
    cp = sub.add_parser("chaos", help="seeded fault-injection scenario runner")
    csub = cp.add_subparsers(dest="chaos_cmd", required=True)
    crun = csub.add_parser("run", help="run one scenario in a fresh in-process cluster")
    crun.add_argument("scenario")
    crun.add_argument("--seed", type=int, default=0)
    crun.add_argument("--quick", action="store_true", help="smaller workloads")
    csub.add_parser("list", help="scenarios + the fault-site catalog")


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
