"""chaos-gate: every fault site goes through ``chaos.maybe_inject`` with a
literal, tree-wide-unique site name — and nothing outside ``ray_tpu_torch/chaos/``
branches on the chaos plane's state.

Why machine-enforced: the chaos subsystem's replay story ("same seed =>
same injection sequence") depends on the site catalog being the complete,
unambiguous map of where faults can strike. A dynamically-built site name
can't be cataloged or validated; a duplicated name makes two unrelated code
paths indistinguishable in schedules and logs; and an ad-hoc
``if chaos.active():`` branch around custom fault code bypasses the seeded
schedule entirely — the exact "irreproducible chaos" this subsystem exists
to kill.
"""
from __future__ import annotations

import ast

from ray_tpu_torch.analysis.engine import FileContext, Rule, dotted_name

# The chaos module's sanctioned surface for the rest of the tree. Everything
# else (active(), the plan internals, the injection log) is for the chaos
# package, its scenario runner, and tests.
_ALLOWED_ATTRS = frozenset({
    "maybe_inject",
    "install",
    "install_from_json",
    "uninstall",
    "metrics_series",
    "ChaosError",
    "Fault",
    "FaultRule",
    "FaultSchedule",
    "SITES",
    "catalog",
    "add_chaos_parser",
    "cmd_chaos",
})


def _in_chaos_pkg(path: str) -> bool:
    p = path.replace("\\", "/")
    return "/chaos/" in p or p.endswith("/chaos")


class ChaosGate(Rule):
    id = "chaos-gate"
    explanation = (
        "fault injection must go through chaos.maybe_inject with a literal, "
        "unique site name — no ad-hoc chaos branches"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._aliases: set = set()  # names bound to the chaos module in this file
        # Literal site names seen in THIS file only. Tree-wide uniqueness is
        # checked in phase 2 (rules_xfile.ChaosSiteUnique) over the project
        # index — cross-file state in a per-file rule would go blind the
        # moment the parse cache serves one of the two duplicated files.
        self._sites: set = set()

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ImportFrom):
            self._visit_import_from(node, ctx)
            return
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "ray_tpu_torch.chaos" and alias.asname:
                    self._aliases.add(alias.asname)
                # bare `import ray_tpu_torch.chaos` usage (ray_tpu_torch.chaos.x) is
                # caught by the dotted-name branch below
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, ctx)
            return
        if isinstance(node, ast.Attribute) and not _in_chaos_pkg(ctx.path):
            base = node.value
            if isinstance(base, ast.Name) and base.id in self._aliases:
                if node.attr not in _ALLOWED_ATTRS:
                    ctx.report(
                        self, node,
                        f"chaos.{node.attr} outside ray_tpu_torch/chaos/ — sites call "
                        "maybe_inject and apply the returned Fault; branching on "
                        "chaos internals bypasses the seeded schedule",
                    )
            elif (
                isinstance(base, ast.Attribute)
                and dotted_name(base) == "ray_tpu_torch.chaos"
                and node.attr not in _ALLOWED_ATTRS
            ):
                ctx.report(
                    self, node,
                    f"ray_tpu_torch.chaos.{node.attr} outside ray_tpu_torch/chaos/ — go "
                    "through the sanctioned gate surface",
                )

    def _visit_import_from(self, node: ast.ImportFrom, ctx: FileContext) -> None:
        mod = node.module or ""
        if mod == "ray_tpu_torch":
            for alias in node.names:
                if alias.name == "chaos":
                    self._aliases.add(alias.asname or "chaos")
            return
        if mod == "ray_tpu_torch.chaos" or mod.startswith("ray_tpu_torch.chaos."):
            if _in_chaos_pkg(ctx.path):
                return
            if mod != "ray_tpu_torch.chaos":
                ctx.report(
                    self, node,
                    f"importing chaos internals ({mod}) outside ray_tpu_torch/chaos/ "
                    "— the gate surface lives on the package itself",
                )
                return
            for alias in node.names:
                if alias.name not in _ALLOWED_ATTRS:
                    ctx.report(
                        self, node,
                        f"from ray_tpu_torch.chaos import {alias.name} outside "
                        "ray_tpu_torch/chaos/ — not part of the sanctioned gate surface",
                    )

    def _visit_call(self, node: ast.Call, ctx: FileContext) -> None:
        fn = node.func
        is_gate = (isinstance(fn, ast.Attribute) and fn.attr == "maybe_inject") or (
            isinstance(fn, ast.Name) and fn.id == "maybe_inject"
        )
        if not is_gate:
            return
        if not node.args or not (
            isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
        ):
            ctx.report(
                self, node,
                "maybe_inject site name must be a string literal — a computed "
                "name can't be cataloged, validated, or replayed",
            )
            return
        self._sites.add(node.args[0].value)

    def end_file(self, ctx: FileContext) -> None:
        if self._sites:
            ctx.stats.setdefault(self.id, {})["sites"] = sorted(self._sites)
