"""fsm-emitter: every task-lifecycle event kind worker.py emits must map to
the explicit per-attempt FSM in core/task_state.py.

Migrated from the ad-hoc AST scan that lived in tests/test_state_api.py:
an emitter added with an unmapped kind means someone extended the
event stream without deciding what it does to the controller's per-task
state index — the record would silently never fold. The rule also keeps the
coverage contract: the emitted lifecycle kinds must span every FSM state
(else `raytpu list tasks` can no longer observe a whole phase).
"""
from __future__ import annotations

import ast

from ray_tpu_torch.analysis.engine import FileContext, Rule

_EMITTERS = ("_event", "_task_event")


class FsmEmitter(Rule):
    id = "fsm-emitter"
    explanation = (
        "task-event kind is not mapped in core/task_state.py — decide its "
        "FSM transition (EVENT_STATE) or declare it NON_LIFECYCLE_KINDS"
    )

    def applies_to(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("core/worker.py")

    def begin_file(self, ctx: FileContext) -> None:
        self._kinds: dict = {}  # kind -> (line, end_line) of first emitter seen

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _EMITTERS):
            return
        if not node.args:
            return
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self._kinds.setdefault(
                arg.value,
                (node.lineno, getattr(node, "end_lineno", None) or node.lineno),
            )

    def end_file(self, ctx: FileContext) -> None:
        from ray_tpu_torch.core import task_state as ts

        ctx.stats[self.id] = {
            "emitters": len(self._kinds),
            "kinds": sorted(self._kinds),
        }
        known = set(ts.EVENT_STATE) | set(ts.NON_LIFECYCLE_KINDS)
        for kind in sorted(self._kinds):
            if kind not in known:
                ctx.report(
                    self,
                    self._kinds[kind],
                    f"event kind {kind!r} is not in task_state.EVENT_STATE or "
                    "NON_LIFECYCLE_KINDS — the state index would silently "
                    "ignore it",
                )
        # Coverage: the lifecycle kinds worker.py still emits must span the
        # FSM (FAILED may ride task_finished's status=error form).
        emitted_states = {
            ts.EVENT_STATE[k]
            for k in self._kinds
            if ts.EVENT_STATE.get(k) is not None
        }
        missing = (set(ts.STATES) - {ts.FAILED}) - emitted_states
        if self._kinds and missing:
            ctx.report(
                self,
                1,
                "worker.py no longer emits events for FSM states "
                f"{sorted(missing)} — the state index cannot observe them",
            )
        if self._kinds and not ({"task_failed", "task_finished"} & set(self._kinds)):
            ctx.report(
                self, 1, "worker.py emits no terminal (finished/failed) task event"
            )
