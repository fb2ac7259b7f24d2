"""Async-runtime invariants: bug classes once fixed by hand.

bg-strong-ref      — asyncio holds tasks only WEAKLY: a bare
                     ``create_task``/``ensure_future`` whose Task object is
                     dropped can be GC-killed mid-await (GeneratorExit).
                     Observed repeatedly in this runtime: a lost init task
                     made drivers flake "failed to connect", orphaned rpc
                     dispatch tasks half-pulled objects. Every
                     fire-and-forget must route through util.bgtasks.spawn_bg
                     (or be awaited / retained / returned).
no-blocking-in-async — a synchronous sleep/subprocess/socket wait inside an
                     ``async def`` body stalls the whole event loop: every
                     connection serviced by that loop head-of-line blocks.
loop-thread-race   — an instance attribute mutated both on the event-loop
                     thread (async bodies) and on an executor thread
                     (``run_in_executor``/``to_thread`` targets) without a
                     lock is a data race; asyncio gives no memory-model
                     guarantees across those threads.
"""
from __future__ import annotations

import ast

from ray_tpu_torch.analysis.engine import FileContext, Rule, dotted_name

_SPAWNERS = frozenset(("create_task", "ensure_future"))


class BgStrongRef(Rule):
    id = "bg-strong-ref"
    explanation = (
        "fire-and-forget task object is dropped — asyncio tracks tasks "
        "weakly and a gc cycle can kill it mid-await; route through "
        "util.bgtasks.spawn_bg, await it, or retain the handle"
    )

    def begin_file(self, ctx: FileContext) -> None:
        # Per-enclosing-function state for the assigned-but-never-used
        # check: a local only pins the task while the FRAME lives, so
        # `t = create_task(...)` with no later use of `t` is the bare-Expr
        # bug wearing an alias (the local dies at return). A use counts
        # when it happens AFTER the assignment (line order) or inside a
        # nested def/lambda (closures defer execution past definition
        # order).
        self._funcs: list = []  # [{"loads", "nested_loads", "pending"}]

    @staticmethod
    def _enclosing_loops(node: ast.AST, ctx: FileContext) -> frozenset:
        """ids of the loops between ``node`` and its enclosing function — a
        handle assigned at the bottom of a loop and awaited at the TOP of
        the next iteration is used, despite the lines reading backwards."""
        loops = []
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                loops.append(id(anc))
        return frozenset(loops)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._funcs.append({"loads": [], "nested_loads": set(), "pending": []})
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if self._funcs:
                self._funcs[-1]["loads"].append(
                    (node.id, node.lineno, self._enclosing_loops(node, ctx))
                )
            for rec in self._funcs[:-1]:
                rec["nested_loads"].add(node.id)
            return
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        if name not in _SPAWNERS:
            return
        parent = ctx.parent(node)
        # The plainly dangerous shape: the call IS the whole statement, so
        # the returned Task has no referent at all. Awaited / attribute- or
        # registry-retained / returned / nested-in-a-call (gather, append)
        # keep a reference that outlives the spawning frame.
        if isinstance(parent, ast.Expr):
            ctx.report(self, node)
            return
        if not self._funcs:
            return
        # Assignment to simple locals — directly (`t = create_task(...)`) or
        # positionally through a tuple (`t, u = create_task(a), create_task(b)`)
        # — is only a retention if the local is actually used afterwards.
        assign = parent
        target: ast.AST | None = None
        if isinstance(parent, ast.Tuple):
            assign = ctx.parent(parent)
            if (
                isinstance(assign, ast.Assign)
                and assign.value is parent
                and len(assign.targets) == 1
                and isinstance(assign.targets[0], ast.Tuple)
                and len(assign.targets[0].elts) == len(parent.elts)
            ):
                target = assign.targets[0].elts[parent.elts.index(node)]
        elif isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = parent.targets[0]
        if isinstance(target, ast.Name):
            span = (
                assign.lineno,
                getattr(assign, "end_lineno", None) or assign.lineno,
            )
            self._funcs[-1]["pending"].append(
                (target.id, span, self._enclosing_loops(assign, ctx))
            )

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if not self._funcs:
            return
        rec = self._funcs.pop()
        for name, span, loops in rec["pending"]:
            used = name in rec["nested_loads"] or any(
                n == name and (line >= span[1] or (loops & load_loops))
                for n, line, load_loops in rec["loads"]
            )
            if not used:
                ctx.report(
                    self,
                    span,
                    f"task handle {name!r} is assigned but never used — the "
                    "local dies with the frame, leaving the task exactly as "
                    "GC-killable as a bare fire-and-forget",
                )


# Known-blocking callables by dotted name (curated: these are the ones this
# codebase actually reaches for; extend as new ones appear in review).
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the event loop; use `await asyncio.sleep(...)`",
    "subprocess.run": "subprocess.run blocks the event loop; use asyncio.create_subprocess_exec or run_in_executor",
    "subprocess.call": "subprocess.call blocks the event loop; use asyncio.create_subprocess_exec or run_in_executor",
    "subprocess.check_call": "subprocess.check_call blocks the event loop; use asyncio.create_subprocess_exec or run_in_executor",
    "subprocess.check_output": "subprocess.check_output blocks the event loop; use asyncio.create_subprocess_exec or run_in_executor",
    "os.system": "os.system blocks the event loop; use asyncio.create_subprocess_shell or run_in_executor",
    "socket.create_connection": "sync socket dial blocks the event loop; use asyncio.open_connection",
    "socket.getaddrinfo": "sync DNS resolution blocks the event loop; use loop.getaddrinfo",
    "socket.gethostbyname": "sync DNS resolution blocks the event loop; use loop.getaddrinfo",
}


class NoBlockingInAsync(Rule):
    id = "no-blocking-in-async"
    explanation = "blocking call inside an async def body stalls the event loop"

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, ast.Call) or not ctx.in_async_context():
            return
        dn = dotted_name(node.func)
        hit = _BLOCKING_CALLS.get(dn)
        # Strip a leading self./module alias: `self.time.sleep` never occurs,
        # but `from subprocess import run` as a bare name is out of scope —
        # the curated table keys on the idiomatic module-qualified spelling.
        if hit is not None:
            ctx.report(self, node, hit)
            return
        # concurrent.futures-style blocking wait: `.result(timeout)` /
        # `.result(timeout=...)`. A bare `.result()` on a DONE asyncio
        # future is legal and common, so only the timeout form (which
        # declares the intent to wait) fires.
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "result"
            and (node.args or any(k.arg == "timeout" for k in node.keywords))
        ):
            ctx.report(
                self,
                node,
                ".result(timeout=...) blocks the event-loop thread; await the "
                "future (or wrap in run_in_executor)",
            )


def _enclosing_with_is_lock(node: ast.AST, ctx: FileContext) -> bool:
    """True when any With/AsyncWith between ``node`` and its enclosing
    function manages a lock-ish object (dotted name contains 'lock' or
    'cond' — Condition objects guard like locks)."""
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                dn = dotted_name(item.context_expr).lower()
                if not dn and isinstance(item.context_expr, ast.Call):
                    dn = dotted_name(item.context_expr.func).lower()
                if "lock" in dn or "cond" in dn:
                    return True
    return False


class _ClassRecord:
    __slots__ = ("node", "loop_mut", "thread_mut", "executor_targets")

    def __init__(self, node: ast.ClassDef):
        self.node = node
        # attr -> line of first unguarded event-loop-side mutation.
        self.loop_mut: dict = {}
        # [(attr, (line, end_line), enclosing function-name chain)]
        self.thread_mut: list = []
        self.executor_targets: set = set()


class LoopThreadRace(Rule):
    """Heuristic: an instance attribute written both inside ``async def``
    bodies (event-loop thread) and inside a function handed to
    ``run_in_executor``/``asyncio.to_thread`` (worker thread) without a lock
    around either write."""

    id = "loop-thread-race"
    explanation = (
        "instance attribute mutated on both the event-loop thread and an "
        "executor thread without a lock"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._stack: list = []

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ClassDef):
            self._stack.append(_ClassRecord(node))
            return
        if not self._stack:
            return
        rec = self._stack[-1]
        if isinstance(node, ast.Call):
            self._record_executor_target(node, rec)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            attrs = [
                t.attr
                for t in targets
                if isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ]
            if not attrs or not ctx.func_stack:
                return
            # Function-name chain inside the current class (a nested def
            # dispatched to an executor mutates via closure: its own name is
            # what run_in_executor references; lambdas are anonymous).
            chain = tuple(getattr(f, "name", "<lambda>") for f in ctx.func_stack)
            if "__init__" in chain:
                return  # construction happens-before any thread
            if _enclosing_with_is_lock(node, ctx):
                return
            span = (node.lineno, getattr(node, "end_lineno", None) or node.lineno)
            if isinstance(ctx.func_stack[-1], ast.AsyncFunctionDef):
                for a in attrs:
                    rec.loop_mut.setdefault(a, node.lineno)
            else:
                for a in attrs:
                    rec.thread_mut.append((a, span, chain))

    @staticmethod
    def _record_executor_target(node: ast.Call, rec: "_ClassRecord") -> None:
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        if attr == "run_in_executor" and len(node.args) >= 2:
            target = node.args[1]
        elif attr == "to_thread" and node.args:
            target = node.args[0]
        else:
            return
        if isinstance(target, ast.Attribute):
            rec.executor_targets.add(target.attr)
        elif isinstance(target, ast.Name):
            rec.executor_targets.add(target.id)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, ast.ClassDef) or not self._stack:
            return
        rec = self._stack.pop()
        for attr, span, chain in rec.thread_mut:
            if attr not in rec.loop_mut:
                continue
            if any(name in rec.executor_targets for name in chain):
                ctx.report(
                    self,
                    span,
                    f"self.{attr} is mutated here on an executor thread and at "
                    f"line {rec.loop_mut[attr]} on the event-loop thread with "
                    "no lock — add a lock or confine the attribute to one "
                    "thread",
                )
