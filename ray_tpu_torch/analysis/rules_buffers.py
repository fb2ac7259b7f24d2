"""counted-trims + counted-sheds + counted-transfers: nothing is discarded
— or shipped — silently.

counted-trims: every bounded eviction must increment a dropped/evicted
counter — the "no silent caps" rule (every silently-trimmed buffer
was eventually a debugging session; raytpu_events_dropped_total{where} and
the tasks_evicted/traces_evicted counters exist because data that vanishes
untallied reads as "never happened").

counted-sheds extends the same ethos to the QoS plane's REQUEST drops: any
code path that rejects or expires a request (a direct
``raise DeadlineExceeded(...)``, or a function implementing shedding — a
``shed`` name segment) must increment a ``*_shed``/``*_expired``/
``*_dropped`` counter in the same scope. An uncounted rejection is a user
request that vanished: under overload — exactly when you are debugging —
the metrics would claim traffic that never existed. The sanctioned pattern
is ``qos.raise_expired(hop)`` (which counts inside), so direct raises
outside ray_tpu_torch/qos/ are rare and must carry their own tally.

counted-transfers closes the same gap on the SEND side of the wire: any
function that moves bytes via a raw socket syscall (``os.sendfile``,
``sock.sendmsg``, ``loop.sock_sendall``/``sock_sendfile``) bypasses the
asyncio transport — and with it every place the byte counters normally
live. A new fast path that forgets its ``*bytes*`` counter silently
undercounts ``rpc.bytes``/``object.transfer.bytes``, and the dashboards
then claim traffic that never happened (the wire-speed campaign's vectored
sendmsg and fd->socket sendfile lanes are exactly such paths). Counted =
the same function increments a ``*bytes*``-named counter (``+=`` or
``.inc()``); helpers that a counting caller dispatches to carry a reasoned
per-line suppression.

Detected trim shapes:
  * slice deletes            ``del self.events[:trimmed]``
  * oldest-entry evictions   ``d.pop(next(iter(d)))``
  * bounded deques           ``deque(maxlen=N)`` or positional
                             ``deque(it, N)`` (append-side discards are
                             implicit, so the counter duty attaches to the
                             constructor's class)

A trim is counted when the same function (same class, for deques — the
discard happens far from the constructor) also increments a ``*_dropped``/
``*_evicted``-named counter (``+=`` or ``.inc()``).
"""
from __future__ import annotations

import ast

from ray_tpu_torch.analysis.engine import FileContext, Rule, dotted_name

_COUNTER_MARKERS = ("dropped", "evicted", "discard", "trimmed_total")


def _is_counter_name(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _COUNTER_MARKERS)


def _is_oldest_pop(node: ast.Call) -> bool:
    """``x.pop(next(iter(x)))`` — the evict-oldest dict idiom."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "pop"):
        return False
    if not node.args:
        return False
    a = node.args[0]
    return (
        isinstance(a, ast.Call)
        and isinstance(a.func, ast.Name)
        and a.func.id == "next"
        and a.args
        and isinstance(a.args[0], ast.Call)
        and isinstance(a.args[0].func, ast.Name)
        and a.args[0].func.id == "iter"
    )


def _span(node: ast.AST) -> tuple:
    return (node.lineno, getattr(node, "end_lineno", None) or node.lineno)


class _Region:
    __slots__ = ("node", "trims", "deques", "counted")

    def __init__(self, node):
        self.node = node
        self.trims: list = []  # ((line, end_line), what)
        self.deques: list = []  # (line, end_line) spans of deque(maxlen=...)
        self.counted = False


class CountedTrims(Rule):
    id = "counted-trims"
    explanation = (
        "bounded eviction with no dropped/evicted counter in the same "
        "function — silent data loss is undebuggable; tally what you discard"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._module = _Region(None)
        self._funcs: list = []
        self._classes: list = []

    # -- region helpers --------------------------------------------------
    def _mark_counted(self) -> None:
        if self._funcs:
            self._funcs[-1].counted = True
        # Deques resolve at class (or module) scope.
        (self._classes[-1] if self._classes else self._module).counted = True

    def _trim_region(self) -> "_Region":
        """Innermost enclosing region: function > class body > module."""
        if self._funcs:
            return self._funcs[-1]
        return self._classes[-1] if self._classes else self._module

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._funcs.append(_Region(node))
            return
        if isinstance(node, ast.ClassDef):
            self._classes.append(_Region(node))
            return
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            dn = dotted_name(node.target)
            if dn and _is_counter_name(dn.rsplit(".", 1)[-1]):
                self._mark_counted()
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                # `del x[:]` (no bounds) is a full clear/consume, not a
                # bounded eviction — only bounded slices are trims.
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Slice)
                    and (t.slice.lower is not None or t.slice.upper is not None)
                ):
                    self._trim_region().trims.append(
                        (_span(node), "slice delete")
                    )
            return
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else ""
        if attr == "inc":
            obj = dotted_name(fn.value) if isinstance(fn, ast.Attribute) else ""
            if _is_counter_name(obj):
                self._mark_counted()
            return
        if _is_oldest_pop(node):
            self._trim_region().trims.append((_span(node), "evict-oldest pop"))
            return
        name = attr or (fn.id if isinstance(fn, ast.Name) else "")
        if name == "deque":
            bounded = any(
                kw.arg == "maxlen" and not (
                    isinstance(kw.value, ast.Constant) and kw.value.value is None
                )
                for kw in node.keywords
            )
            # maxlen can also arrive positionally — deque(iterable, maxlen) —
            # which bounds the buffer exactly the same way (the shape the
            # streaming fast lane's bounded-buffer review turned up missing).
            if not bounded and len(node.args) >= 2:
                a = node.args[1]
                bounded = not (isinstance(a, ast.Constant) and a.value is None)
            if bounded:
                region = self._classes[-1] if self._classes else self._module
                region.deques.append(_span(node))

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and self._funcs:
            self._flush(self._funcs.pop(), ctx)
            return
        if isinstance(node, ast.ClassDef) and self._classes:
            self._flush(self._classes.pop(), ctx)

    def end_file(self, ctx: FileContext) -> None:
        self._flush(self._module, ctx)

    def _flush(self, region: "_Region", ctx: FileContext) -> None:
        if region.counted:
            return
        for span, what in region.trims:
            ctx.report(
                self,
                span,
                f"{what} with no dropped/evicted counter incremented in the "
                "same scope — silent caps hide data loss",
            )
        for span in region.deques:
            ctx.report(
                self,
                span,
                "deque(maxlen=...) discards silently on append — increment a "
                "*_dropped/*_evicted counter on the discard path (none found "
                "in this scope)",
            )


# ---------------------------------------------------------------------------
# counted-sheds
# ---------------------------------------------------------------------------

_SHED_COUNTER_MARKERS = ("shed", "expired", "dropped", "evicted", "rejected")


def _is_reject_tally_name(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _SHED_COUNTER_MARKERS)


def _implements_shedding(name: str) -> bool:
    """"shed" as an UNDERSCORE-DELIMITED segment — substring matching would
    drag in "finished"/"watershed"-shaped names."""
    return "shed" in name.lower().split("_")


class _ShedRegion:
    __slots__ = ("node", "sheds", "counted")

    def __init__(self, node):
        self.node = node
        self.sheds: list = []  # ((line, end_line), what)
        self.counted = False


class CountedSheds(Rule):
    id = "counted-sheds"
    explanation = (
        "request drop/reject path with no *_shed/*_expired/*_dropped counter "
        "in scope — an uncounted rejection is a request that silently vanished"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._module = _ShedRegion(None)
        self._funcs: list = []

    def _region(self) -> "_ShedRegion":
        return self._funcs[-1] if self._funcs else self._module

    def _mark_counted(self) -> None:
        self._region().counted = True

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            region = _ShedRegion(node)
            if _implements_shedding(node.name):
                # A function IMPLEMENTING shedding must tally what it sheds.
                region.sheds.append(
                    ((node.lineno, node.lineno), f"shed path {node.name}()")
                )
            self._funcs.append(region)
            return
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            dn = dotted_name(node.target)
            if dn and _is_reject_tally_name(dn.rsplit(".", 1)[-1]):
                self._mark_counted()
            return
        if isinstance(node, ast.Raise):
            exc = node.exc
            callee = ""
            if isinstance(exc, ast.Call):
                fn = exc.func
                callee = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else ""
                )
            if callee == "DeadlineExceeded":
                self._region().sheds.append((_span(node), "raise DeadlineExceeded"))
            return
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "inc":
                obj = dotted_name(fn.value)
                if _is_reject_tally_name(obj):
                    self._mark_counted()

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and self._funcs:
            self._flush(self._funcs.pop(), ctx)

    def end_file(self, ctx: FileContext) -> None:
        self._flush(self._module, ctx)

    def _flush(self, region: "_ShedRegion", ctx: FileContext) -> None:
        if region.counted:
            return
        for span, what in region.sheds:
            ctx.report(
                self,
                span,
                f"{what} with no shed/expired/dropped counter incremented in "
                "the same scope — count every rejected request (or go through "
                "qos.raise_expired, which does)",
            )


# ---------------------------------------------------------------------------
# counted-transfers
# ---------------------------------------------------------------------------

# Raw socket send syscalls that bypass the asyncio transport (and therefore
# every counter attached to the normal write path). Attribute names only:
# the receiver object varies (os, a socket, the event loop).
_TRANSFER_SYSCALLS = ("sendfile", "sendmsg", "sock_sendall", "sock_sendfile")


def _is_bytes_counter_name(name: str) -> bool:
    return "bytes" in name.lower()


class _TransferRegion:
    __slots__ = ("node", "sends", "counted")

    def __init__(self, node):
        self.node = node
        self.sends: list = []  # ((line, end_line), what)
        self.counted = False


class CountedTransfers(Rule):
    id = "counted-transfers"
    explanation = (
        "raw socket send syscall with no *bytes* counter incremented in the "
        "same function — transport-bypassing sends must keep the byte "
        "accounting honest"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._module = _TransferRegion(None)
        self._funcs: list = []

    def _region(self) -> "_TransferRegion":
        return self._funcs[-1] if self._funcs else self._module

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._funcs.append(_TransferRegion(node))
            return
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            dn = dotted_name(node.target)
            if dn and _is_bytes_counter_name(dn.rsplit(".", 1)[-1]):
                self._region().counted = True
            return
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return
        if fn.attr == "inc":
            if _is_bytes_counter_name(dotted_name(fn.value)):
                self._region().counted = True
            return
        if fn.attr in _TRANSFER_SYSCALLS:
            self._region().sends.append((_span(node), f"{fn.attr}()"))

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and self._funcs:
            self._flush(self._funcs.pop(), ctx)

    def end_file(self, ctx: FileContext) -> None:
        self._flush(self._module, ctx)

    def _flush(self, region: "_TransferRegion", ctx: FileContext) -> None:
        if region.counted:
            return
        for span, what in region.sends:
            ctx.report(
                self,
                span,
                f"{what} with no *bytes* counter incremented in the same "
                "function — a transport-bypassing send that skips the byte "
                "counters silently undercounts the wire",
            )
