"""Project index: the phase-1 fold that makes graftlint whole-program.

Per-file rule visitors catch single-file invariants; every recurring bug
class that survived them (the ``get_config()`` vs adopted
``core.config`` pair, dead RPC verbs, dashboard metrics that no
process emits, lanes that forget to propagate trace/QoS ctx) is a
*cross-file* contract violation. This module collects the facts those
contracts are written over — one JSON-able contribution per file, folded
into a :class:`ProjectIndex` the phase-2 rules (rules_xfile.py) check.

The collector rides the engine's single DFS walk as a pseudo-rule, so
indexing costs no extra parse. Contributions are plain dicts on purpose:
they serialize into the parse cache, which is what lets an unchanged file
skip re-parsing while still feeding the whole-program phase.
"""
from __future__ import annotations

import ast
import re
from typing import Optional

from ray_tpu_torch.analysis.engine import FileContext, Rule, dotted_name

# RPC send forms: Connection.call/notify/notify_soon/call_start(verb, payload).
SEND_METHODS = frozenset({"call", "notify", "notify_soon", "call_start"})
_METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram"})
_METRIC_KINDS = frozenset({"counter", "gauge", "histogram"})
_CTX_KEYS = ("tc", "qc")

_VERB_RE = re.compile(r"^[a-z][a-z0-9_]{1,39}$")
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")
# Dotted tokens whose leaf is a file extension are paths, not metric names
# ("rpc.py" in a stack-attribution table must not read as a metric ref).
_EXT_DENY = frozenset({
    "py", "md", "json", "jsonl", "txt", "yaml", "yml", "sh", "log", "html",
    "cfg", "toml", "gz", "csv",
})


def _is_metric_name(s: str) -> bool:
    return bool(
        isinstance(s, str)
        and _METRIC_NAME_RE.match(s)
        and s.rsplit(".", 1)[-1] not in _EXT_DENY
    )


def empty_contribution() -> dict:
    return {
        "sends": [],
        "handlers": [],
        "handler_refs": [],
        "strings": [],
        "metric_emits": [],
        "metric_refs": [],
        "config_reads": [],
        "kind_f": [],
        "chaos_sites": [],
    }


def _payload_info(call: ast.Call, ctx: FileContext) -> dict:
    """Resolve the ctx-key surface of a send site's payload argument.

    Inline dict literals are read directly. A payload *variable* is resolved
    against the enclosing function: dict-literal assignments to that name
    contribute their keys, and ``payload["tc"] = ...`` subscript stores count
    as set even when conditional — a sender that sets tc only when a trace is
    active still honors the contract. Anything else is ``opaque`` (a payload
    built elsewhere); the ctx rule does not guess about those.
    """
    keys: set = set()
    lean = False
    spec = False
    if len(call.args) < 2:
        return {"keys": [], "lean": False, "spec": False, "opaque": False,
                "empty": True}
    p = call.args[1]

    def eat_key(value) -> None:
        nonlocal lean, spec
        if value in _CTX_KEYS:
            keys.add(value)
        elif value == "lean":
            lean = True
        elif value == "spec":
            # A full TaskSpec carries trace_ctx/qos_ctx inside itself — the
            # ctx contract only bites payloads that strip the spec away.
            spec = True

    def eat_dict(d: ast.Dict) -> None:
        for k in d.keys:
            if isinstance(k, ast.Constant):
                eat_key(k.value)

    if isinstance(p, ast.Dict):
        eat_dict(p)
        return {"keys": sorted(keys), "lean": lean, "spec": spec,
                "opaque": False, "empty": False}
    if isinstance(p, ast.Name):
        scope = ctx.func_stack[-1] if ctx.func_stack else ctx.tree
        resolved = False
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict):
                for t in sub.targets:
                    if isinstance(t, ast.Name) and t.id == p.id:
                        eat_dict(sub.value)
                        resolved = True
            elif (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.ctx, ast.Store)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == p.id
                and isinstance(sub.slice, ast.Constant)
            ):
                resolved = True
                eat_key(sub.slice.value)
        return {"keys": sorted(keys), "lean": lean, "spec": spec,
                "opaque": not resolved, "empty": False}
    return {"keys": [], "lean": False, "spec": False, "opaque": True,
            "empty": False}


def _handler_reads(node) -> dict:
    """Which ctx keys a ``handle_*`` body reads off its payload param, and
    how. A bare ``p["tc"]`` is a *hard* read (senders must set the key);
    ``p.get("tc")`` or a ``"tc" in p`` guard anywhere in the body makes the
    read tolerant of absence."""
    args = node.args.args
    pay = args[2].arg if len(args) >= 3 else None
    hard: set = set()
    soft: set = set()
    guarded: set = set()
    if not pay:
        return {"reads": [], "hard": []}
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Subscript)
            and isinstance(sub.ctx, ast.Load)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == pay
            and isinstance(sub.slice, ast.Constant)
            and sub.slice.value in _CTX_KEYS
        ):
            hard.add(sub.slice.value)
        elif (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "get"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == pay
            and sub.args
            and isinstance(sub.args[0], ast.Constant)
            and sub.args[0].value in _CTX_KEYS
        ):
            soft.add(sub.args[0].value)
            guarded.add(sub.args[0].value)
        elif (
            isinstance(sub, ast.Compare)
            and any(isinstance(op, (ast.In, ast.NotIn)) for op in sub.ops)
            and isinstance(sub.left, ast.Constant)
            and sub.left.value in _CTX_KEYS
            and any(
                isinstance(c, ast.Name) and c.id == pay
                for c in sub.comparators
            )
        ):
            guarded.add(sub.left.value)
    reads = hard | soft
    return {"reads": sorted(reads), "hard": sorted(hard - guarded)}


def _span(node) -> tuple:
    return (node.lineno, getattr(node, "end_lineno", None) or node.lineno)


def _is_ref_scope(path: str) -> bool:
    """Files whose ``x == "metric.name"`` comparisons count as metric
    references: the observability and chaos planes, where dashboards,
    invariants, and scenario baselines consume series by name."""
    p = path.replace("\\", "/")
    return "/obs/" in p or "/chaos/" in p or p.endswith("dashboard.py")


def _name_anchor(node) -> bool:
    """True when the non-literal side of a comparison is name-shaped —
    a variable/attr called *name*, ``d["name"]``, or ``d.get("name")`` —
    so filename and module-path comparisons never read as metric refs."""
    if isinstance(node, ast.Name):
        return "name" in node.id
    if isinstance(node, ast.Attribute):
        return "name" in node.attr
    if isinstance(node, ast.Subscript):
        return isinstance(node.slice, ast.Constant) and node.slice.value == "name"
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and node.args
        and isinstance(node.args[0], ast.Constant)
    ):
        return node.args[0].value == "name"
    return False


class IndexCollector(Rule):
    """Pseudo-rule the engine always runs: never reports, only writes the
    per-file index contribution onto ``ctx.index``."""

    id = "_index"

    def begin_file(self, ctx: FileContext) -> None:
        ctx.index = empty_contribution()

    # -- node dispatch ---------------------------------------------------
    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str) and _VERB_RE.match(node.value):
                ctx.index["strings"].append(node.value)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, ctx)
            return
        if isinstance(node, ast.Compare):
            self._visit_compare(node, ctx)
            return
        if isinstance(node, ast.Assign):
            self._visit_assign(node, ctx)
            return
        if isinstance(node, ast.Dict):
            self._visit_dict(node, ctx)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_funcdef(node, ctx)
            return
        if isinstance(node, ast.Attribute) and node.attr.startswith("handle_"):
            ctx.index["handler_refs"].append(node.attr[7:])

    def _visit_call(self, node: ast.Call, ctx: FileContext) -> None:
        fn = node.func
        fname = (
            fn.attr if isinstance(fn, ast.Attribute)
            else (fn.id if isinstance(fn, ast.Name) else "")
        )
        # RPC send site.
        if (
            isinstance(fn, ast.Attribute)
            and fname in SEND_METHODS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and _VERB_RE.match(node.args[0].value)
        ):
            recv = dotted_name(fn.value)
            token = recv.split(".")[-1].lstrip("_") if recv else ""
            line, end = _span(node)
            ctx.index["sends"].append({
                "verb": node.args[0].value,
                "recv": token,
                "line": line,
                "end": end,
                **_payload_info(node, ctx),
            })
        # Metric emit: typed constructor with a literal name.
        if (
            fname in _METRIC_CTORS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and _is_metric_name(node.args[0].value)
        ):
            tags: Optional[list] = []
            for kw in node.keywords:
                if kw.arg == "tag_keys":
                    if isinstance(kw.value, (ast.Tuple, ast.List)) and all(
                        isinstance(e, ast.Constant) for e in kw.value.elts
                    ):
                        tags = [e.value for e in kw.value.elts]
                    else:
                        tags = None  # dynamic tag_keys: unknown, not empty
            ctx.index["metric_emits"].append({
                "name": node.args[0].value,
                "line": node.lineno,
                "kind": fname.lower(),
                "tags": tags,
            })
        # Metric emit: helper-call form rec("name", "kind", ...) — covers
        # the local series builders in worker/node metrics_series().
        elif (
            len(node.args) >= 2
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[1], ast.Constant)
            and node.args[1].value in _METRIC_KINDS
            and _is_metric_name(node.args[0].value)
        ):
            ctx.index["metric_emits"].append({
                "name": node.args[0].value,
                "line": node.lineno,
                "kind": node.args[1].value,
                "tags": None,
            })
        # Metric reference: _metric_sum(series, "name", ...).
        if (
            "metric_sum" in fname
            and len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and _is_metric_name(node.args[1].value)
        ):
            ctx.index["metric_refs"].append({
                "name": node.args[1].value,
                "line": node.lineno,
                "how": "metric_sum",
                "labels": None,
            })
        # Config read + the sanctioned fallback idiom: get_config() as a
        # non-first operand of an `or` (adopted config wins when present).
        if fname == "get_config":
            parent = ctx.parent(node)
            fallback = (
                isinstance(parent, ast.BoolOp)
                and isinstance(parent.op, ast.Or)
                and parent.values
                and parent.values[0] is not node
            )
            line, end = _span(node)
            ctx.index["config_reads"].append({
                "line": line,
                "end": end,
                "fallback": fallback,
                "func": ctx.func_stack[-1].name if ctx.func_stack else "",
            })
        # Chaos site (literal names only; ChaosGate reports computed ones).
        if (
            fname == "maybe_inject"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            ctx.index["chaos_sites"].append({
                "site": node.args[0].value,
                "line": node.lineno,
            })

    def _visit_compare(self, node: ast.Compare, ctx: FileContext) -> None:
        # dtype-kind site: `<x>.kind == "f"` / `kind in ("f", ...)`.
        left = node.left
        is_kind = (isinstance(left, ast.Attribute) and left.attr == "kind") or (
            isinstance(left, ast.Name) and left.id == "kind"
        )
        if is_kind:
            for cmp in node.comparators:
                hit = False
                if isinstance(cmp, ast.Constant):
                    # == "f", or membership in a charset like "fc"
                    v = cmp.value
                    hit = isinstance(v, str) and "f" in v and len(v) <= 4
                elif isinstance(cmp, (ast.Tuple, ast.List, ast.Set)):
                    hit = any(
                        isinstance(e, ast.Constant) and e.value == "f"
                        for e in cmp.elts
                    )
                if hit:
                    line, end = _span(node)
                    ctx.index["kind_f"].append({
                        "line": line,
                        "end": end,
                        "func": ctx.func_stack[-1].name if ctx.func_stack else "",
                    })
                    break
        # Metric reference: name-anchored equality in obs/chaos code.
        if _is_ref_scope(ctx.path):
            sides = [node.left] + list(node.comparators)
            for i, side in enumerate(sides):
                if not (
                    isinstance(side, ast.Constant)
                    and _is_metric_name(side.value)
                ):
                    continue
                others = sides[:i] + sides[i + 1:]
                if any(_name_anchor(o) for o in others):
                    ctx.index["metric_refs"].append({
                        "name": side.value,
                        "line": node.lineno,
                        "how": "compare",
                        "labels": None,
                    })

    def _visit_assign(self, node: ast.Assign, ctx: FileContext) -> None:
        # Baseline/catalog lists: FOO_NAMES = ("a.b", ...) are references.
        for t in node.targets:
            if isinstance(t, ast.Name) and (
                t.id.endswith("_NAMES") or t.id.endswith("_METRICS")
            ):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for e in node.value.elts:
                        if isinstance(e, ast.Constant) and _is_metric_name(
                            e.value
                        ):
                            ctx.index["metric_refs"].append({
                                "name": e.value,
                                "line": e.lineno,
                                "how": "names-list",
                                "labels": None,
                            })

    def _visit_dict(self, node: ast.Dict, ctx: FileContext) -> None:
        # Hand-built series dict: {"name": <lit>, "kind": "counter", ...}.
        lit = {}
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                lit[k.value] = v.value
        if lit.get("kind") in _METRIC_KINDS and _is_metric_name(
            lit.get("name")
        ):
            ctx.index["metric_emits"].append({
                "name": lit["name"],
                "line": node.lineno,
                "kind": lit["kind"],
                "tags": None,
            })

    def _visit_funcdef(self, node, ctx: FileContext) -> None:
        if not node.name.startswith("handle_") or not ctx.class_stack:
            return
        args = node.args
        nreq = len(args.args) - len(args.defaults) - 1  # minus self
        ctx.index["handlers"].append({
            "verb": node.name[7:],
            "cls": ctx.class_stack[-1].name,
            "line": node.lineno,
            "nreq": nreq,
            "maxpos": len(args.args) - 1,
            "vararg": bool(args.vararg),
            **_handler_reads(node),
        })


class ProjectIndex:
    """The fold of every file's contribution — what phase 2 checks."""

    def __init__(self):
        self.sends: list = []      # + "path" per entry
        self.handlers: dict = {}   # verb -> [handler entries + "path"]
        self.handler_refs: set = set()
        self.strings: set = set()
        self.metric_emits: dict = {}  # name -> [emit entries + "path"]
        self.metric_refs: list = []   # + "path" per entry
        self.config_reads: list = []  # + "path"
        self.kind_f: list = []        # + "path"
        self.chaos_sites: list = []   # + "path"
        self.files = 0

    def add_file(self, path: str, contrib: dict) -> None:
        self.files += 1
        for s in contrib.get("sends", ()):
            self.sends.append({**s, "path": path})
        for h in contrib.get("handlers", ()):
            self.handlers.setdefault(h["verb"], []).append({**h, "path": path})
        self.handler_refs.update(contrib.get("handler_refs", ()))
        self.strings.update(contrib.get("strings", ()))
        for m in contrib.get("metric_emits", ()):
            self.metric_emits.setdefault(m["name"], []).append(
                {**m, "path": path}
            )
        for r in contrib.get("metric_refs", ()):
            self.metric_refs.append({**r, "path": path})
        for c in contrib.get("config_reads", ()):
            self.config_reads.append({**c, "path": path})
        for k in contrib.get("kind_f", ()):
            self.kind_f.append({**k, "path": path})
        for c in contrib.get("chaos_sites", ()):
            self.chaos_sites.append({**c, "path": path})

    def server_classes(self) -> dict:
        """Classes reachable through the RPC dispatch loop: own at least one
        ``handle_`` method with the exact ``(self, conn, p)`` shape. This is
        what keeps serve replica actor methods (``handle_request(self,
        method, args, kwargs)``) out of the verb contract."""
        out: dict = {}
        for verb, defs in self.handlers.items():
            for h in defs:
                if h["nreq"] == 2:
                    out.setdefault(h["cls"], h["path"])
        return out

    def sent_verbs(self) -> set:
        return {s["verb"] for s in self.sends}

    def add_readme_refs(self, readme_path: str) -> None:
        """Backticked metric tokens in README are contract references too —
        a documented series nobody emits is the doc bug this rule exists
        for. Only tokens carrying a label set (``name{labels}``) or a brace
        expansion (``bytes_{written,read}_total``) qualify: that spelling is
        unambiguously a metric series, while a bare dotted token is just as
        often a chaos site, a flight trigger, or a span name. Namespace-gated
        besides, so a labeled token from a foreign vocabulary stays out."""
        try:
            with open(readme_path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return
        namespaces = {n.split(".", 1)[0] for n in self.metric_emits}
        if not namespaces:
            return
        for lineno, line in enumerate(text.splitlines(), 1):
            for tok in re.findall(r"`([^`\s]+)`", line):
                if "{" not in tok:
                    continue
                for name, labels in _expand_readme_token(tok):
                    if not _is_metric_name(name):
                        continue
                    if name.split(".", 1)[0] not in namespaces:
                        continue
                    self.metric_refs.append({
                        "name": name,
                        "line": lineno,
                        "how": "readme",
                        "labels": labels,
                        "path": "README.md",
                    })

    def summary(self) -> dict:
        return {
            "files": self.files,
            "send_sites": len(self.sends),
            "verbs_sent": len(self.sent_verbs()),
            "handlers": sum(len(v) for v in self.handlers.values()),
            "server_classes": sorted(self.server_classes()),
            "metrics_emitted": len(self.metric_emits),
            "metric_refs": len(self.metric_refs),
            "config_reads": len(self.config_reads),
            "dtype_kind_sites": len(self.kind_f),
            "chaos_sites": len({c["site"] for c in self.chaos_sites}),
        }


def _expand_readme_token(tok: str):
    """Yield (name, labels) pairs from one backticked README token.

    ``serve.request.shed_total{qos}`` -> one name with a label-set ref;
    ``ckpt.chunk.bytes_{written,read}_total`` -> brace alternation, expanded
    (the ``_{`` spelling marks expansion; a brace after a complete name is
    its label set)."""
    m = re.match(r"^([a-z0-9_.{},]+?)(\{([a-z0-9_,]+)\})?$", tok)
    if not m:
        return
    base, trail = m.group(1), m.group(3)
    labels = None
    if trail is not None:
        if base.endswith("_"):
            base = f"{base}{{{trail}}}"  # trailing expansion group
        else:
            labels = [x for x in trail.split(",") if x]
    frontier = [base]
    for _ in range(4):  # bounded nesting
        nxt = []
        done = True
        for b in frontier:
            am = re.search(r"\{([a-z0-9_,]+)\}", b)
            if am is None:
                nxt.append(b)
                continue
            done = False
            for alt in am.group(1).split(","):
                nxt.append(b[: am.start()] + alt + b[am.end():])
        frontier = nxt
        if done:
            break
    for name in frontier:
        if "{" not in name:
            yield name, labels
