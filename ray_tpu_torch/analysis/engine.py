"""graftlint engine: one parse per file, rule visitors multiplexed over one
walk, then whole-program rules over the folded project index.

The invariants this codebase learned the hard way (GC-killed fire-and-forget
asyncio tasks, blocking calls on the event-loop thread, pickle of
unauthenticated wire bytes, silent bounded-buffer trims) keep re-appearing as
review comments. This package machine-checks them: each rule is an AST
visitor; the engine parses each file ONCE and drives every applicable rule
over a single depth-first walk (lexical order, parent links and scope stacks
maintained by the engine so rules stay small).

Two phases since the whole-program extension:

- **Phase 1** (per file, cacheable): rule visitors produce raw findings with
  line spans, the suppression scanner produces candidates, and the
  IndexCollector rides the same walk to produce the file's project-index
  contribution. The whole product is a plain dict — the parse cache
  (cache.py) serves it for unchanged files without reparsing.
- **Phase 2** (whole program, always live): contributions fold into a
  ProjectIndex and the cross-file rules (rules_xfile.py) check the
  cross-process contracts — RPC verbs, adopted config, ctx propagation,
  the metric surface, dtype-kind.

Suppressions apply centrally AFTER phase 2, so a cross-file finding is
silenced by the same inline mechanism as a per-file one.

Suppression: ``# graftlint: disable=<rule>[,<rule>...]  <reason>`` on the
finding's line. The reason is REQUIRED — a disable comment without one does
not suppress and is itself reported (rule id ``bad-suppression``). Reasons
are carried into the JSON report so the suppression inventory is diffable
across PRs.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize as _tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional

# Matches the inline disable directive (syntax in the module docstring —
# spelling it here would make this comment parse as a directive itself).
# The rule list tolerates spaces around commas ("rule-a, rule-b").
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable="
    r"([A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)[ \t]*[-—:]*[ \t]*(.*?)\s*$"
)

BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation: file:line, rule id, one-line explanation."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Suppression:
    path: str
    line: int
    rules: tuple
    reason: str


class Rule:
    """Base class for graftlint per-file rules.

    Subclasses set ``id`` and ``explanation`` and override any of the hook
    methods. ``visit`` runs on every node in document order (parents before
    children); ``leave`` runs after a node's subtree completes. Rules report
    via ``ctx.report(node_or_line, message)``.
    """

    id: str = ""
    explanation: str = ""

    def applies_to(self, path: str) -> bool:
        return True

    def begin_file(self, ctx: "FileContext") -> None:
        pass

    def visit(self, node: ast.AST, ctx: "FileContext") -> None:
        pass

    def leave(self, node: ast.AST, ctx: "FileContext") -> None:
        pass

    def end_file(self, ctx: "FileContext") -> None:
        pass


class FileContext:
    """Per-file state the engine maintains for every rule: source path and
    lines, parent links, and the enclosing function/class stacks."""

    def __init__(self, path: str, tree: ast.Module, lines: list):
        self.path = path
        self.tree = tree
        self.lines = lines  # 0-indexed source lines (for suppression lookup)
        self.parents: dict = {}
        # Innermost-last stacks. func_stack holds FunctionDef/AsyncFunctionDef
        # nodes; class_stack holds ClassDef nodes.
        self.func_stack: list = []
        self.class_stack: list = []
        self._raw_findings: dict = {}  # rule_id -> [ (line, end, message) ]
        self.stats: dict = {}  # rule_id -> arbitrary JSON-able stats
        self.index: dict = {}  # this file's project-index contribution

    # -- helpers rules lean on ------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def in_async_context(self) -> bool:
        """True when the innermost enclosing function is ``async def`` — a
        nested plain ``def`` (executor thunk, callback) exits the async
        context even though an async function encloses it lexically."""
        return bool(self.func_stack) and isinstance(
            self.func_stack[-1], ast.AsyncFunctionDef
        )

    def outermost_function(self) -> Optional[ast.AST]:
        return self.func_stack[0] if self.func_stack else None

    def report(self, rule: Rule, node, message: str = "") -> None:
        """``node`` may be an AST node, a bare line int, or a
        ``(line, end_line)`` span. The whole extent matters: a disable
        comment belongs on the line a formatter puts it — often the CLOSING
        line of a multi-line statement — and must still match, so rules
        that buffer findings keep spans, not bare ints."""
        if isinstance(node, int):
            line = end = node
        elif isinstance(node, tuple):
            line, end = node
        else:
            line = getattr(node, "lineno", 0)
            end = getattr(node, "end_lineno", None) or line
        self._raw_findings.setdefault(rule.id, []).append(
            (line, end, message or rule.explanation)
        )


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' for anything dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def parse_suppressions(path: str, source: str) -> list:
    """Disable directives from actual COMMENT tokens only — a
    "# graftlint: disable=..." spelled inside a string literal (test
    fixtures, docs) is data, not a directive."""
    out = []
    if "graftlint" not in source:
        return out
    try:
        tokens = list(_tokenize.generate_tokens(io.StringIO(source).readline))
    except (_tokenize.TokenError, IndentationError, SyntaxError):
        return out  # un-tokenizable source already surfaced as a parse error
    for tok in tokens:
        if tok.type != _tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        out.append(Suppression(path, tok.start[0], rules, m.group(2).strip()))
    return out


@dataclass
class LintResult:
    findings: list = field(default_factory=list)  # [Finding]
    suppressions: list = field(default_factory=list)  # [Suppression] (used ones)
    stats: dict = field(default_factory=dict)  # path -> {rule_id: stats}
    files: int = 0
    errors: list = field(default_factory=list)  # [(path, message)] parse failures
    rule_ids: list = field(default_factory=list)  # every registered rule id
    suppressed_counts: dict = field(default_factory=dict)  # rule_id -> int
    rule_stats: dict = field(default_factory=dict)  # project rule_id -> stats
    index_summary: dict = field(default_factory=dict)
    cache_info: dict = field(default_factory=dict)  # {"hits": n, "misses": n}

    def to_json(self) -> dict:
        """Stable machine-readable report (schema v2): EVERY registered rule
        gets a rollup — finding count, suppressed count, finding sites, and
        (for whole-program rules) the rule's own stats — plus the serialized
        project-index summary. Written to LINT.json by the tier-1 gate so
        the trajectory of findings AND suppressions is diffable across
        PRs."""
        by_rule: dict = {}
        for f in sorted(self.findings, key=lambda f: (f.rule, f.path, f.line)):
            by_rule.setdefault(f.rule, []).append(f.render())
        ids = (
            set(self.rule_ids)
            | set(by_rule)
            | set(self.suppressed_counts)
            | {BAD_SUPPRESSION, UNUSED_SUPPRESSION}
        ) - {"", "_index"}
        rules: dict = {}
        for rid in sorted(ids):
            entry = {
                "findings": len(by_rule.get(rid, ())),
                "suppressed": self.suppressed_counts.get(rid, 0),
                "sites": by_rule.get(rid, []),
            }
            if rid in self.rule_stats:
                entry["stats"] = self.rule_stats[rid]
            rules[rid] = entry
        sups = [
            {"at": f"{s.path}:{s.line}", "rules": list(s.rules), "reason": s.reason}
            for s in sorted(self.suppressions, key=lambda s: (s.path, s.line))
        ]
        out = {
            "version": 2,
            "files": self.files,
            "total": len(self.findings),
            "rules": rules,
            "suppressions": sups,
            "errors": [f"{p}: {m}" for p, m in sorted(self.errors)],
            "index": self.index_summary,
        }
        if self.cache_info:
            out["cache"] = self.cache_info
        return out


def default_rules() -> list:
    """Fresh instances of every shipped per-file rule (rules keep per-run
    state)."""
    from ray_tpu_torch.analysis.rules_async import (
        BgStrongRef,
        LoopThreadRace,
        NoBlockingInAsync,
    )
    from ray_tpu_torch.analysis.rules_buffers import (
        CountedSheds,
        CountedTransfers,
        CountedTrims,
    )
    from ray_tpu_torch.analysis.rules_chaos import ChaosGate
    from ray_tpu_torch.analysis.rules_fsm import FsmEmitter
    from ray_tpu_torch.analysis.rules_security import MacBeforePickle

    return [
        BgStrongRef(),
        NoBlockingInAsync(),
        MacBeforePickle(),
        CountedTrims(),
        CountedSheds(),
        CountedTransfers(),
        LoopThreadRace(),
        FsmEmitter(),
        ChaosGate(),
    ]


def _all_rule_ids(rules: list, project_rules: list) -> set:
    ids = {r.id for r in rules} | {r.id for r in project_rules}
    ids |= {BAD_SUPPRESSION, UNUSED_SUPPRESSION}
    ids.discard("")
    ids.discard("_index")
    return ids


# ---------------------------------------------------------------------------
# Phase 1: per-file analysis -> serializable unit
# ---------------------------------------------------------------------------


def analyze_source(source: str, path: str, rules: list, known_ids: set) -> dict:
    """The cacheable unit of work: parse once, run the per-file rules and the
    index collector over one walk, scan suppressions. Returns a plain dict
    (JSON-able) so the parse cache can serve it verbatim."""
    from ray_tpu_torch.analysis.index import IndexCollector, empty_contribution

    unit = {
        "raw": {},
        "sups": [],
        "bad": [],
        "stats": {},
        "index": empty_contribution(),
        "error": None,
    }
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        unit["error"] = f"syntax error: {e}"
        return unit
    lines = source.splitlines()
    active = [r for r in rules if r.applies_to(path)]
    active.append(IndexCollector())
    ctx = FileContext(path, tree, lines)
    for rule in active:
        rule.begin_file(ctx)
    _walk(tree, active, ctx)
    for rule in active:
        rule.end_file(ctx)
    unit["raw"] = {
        rid: [list(t) for t in entries]
        for rid, entries in ctx._raw_findings.items()
    }
    unit["stats"] = ctx.stats
    unit["index"] = ctx.index

    # Suppression scan. A disable WITH a reason is a candidate; a disable
    # WITHOUT one silences nothing and is itself a finding (the reason
    # string is the whole point — it is the written record of why the
    # invariant does not apply here).
    for s in parse_suppressions(path, source):
        # The comma continuation of the rule list can swallow the first
        # word of a prose reason ("disable=<rule>, intentional"): trailing
        # tokens that are not known rule ids belong to the reason.
        ids = list(s.rules)
        cut = next((i for i, r in enumerate(ids) if r not in known_ids), None)
        if cut is not None:
            s = Suppression(
                s.path,
                s.line,
                tuple(ids[:cut]),
                " ".join(ids[cut:] + ([s.reason] if s.reason else [])),
            )
        if not s.rules:
            unit["bad"].append([
                s.line,
                f"graftlint suppression names no known rule ({ids[0]!r} "
                "is not a rule id)",
            ])
            continue
        if not s.reason:
            unit["bad"].append([
                s.line,
                "graftlint suppression without a reason — write why the "
                "invariant does not apply here",
            ])
            continue
        unit["sups"].append([s.line, list(s.rules), s.reason])
    return unit


# ---------------------------------------------------------------------------
# Phase 2 + merge
# ---------------------------------------------------------------------------


def _finalize_file(
    path: str, unit: dict, phase2_raw: dict, result: LintResult
) -> None:
    """Apply this file's suppressions over the union of its phase-1 and
    phase-2 raw findings; a reasoned disable that matches NOTHING is itself
    a finding — the violation it excused was fixed, so the stale comment
    must go before it silently masks a future regression on that line."""
    if unit["error"] is not None:
        result.errors.append((path, unit["error"]))
        return
    for line, msg in unit["bad"]:
        result.findings.append(Finding(BAD_SUPPRESSION, path, line, msg))
    by_line: dict = {}
    for line, rules, reason in unit["sups"]:
        by_line.setdefault(line, []).append(
            Suppression(path, line, tuple(rules), reason)
        )
    merged: dict = {rid: list(v) for rid, v in unit["raw"].items()}
    for rid, entries in phase2_raw.items():
        merged.setdefault(rid, []).extend(entries)
    used: set = set()
    for rid in sorted(merged):
        for line, end, message in merged[rid]:
            sup = next(
                (
                    s
                    for ln in range(line, end + 1)
                    for s in by_line.get(ln, ())
                    if rid in s.rules
                ),
                None,
            )
            if sup is not None:
                used.add(id(sup))
                result.suppressed_counts[rid] = (
                    result.suppressed_counts.get(rid, 0) + 1
                )
                continue
            result.findings.append(Finding(rid, path, line, message))
    for sups in by_line.values():
        for s in sups:
            if id(s) in used:
                result.suppressions.append(s)
            else:
                result.findings.append(
                    Finding(
                        UNUSED_SUPPRESSION,
                        path,
                        s.line,
                        f"suppression for {'/'.join(s.rules)} matches no "
                        "finding on this line — remove the stale disable",
                    )
                )
    if unit["stats"]:
        result.stats[path] = unit["stats"]


def _run_pipeline(
    units: list,
    result: LintResult,
    rules: list,
    project_rules: list,
    readme: Optional[str] = None,
) -> None:
    """Fold the index, run the whole-program rules, merge + suppress."""
    from ray_tpu_torch.analysis.index import ProjectIndex
    from ray_tpu_torch.analysis.rules_xfile import ProjectContext

    index = ProjectIndex()
    for path, unit in units:
        if unit["error"] is None:
            index.add_file(path, unit["index"])
    if readme:
        index.add_readme_refs(readme)
    pctx = ProjectContext()
    for pr in project_rules:
        pr.check(index, pctx)
    unit_paths = {path for path, _ in units}
    for path, unit in units:
        _finalize_file(path, unit, pctx.raw.get(path, {}), result)
    # Findings against non-Python artifacts (README metric refs) have no
    # comment channel to suppress through — they are always live.
    for path in sorted(set(pctx.raw) - unit_paths):
        for rid, entries in sorted(pctx.raw[path].items()):
            for line, end, message in entries:
                result.findings.append(Finding(rid, path, line, message))
    result.rule_ids = sorted(_all_rule_ids(rules, project_rules))
    result.rule_stats = pctx.stats
    result.index_summary = index.summary()
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[list] = None,
    project_rules: Optional[list] = None,
) -> LintResult:
    """Lint one source string (the test-fixture entry point)."""
    return lint_sources({path: source}, rules=rules, project_rules=project_rules)


def lint_sources(
    sources: dict,
    rules: Optional[list] = None,
    project_rules: Optional[list] = None,
    readme: Optional[str] = None,
) -> LintResult:
    """Lint a {path: source} mapping through the full two-phase pipeline —
    the entry point for multi-file fixtures exercising cross-file rules."""
    from ray_tpu_torch.analysis.rules_xfile import default_project_rules

    rules = default_rules() if rules is None else rules
    project_rules = (
        default_project_rules() if project_rules is None else project_rules
    )
    known_ids = _all_rule_ids(rules, project_rules)
    result = LintResult()
    units = []
    for path, source in sources.items():
        units.append((path, analyze_source(source, path, rules, known_ids)))
        result.files += 1
    _run_pipeline(units, result, rules, project_rules, readme=readme)
    return result


def iter_py_files(paths: Iterable[str]):
    seen: set = set()  # overlapping args must not double-lint a file

    def once(path: str):
        real = os.path.realpath(path)
        if real not in seen:
            seen.add(real)
            yield path

    for p in paths:
        if os.path.isfile(p):
            yield from once(p)
            continue
        for root, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if not d.startswith(".") and d != "__pycache__"
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield from once(os.path.join(root, fn))


def lint_paths(
    paths: Iterable[str],
    rules: Optional[list] = None,
    project_rules: Optional[list] = None,
    cache_path: Optional[str] = None,
    readme: Optional[str] = None,
) -> LintResult:
    """Lint files/trees. With ``cache_path``, unchanged files skip phase 1
    entirely (their cached raw findings, suppressions, and index
    contributions are served by content identity); phase 2 always runs live
    over the full folded index."""
    from ray_tpu_torch.analysis.cache import ParseCache
    from ray_tpu_torch.analysis.rules_xfile import default_project_rules

    result = LintResult()
    rules = default_rules() if rules is None else rules
    project_rules = (
        default_project_rules() if project_rules is None else project_rules
    )
    known_ids = _all_rule_ids(rules, project_rules)
    paths = list(paths)
    for p in paths:
        # A typo'd path must not turn the gate green by linting nothing.
        if not os.path.exists(p):
            result.errors.append((p, "no such file or directory"))
    cache = ParseCache(cache_path) if cache_path else None
    units = []
    for path in iter_py_files(paths):
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            result.errors.append((path, f"unreadable: {e}"))
            continue
        unit = cache.lookup(path, raw) if cache is not None else None
        if unit is None:
            try:
                source = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                result.errors.append((path, f"unreadable: {e}"))
                continue
            unit = analyze_source(source, path, rules, known_ids)
            if cache is not None and unit["error"] is None:
                cache.store(path, raw, unit)
        units.append((path, unit))
        result.files += 1
    _run_pipeline(units, result, rules, project_rules, readme=readme)
    if cache is not None:
        cache.save()
        result.cache_info = {"hits": cache.hits, "misses": cache.misses}
    return result


def _walk(node: ast.AST, rules: list, ctx: FileContext) -> None:
    """Single document-order DFS; every rule sees every node. For function
    nodes, ONLY the body children enter the new scope: decorators, parameter
    defaults, and annotations evaluate at definition time on the defining
    thread, so a ``time.sleep`` inside a decorator argument of an
    ``async def`` is not a blocking call inside the coroutine."""
    for rule in rules:
        rule.visit(node, ctx)
    is_func = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
    is_class = isinstance(node, ast.ClassDef)
    if is_func:
        # A lambda body is deferred code exactly like a nested def's —
        # `run_in_executor(None, lambda: blocking())` must not read as
        # blocking inside the coroutine.
        body = node.body if isinstance(node.body, list) else [node.body]
        body_ids = set(map(id, body))
        outer = [c for c in ast.iter_child_nodes(node) if id(c) not in body_ids]
        for child in outer:
            ctx.parents[child] = node
            _walk(child, rules, ctx)
        ctx.func_stack.append(node)
        for child in body:
            ctx.parents[child] = node
            _walk(child, rules, ctx)
        ctx.func_stack.pop()
    else:
        if is_class:
            ctx.class_stack.append(node)
        for child in ast.iter_child_nodes(node):
            ctx.parents[child] = node
            _walk(child, rules, ctx)
        if is_class:
            ctx.class_stack.pop()
    for rule in rules:
        rule.leave(node, ctx)
