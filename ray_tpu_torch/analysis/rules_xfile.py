"""Cross-file rules: phase 2 of graftlint, run over the ProjectIndex.

Each rule here encodes a contract that spans processes — the bug classes
that per-file visitors structurally cannot see: a verb sent with no
handler on the addressed server, a handler no code path can reach,
``get_config()`` read in a spawned process that only ever sees env
defaults, a lane that forgets to carry trace/QoS ctx, a dashboard
consuming a series nobody emits, and the bf16 ``.kind == "f"`` dtype
check.

A ProjectRule never parses — it reads the folded index and reports findings
with (path, span) so the engine's per-file suppression machinery applies to
phase-2 findings exactly as it does to phase-1 ones.
"""
from __future__ import annotations

from ray_tpu_torch.analysis.index import ProjectIndex


class ProjectContext:
    """Collects phase-2 findings keyed by file, plus per-rule stats."""

    def __init__(self):
        self.raw: dict = {}  # path -> rule_id -> [(line, end, message)]
        self.stats: dict = {}  # rule_id -> JSON-able stats

    def report(self, rule, path: str, span, message: str = "") -> None:
        if isinstance(span, int):
            line = end = span
        else:
            line, end = span
        self.raw.setdefault(path, {}).setdefault(rule.id, []).append(
            (line, end, message or rule.explanation)
        )


class ProjectRule:
    """Base class for whole-program rules. Subclasses set ``id`` and
    ``explanation`` and implement ``check(index, pctx)``."""

    id: str = ""
    explanation: str = ""

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        raise NotImplementedError


class RpcVerbContract(ProjectRule):
    id = "rpc-verb-contract"
    explanation = (
        "every sent RPC verb must have an arity-compatible handle_* on the "
        "addressed server class; dead handlers and unknown verbs are findings"
    )

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        servers = index.server_classes()
        if not servers:
            return  # partial tree: no RPC surface visible, nothing to check
        on_server: dict = {
            verb: [h for h in defs if h["cls"] in servers]
            for verb, defs in index.handlers.items()
        }
        on_server = {v: d for v, d in on_server.items() if d}
        alive = index.sent_verbs() | index.strings | index.handler_refs
        stats = {"verbs": len(on_server), "send_sites": len(index.sends)}
        pctx.stats[self.id] = stats

        for send in index.sends:
            defs = on_server.get(send["verb"])
            span = (send["line"], send["end"])
            if not defs:
                pctx.report(
                    self, send["path"], span,
                    f"RPC verb {send['verb']!r} is sent but no server class "
                    "defines handle_" + send["verb"] + " — the dispatch loop "
                    "would raise 'no handler' at runtime",
                )
                continue
            cls = self._resolve(send["recv"], servers)
            if cls is not None and not any(h["cls"] == cls for h in defs):
                have = "/".join(sorted({h["cls"] for h in defs}))
                pctx.report(
                    self, send["path"], span,
                    f"verb {send['verb']!r} is addressed to {cls} but only "
                    f"{have} defines handle_{send['verb']} — wrong server",
                )

        for verb, defs in sorted(on_server.items()):
            for h in defs:
                # Dispatch calls fn(conn, payload) on the bound method:
                # exactly two positionals after self must be acceptable.
                if not (h["nreq"] <= 2 and (h["maxpos"] >= 2 or h["vararg"])):
                    pctx.report(
                        self, h["path"], h["line"],
                        f"handle_{verb} on {h['cls']} takes {h['nreq']} "
                        "required args after self — RPC dispatch always calls "
                        "handlers as fn(conn, payload)",
                    )
                if index.sends and verb not in alive:
                    pctx.report(
                        self, h["path"], h["line"],
                        f"dead verb: handle_{verb} on {h['cls']} — no send "
                        "site, string constant, or direct reference anywhere "
                        "in the tree reaches it",
                    )

    @staticmethod
    def _resolve(token: str, servers: dict):
        """Map a receiver variable token onto a server class when the name
        is specific enough ('controller', 'daemon'); generic connection
        names ('conn', 'succ_conn') stay unresolved and match any server."""
        if len(token) < 4:
            return None
        t = token.lower()
        hits = [c for c in servers if t in c.lower()]
        return hits[0] if len(hits) == 1 else None


class AdoptedConfig(ProjectRule):
    id = "adopted-config"
    explanation = (
        "get_config() reads this process's env defaults — code running in "
        "spawned workers/daemons/replicas must use the adopted core.config"
    )

    # Modules where a bare get_config() is the *point*: the defining module
    # and the head-process bootstrap that seeds the cluster config.
    ALLOWED = ("core/config.py", "core/api.py")

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        flagged = 0
        for cr in index.config_reads:
            if cr["fallback"]:
                continue  # `... or get_config()` — adopted config wins
            p = cr["path"].replace("\\", "/")
            if any(p.endswith(suffix) for suffix in self.ALLOWED):
                continue
            flagged += 1
            pctx.report(
                self, cr["path"], (cr["line"], cr["end"]),
                "bare get_config() outside the head bootstrap — a spawned "
                "process only sees env defaults here (the stale-config bug class); "
                "use the adopted core.config, or `getattr(core, \"config\", "
                "None) or get_config()` when no worker may exist",
            )
        pctx.stats[self.id] = {
            "reads": len(index.config_reads),
            "fallbacks": sum(1 for c in index.config_reads if c["fallback"]),
        }


class CtxPropagation(ProjectRule):
    id = "ctx-propagation"
    explanation = (
        "cross-process payloads must carry trace/QoS ctx ('tc'/'qc') when "
        "the verb's other senders or its handler expect them"
    )

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        by_verb: dict = {}
        for s in index.sends:
            by_verb.setdefault(s["verb"], []).append(s)
        checked = 0
        for verb, sends in sorted(by_verb.items()):
            # Payloads shipping a full "spec" carry ctx inside the TaskSpec
            # itself; the contract bites the lean/raw forms that strip it.
            known = [
                s for s in sends if not s["opaque"] and not s.get("spec")
            ]
            # Keys any sender sets + keys the handler unconditionally reads:
            # the verb's ctx contract is the union of both.
            expected = set()
            for s in known:
                expected.update(s["keys"])
            for h in index.handlers.get(verb, ()):
                expected.update(h["hard"])
            for s in known:
                checked += 1
                span = (s["line"], s["end"])
                if s["lean"]:
                    # Lean frames are the cross-process task/data fast path:
                    # both ctx planes ride them, always.
                    for key in ("tc", "qc"):
                        if key not in s["keys"]:
                            pctx.report(
                                self, s["path"], span,
                                f"lean-frame payload for {verb!r} never sets "
                                f"{key!r} — trace/QoS ctx must ride the fast "
                                "path (set it conditionally like the task "
                                "lane does)",
                            )
                    continue
                for key in sorted(expected - set(s["keys"])):
                    why = (
                        "its handler reads it unconditionally"
                        if any(
                            key in h["hard"]
                            for h in index.handlers.get(verb, ())
                        )
                        else "other send sites of this verb set it"
                    )
                    pctx.report(
                        self, s["path"], span,
                        f"send of {verb!r} never sets {key!r} but {why} — "
                        "this lane drops ctx on the floor",
                    )
        pctx.stats[self.id] = {"send_sites_checked": checked}


class MetricContract(ProjectRule):
    id = "metric-contract"
    explanation = (
        "every referenced metric name must be emitted somewhere, with one "
        "kind and one label set tree-wide"
    )

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        emits = index.metric_emits
        if not emits:
            return  # partial tree: nothing to check references against
        dead_refs = 0
        for ref in index.metric_refs:
            sites = emits.get(ref["name"])
            if not sites:
                dead_refs += 1
                pctx.report(
                    self, ref["path"], ref["line"],
                    f"metric {ref['name']!r} is referenced here "
                    f"({ref['how']}) but no code path emits it — dashboards "
                    "and baselines would silently read zero forever",
                )
                continue
            if ref["labels"]:
                known = [tuple(s["tags"]) for s in sites if s["tags"] is not None]
                if known and not any(
                    set(ref["labels"]) <= set(tags) for tags in known
                ):
                    pctx.report(
                        self, ref["path"], ref["line"],
                        f"metric {ref['name']!r} is documented with labels "
                        f"{{{','.join(ref['labels'])}}} but is emitted with "
                        f"tag_keys {sorted(set().union(*map(set, known)))}",
                    )
        for name, sites in sorted(emits.items()):
            kinds = sorted({s["kind"] for s in sites})
            if len(kinds) > 1:
                s = sites[1]
                pctx.report(
                    self, s["path"], s["line"],
                    f"metric {name!r} is emitted as {'/'.join(kinds)} at "
                    "different sites — one name, one kind",
                )
            tagsets = sorted({
                tuple(s["tags"]) for s in sites if s["tags"] is not None
            })
            if len(tagsets) > 1:
                worst = next(
                    s for s in sites
                    if s["tags"] is not None and tuple(s["tags"]) != tagsets[0]
                )
                pctx.report(
                    self, worst["path"], worst["line"],
                    f"metric {name!r} is emitted with inconsistent label "
                    f"sets {list(map(list, tagsets))} — series with the same "
                    "name must share one tag_keys tuple",
                )
        pctx.stats[self.id] = {
            "emitted": len(emits),
            "refs": len(index.metric_refs),
            "dead_refs": dead_refs,
        }


class DtypeKind(ProjectRule):
    id = "dtype-kind"
    explanation = (
        'a raw `.kind == "f"` dtype check misses bf16 (ml_dtypes register '
        "as kind 'V') — go through util.dtypes.is_float_dtype"
    )

    # The predicate itself, wherever it lives, plus its home module.
    ALLOWED_FUNCS = frozenset({"_is_float_dtype", "is_float_dtype"})
    ALLOWED_PATHS = ("util/dtypes.py",)

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        for site in index.kind_f:
            if site["func"] in self.ALLOWED_FUNCS:
                continue
            p = site["path"].replace("\\", "/")
            if any(p.endswith(sfx) for sfx in self.ALLOWED_PATHS):
                continue
            pctx.report(
                self, site["path"], (site["line"], site["end"]),
                'dtype check compares .kind against "f" outside '
                "is_float_dtype — bf16 tensors (kind 'V') fall through this "
                "branch (the bf16 corruption class)",
            )
        pctx.stats[self.id] = {"sites": len(index.kind_f)}


class ChaosSiteUnique(ProjectRule):
    """The tree-wide half of chaos-gate: site names are unique across the
    whole tree (two call sites sharing a name are indistinguishable in
    schedules and injection logs). Lives in phase 2 so the per-file half
    stays cacheable — a per-file rule holding cross-file state would go
    quietly blind the moment the parse cache serves one of the two files."""

    id = "chaos-gate"
    explanation = "chaos site names must be unique tree-wide"

    def check(self, index: ProjectIndex, pctx: ProjectContext) -> None:
        first: dict = {}
        for c in sorted(
            index.chaos_sites, key=lambda c: (c["path"], c["line"])
        ):
            prior = first.setdefault(c["site"], (c["path"], c["line"]))
            if prior != (c["path"], c["line"]):
                pctx.report(
                    self, c["path"], c["line"],
                    f"duplicate chaos site name {c['site']!r} (first used at "
                    f"{prior[0]}:{prior[1]}) — site names are unique "
                    "tree-wide so schedules and injection logs identify "
                    "exactly one code path",
                )


def default_project_rules() -> list:
    return [
        RpcVerbContract(),
        AdoptedConfig(),
        CtxPropagation(),
        MetricContract(),
        DtypeKind(),
        ChaosSiteUnique(),
    ]
