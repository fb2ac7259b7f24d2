"""graftlint phase 2 in the port (``ray_tpu_torch.analysis``): the
whole-program rules over the project index; ``tests/test_graftlint_xfile.py``
with fixture paths and sources naming ``ray_tpu_torch/``.

Per-rule fixtures (firing / clean / suppressed-with-reason) for the five
cross-file contracts, a two-file pair proving the index actually crosses
file boundaries, and the parse-cache behavior tests: an unchanged tree is
served entirely from cache (much faster), and editing one file re-parses
only that file.
"""
import textwrap
import time

from ray_tpu_torch.analysis import BAD_SUPPRESSION, lint_paths, lint_sources

SERVER = """
    class Controller:
        async def handle_ping(self, conn, p):
            return {"ok": True}
"""


def _xlint(sources: dict, readme=None):
    return lint_sources(
        {path: textwrap.dedent(src) for path, src in sources.items()},
        readme=readme,
    )


def _hits(result, rule):
    return [f for f in result.findings if f.rule == rule]


# ---------------------------------------------------------------------------
# rpc-verb-contract
# ---------------------------------------------------------------------------

def test_rpc_unknown_verb_fires():
    r = _xlint({
        "server.py": SERVER,
        "client.py": """
            async def go(conn):
                await conn.call("ping", {})
                await conn.call("pingg", {})
        """,
    })
    hits = _hits(r, "rpc-verb-contract")
    assert len(hits) == 1 and hits[0].path == "client.py"
    assert "'pingg'" in hits[0].message and "no server class" in hits[0].message


def test_rpc_wrong_server_fires():
    r = _xlint({
        "server.py": SERVER + """
            class NodeDaemon:
                async def handle_pull_chunk(self, conn, p):
                    return {}
        """,
        "client.py": """
            async def go(self):
                await self.controller.call("ping", {})
                await self.controller.call("pull_chunk", {})
        """,
    })
    hits = _hits(r, "rpc-verb-contract")
    assert len(hits) == 1 and "wrong server" in hits[0].message


def test_rpc_handler_arity_fires():
    r = _xlint({
        # On a class that IS a server (handle_ping qualifies it), a handler
        # whose shape dispatch can't satisfy is a finding.
        "server.py": SERVER + """
            class NodeDaemon:
                async def handle_pull_chunk(self, conn, p):
                    return {}

                async def handle_push_part(self, conn, p, extra):
                    return {}
        """,
        "client.py": """
            async def go(conn):
                await conn.call("ping", {})
                await conn.call("pull_chunk", {})
                await conn.call("push_part", {})
        """,
    })
    hits = _hits(r, "rpc-verb-contract")
    assert len(hits) == 1 and "required args after self" in hits[0].message


def test_rpc_dead_verb_fires_and_string_pool_keeps_alive():
    sources = {
        "server.py": SERVER + """
            class NodeDaemon:
                async def handle_orphan_thing(self, conn, p):
                    return {}
        """,
        "client.py": """
            async def go(conn):
                await conn.call("ping", {})
        """,
    }
    r = _xlint(sources)
    hits = _hits(r, "rpc-verb-contract")
    assert len(hits) == 1 and "dead verb" in hits[0].message
    # Dynamic dispatch pools (`_call("orphan_thing", ...)` style constants)
    # keep a verb alive even with no direct send site.
    sources["client.py"] += '\nVERBS = ["orphan_thing"]\n'
    assert not _hits(_xlint(sources), "rpc-verb-contract")


def test_rpc_dead_verb_suppressed_with_reason():
    r = _xlint({
        "server.py": SERVER + """
            class NodeDaemon:
                async def handle_orphan_thing(self, conn, p):  # graftlint: disable=rpc-verb-contract  kept one release for rollback compat
                    return {}
        """,
        "client.py": """
            async def go(conn):
                await conn.call("ping", {})
        """,
    })
    assert not _hits(r, "rpc-verb-contract")
    assert r.suppressed_counts.get("rpc-verb-contract") == 1


def test_rpc_skips_without_server_classes():
    # Partial tree (a lone client file): no RPC surface, no guessing.
    r = _xlint({"client.py": 'async def go(conn):\n    await conn.call("zz_q", {})\n'})
    assert not _hits(r, "rpc-verb-contract")


# ---------------------------------------------------------------------------
# adopted-config
# ---------------------------------------------------------------------------

def test_adopted_config_bare_read_fires():
    r = _xlint({
        "ray_tpu_torch/ckpt/thing.py": """
            from ray_tpu_torch.core.config import get_config

            def poll_interval():
                return get_config().poll_s
        """,
    })
    hits = _hits(r, "adopted-config")
    assert len(hits) == 1 and "adopted core.config" in hits[0].message


def test_adopted_config_fallback_idiom_and_home_modules_clean():
    r = _xlint({
        "ray_tpu_torch/ckpt/thing.py": """
            def poll_interval(core):
                cfg = getattr(core, "config", None) or get_config()
                return cfg.poll_s
        """,
        "ray_tpu_torch/core/api.py": """
            def bootstrap():
                return get_config()
        """,
    })
    assert not _hits(r, "adopted-config")


def test_adopted_config_suppressed_with_reason():
    r = _xlint({
        "ray_tpu_torch/tools/head_only.py": """
            def show():
                return get_config().to_dict()  # graftlint: disable=adopted-config  head-process CLI tool, never runs in a spawned worker
        """,
    })
    assert not _hits(r, "adopted-config")
    assert r.suppressed_counts.get("adopted-config") == 1


# ---------------------------------------------------------------------------
# ctx-propagation
# ---------------------------------------------------------------------------

def test_ctx_handler_hard_read_crosses_files():
    """The index-crossing pair: the handler's unconditional p["tc"] read
    lives in server.py, the violating send site in client.py — neither file
    alone contains the contract."""
    r = _xlint({
        "server.py": """
            class NodeDaemon:
                async def handle_fetch_shard(self, conn, p):
                    token = activate(tuple(p["tc"]))
                    return {"ok": True}
        """,
        "client.py": """
            async def pull(conn):
                return await conn.call("fetch_shard", {"items": []})
        """,
    })
    hits = _hits(r, "ctx-propagation")
    assert len(hits) == 1 and hits[0].path == "client.py"
    assert "its handler reads it unconditionally" in hits[0].message


def test_ctx_sibling_senders_define_the_contract():
    r = _xlint({
        "a.py": """
            async def one(conn, t):
                await conn.call("sync_thing", {"x": 1, "tc": t})
        """,
        "b.py": """
            async def two(conn):
                await conn.call("sync_thing", {"x": 2})
        """,
    })
    hits = _hits(r, "ctx-propagation")
    assert len(hits) == 1 and hits[0].path == "b.py"
    assert "other send sites of this verb set it" in hits[0].message


def test_ctx_lean_frames_need_both_planes():
    r = _xlint({
        "a.py": """
            async def push(conn, t):
                await conn.call("task_go", {"lean": 1, "tc": t})
        """,
    })
    hits = _hits(r, "ctx-propagation")
    assert len(hits) == 1 and "'qc'" in hits[0].message


def test_ctx_conditional_subscript_store_counts_as_set():
    # The task lane's idiom: set tc only when a trace is live.
    r = _xlint({
        "server.py": """
            class NodeDaemon:
                async def handle_fetch_shard(self, conn, p):
                    return {"t": p["tc"]}
        """,
        "client.py": """
            async def pull(conn, t):
                payload = {"items": []}
                if t is not None:
                    payload["tc"] = t
                return await conn.call("fetch_shard", payload)
        """,
    })
    assert not _hits(r, "ctx-propagation")


def test_ctx_opaque_payloads_are_not_guessed_at():
    r = _xlint({
        "server.py": """
            class NodeDaemon:
                async def handle_fetch_shard(self, conn, p):
                    return {"t": p["tc"]}
        """,
        "client.py": """
            async def pull(conn, payload):
                return await conn.call("fetch_shard", payload)
        """,
    })
    assert not _hits(r, "ctx-propagation")


def test_ctx_suppressed_with_reason():
    r = _xlint({
        "a.py": """
            async def one(conn, t):
                await conn.call("sync_thing", {"x": 1, "tc": t})
        """,
        "b.py": """
            async def two(conn):
                await conn.call("sync_thing", {"x": 2})  # graftlint: disable=ctx-propagation  loopback self-send, trace already active on this thread
        """,
    })
    assert not _hits(r, "ctx-propagation")
    assert r.suppressed_counts.get("ctx-propagation") == 1


# ---------------------------------------------------------------------------
# metric-contract
# ---------------------------------------------------------------------------

EMIT = """
    from ray_tpu_torch.util import metrics as _metrics

    C = _metrics.Counter("pool.live_total", "live things")
"""


def test_metric_dead_reference_fires():
    r = _xlint({
        "emit.py": EMIT,
        "pkg/obs/dash.py": """
            def scan(rows):
                return [r for r in rows if r.get("name") == "pool.dead_total"]
        """,
    })
    hits = _hits(r, "metric-contract")
    assert len(hits) == 1 and hits[0].path == "pkg/obs/dash.py"
    assert "no code path emits it" in hits[0].message


def test_metric_live_reference_clean_and_scope_gated():
    r = _xlint({
        "emit.py": EMIT,
        "pkg/obs/dash.py": """
            def scan(rows):
                return [r for r in rows if r.get("name") == "pool.live_total"]
        """,
        # Same compare OUTSIDE obs/chaos scope: not a metric reference.
        "pkg/data/misc.py": """
            def scan(rows):
                return [r for r in rows if r.get("name") == "pool.dead_total"]
        """,
    })
    assert not _hits(r, "metric-contract")


def test_metric_kind_and_labelset_consistency():
    r = _xlint({
        "a.py": EMIT,
        "b.py": """
            from ray_tpu_torch.util import metrics as _metrics

            G = _metrics.Gauge("pool.live_total", "same name, wrong kind")
            C1 = _metrics.Counter("pool.shed_total", "x", tag_keys=("reason",))
            C2 = _metrics.Counter("pool.shed_total", "x", tag_keys=("zone",))
        """,
    })
    msgs = [f.message for f in _hits(r, "metric-contract")]
    assert any("one name, one kind" in m for m in msgs)
    assert any("inconsistent label sets" in m for m in msgs)


def test_metric_readme_labels_checked_against_tagsets(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(
        "Shedding shows up in `pool.shed_total{reason}` and\n"
        "`pool.shed_total{zone}` on the dashboard.\n"
    )
    r = _xlint({
        "a.py": """
            from ray_tpu_torch.util import metrics as _metrics

            C = _metrics.Counter("pool.shed_total", "x", tag_keys=("reason", "qos"))
        """,
    }, readme=str(readme))
    hits = _hits(r, "metric-contract")
    assert len(hits) == 1 and hits[0].path == "README.md"
    assert "{zone}" in hits[0].message


def test_metric_suppressed_with_reason():
    r = _xlint({
        "emit.py": EMIT,
        "pkg/obs/dash.py": """
            def scan(rows):
                return [r for r in rows if r.get("name") == "pool.request"]  # graftlint: disable=metric-contract  span name, not a metric series
        """,
    })
    assert not _hits(r, "metric-contract")
    assert r.suppressed_counts.get("metric-contract") == 1


def test_metric_skips_without_any_emits():
    # Partial tree (dashboards linted alone): nothing to check against.
    r = _xlint({
        "pkg/obs/dash.py": """
            def scan(rows):
                return [r for r in rows if r.get("name") == "pool.dead_total"]
        """,
    })
    assert not _hits(r, "metric-contract")


# ---------------------------------------------------------------------------
# dtype-kind
# ---------------------------------------------------------------------------

def test_dtype_kind_raw_check_fires():
    r = _xlint({
        "pkg/data/part.py": """
            def pick(arr):
                if arr.dtype.kind == "f":
                    return 1
        """,
    })
    hits = _hits(r, "dtype-kind")
    assert len(hits) == 1 and "bf16" in hits[0].message


def test_dtype_kind_predicate_and_home_module_clean():
    r = _xlint({
        "pkg/x.py": """
            def _is_float_dtype(dt):
                return dt.kind == "f"
        """,
        "ray_tpu_torch/util/dtypes.py": """
            def is_float_dtype(dt):
                return dt.kind == "f"
        """,
    })
    assert not _hits(r, "dtype-kind")


def test_dtype_kind_suppressed_with_reason():
    r = _xlint({
        "pkg/data/part.py": """
            def pick(arr):
                if arr.dtype.kind == "f":  # graftlint: disable=dtype-kind  numpy-only input path, bf16 cannot reach here
                    return 1
        """,
    })
    assert not _hits(r, "dtype-kind")
    assert r.suppressed_counts.get("dtype-kind") == 1


# ---------------------------------------------------------------------------
# chaos-gate (the tree-wide half: duplicate site names across files)
# ---------------------------------------------------------------------------

def test_chaos_duplicate_site_across_files_fires():
    src = """
        from ray_tpu_torch import chaos

        def f():
            chaos.maybe_inject("xfixture.site")
    """
    r = _xlint({"a.py": src, "b.py": src})
    hits = _hits(r, "chaos-gate")
    assert len(hits) == 1 and hits[0].path == "b.py"
    assert "first used at a.py" in hits[0].message
    assert not _hits(_xlint({"a.py": src}), "chaos-gate")


# ---------------------------------------------------------------------------
# parse cache
# ---------------------------------------------------------------------------

def test_cache_replays_findings_and_reparses_only_the_edited_file(tmp_path):
    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text("import asyncio\n\n\nasync def f():\n    asyncio.create_task(g())\n")
    b.write_text("Y = 2\n")
    cp = str(tmp_path / "cache" / "pc.json")

    r1 = lint_paths([str(tmp_path)], cache_path=cp)
    assert r1.cache_info == {"hits": 0, "misses": 2}
    r2 = lint_paths([str(tmp_path)], cache_path=cp)
    assert r2.cache_info == {"hits": 2, "misses": 0}
    # Cached units replay findings identically — a cache hit is not a skip.
    assert [f.render() for f in r2.findings] == [f.render() for f in r1.findings]
    assert len(r2.findings) == 1 and r2.findings[0].rule == "bg-strong-ref"

    b.write_text("Y = 3\n")  # same size: forces the content-hash path
    r3 = lint_paths([str(tmp_path)], cache_path=cp)
    assert r3.cache_info == {"hits": 1, "misses": 1}


def test_cache_suppressions_survive_the_round_trip(tmp_path):
    a = tmp_path / "a.py"
    a.write_text(
        "import asyncio\n\n\nasync def f():\n"
        "    asyncio.create_task(g())  # graftlint: disable=bg-strong-ref  fixture: handle kept by caller\n"
    )
    cp = str(tmp_path / "pc.json")
    r1 = lint_paths([str(a)], cache_path=cp)
    r2 = lint_paths([str(a)], cache_path=cp)
    for r in (r1, r2):
        assert not r.findings
        assert r.suppressed_counts.get("bg-strong-ref") == 1
    assert r2.cache_info["hits"] == 1


def test_unchanged_tree_rerun_is_served_from_cache_and_much_faster(tmp_path):
    # A tree big enough that parsing + rule walking dominates.
    body = "".join(
        f"async def f{i}(x):\n    return await g(x + {i})\n\n" for i in range(200)
    )
    for i in range(20):
        (tmp_path / f"m{i}.py").write_text(body)
    cp = str(tmp_path / "pc.json")

    t0 = time.perf_counter()
    r1 = lint_paths([str(tmp_path)], cache_path=cp)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = lint_paths([str(tmp_path)], cache_path=cp)
    warm = time.perf_counter() - t0

    assert r1.cache_info == {"hits": 0, "misses": 20}
    assert r2.cache_info == {"hits": 20, "misses": 0}
    assert not r2.findings and not r2.errors
    assert warm * 10 < cold, f"cold={cold:.3f}s warm={warm:.3f}s"


def test_cache_never_caches_parse_errors(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    cp = str(tmp_path / "pc.json")
    r1 = lint_paths([str(bad)], cache_path=cp)
    r2 = lint_paths([str(bad)], cache_path=cp)
    assert r1.errors and r2.errors
    assert r2.cache_info == {"hits": 0, "misses": 1}


# ---------------------------------------------------------------------------
# report plumbing for the new phase
# ---------------------------------------------------------------------------

def test_report_carries_rule_stats_and_index_summary():
    r = _xlint({
        "server.py": SERVER,
        "client.py": """
            async def go(conn):
                await conn.call("ping", {})
        """,
    })
    report = r.to_json()
    assert report["version"] == 2
    assert report["index"]["send_sites"] == 1
    assert report["index"]["server_classes"] == ["Controller"]
    assert report["rules"]["rpc-verb-contract"]["stats"]["send_sites"] == 1
    assert report["rules"]["adopted-config"]["stats"]["reads"] == 0


def test_bad_suppression_on_cross_file_rule_still_fires():
    r = _xlint({
        "pkg/data/part.py": """
            def pick(arr):
                if arr.dtype.kind == "f":  # graftlint: disable=dtype-kind
                    return 1
        """,
    })
    assert _hits(r, "dtype-kind") and _hits(r, BAD_SUPPRESSION)
