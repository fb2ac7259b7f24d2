"""The port's lint gate: the port's own analyzer, ``ray_tpu_torch.analysis``
(graftlint, every per-file rule and the whole-program phase), over
``ray_tpu_torch/`` gives no finding, and every rule ran: each rule id has
its rollup, and ``chaos-gate`` and the five whole-program rules have no
finding and no site (``tests/test_aaa_lint_gate.py``'s checks). Every RPC
verb the port serves has its caller in the port, so a dead verb fails here.

The reference's analyzer ties two rules to its own package name
(``chaos-gate`` follows ``ray_tpu.chaos`` names, ``fsm-emitter`` reads
``ray_tpu.core.task_state``): over the port it saw none of the port's
chaos imports. The last case shows the port's analyzer does.

Unlike ``tests/test_aaa_lint_gate.py`` this writes no file: ``LINT.json``
reports the reference tree only.
"""
import os
import textwrap

import ray_tpu_torch
from ray_tpu_torch.analysis import default_project_rules, default_rules, lint_paths, lint_source

PKG_DIR = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)

XFILE_RULES = (
    "rpc-verb-contract",
    "adopted-config",
    "ctx-propagation",
    "metric-contract",
    "dtype-kind",
)

# (server class, handler) -> the ROADMAP Queue 1 item whose caller removes it.
# Empty: a verb whose caller is still to be ported goes here, named.
DEAD_VERBS: dict = {}


def test_port_lints_clean_but_for_the_named_dead_verbs():
    result = lint_paths([PKG_DIR], readme=os.path.join(REPO_ROOT, "README.md"))
    assert not result.errors, result.errors
    assert not DEAD_VERBS
    assert not result.findings, "\n" + "\n".join(f.render() for f in result.findings)
    report = result.to_json()
    assert report["version"] == 2 and report["total"] == 0
    # Every registered rule has its rollup: absence of a rule id means the
    # rule did not run.
    rule_ids = {r.id for r in default_rules()} | {r.id for r in default_project_rules()}
    assert rule_ids <= set(report["rules"]), rule_ids - set(report["rules"])
    for rid in XFILE_RULES + ("bg-strong-ref", "chaos-gate"):
        entry = report["rules"][rid]
        assert set(entry) >= {"findings", "suppressed", "sites"}, rid
        assert entry["findings"] == 0 and entry["sites"] == [], rid
    for rid in XFILE_RULES:
        assert "stats" in report["rules"][rid], rid
    # The whole-program phase ran over the port's real tree.
    idx = report["index"]
    assert {"Controller", "CoreWorker", "NodeDaemon"} <= set(idx["server_classes"])
    assert idx["send_sites"] > 50 and idx["handlers"] > 30
    assert idx["metrics_emitted"] > 30 and idx["metric_refs"] > 10
    assert idx["chaos_sites"] > 20
    assert all(s["reason"] for s in report["suppressions"])
    # fsm-emitter read the port's worker.py against the port's FSM.
    worker = os.path.join(PKG_DIR, "core", "worker.py")
    assert result.stats[worker]["fsm-emitter"]["emitters"] >= 1


def test_chaos_gate_follows_the_ports_package_name():
    """An ad-hoc branch on the port's chaos plane, written as the port's
    modules import it, is a finding; the reference's analyzer, which tracks
    ``ray_tpu.chaos`` names only, passes the same source."""
    from ray_tpu.analysis import lint_source as ref_lint_source

    src = textwrap.dedent("""
        from ray_tpu_torch import chaos as _chaos
        from ray_tpu_torch.chaos import injection_log

        def f():
            if _chaos.active() is not None:
                raise RuntimeError("my own fault")
    """)
    path = os.path.join(PKG_DIR, "core", "fixture.py")
    hits = [f.line for f in lint_source(src, path).findings if f.rule == "chaos-gate"]
    assert hits == [3, 6], hits
    assert not [f for f in ref_lint_source(src, path).findings if f.rule == "chaos-gate"]
