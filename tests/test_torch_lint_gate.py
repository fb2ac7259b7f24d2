"""The port's lint gate: ``ray_tpu.analysis.lint_paths`` (graftlint, every
per-file rule and the whole-program phase) over ``ray_tpu_torch/`` gives no
finding. Every RPC verb the port serves has its caller in the port: the last
seven (``undrain_node``, ``get_autoscaler_state``, ``slo_summary``,
``list_flight_dumps``, ``kv_keys``, ``tail_worker_log``,
``debug_observability``) gained theirs with the operator surface
(``autoscaler.py``, ``scripts.py``, ``dashboard.py``, ``job/``,
``__main__.py``), so a dead verb fails here.

Unlike ``tests/test_aaa_lint_gate.py`` this writes no file: ``LINT.json``
reports the reference tree only.
"""
import os

import ray_tpu_torch
from ray_tpu.analysis import lint_paths

PKG_DIR = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)

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
    # The whole-program phase ran over the port's real tree.
    idx = report["index"]
    assert {"Controller", "CoreWorker", "NodeDaemon"} <= set(idx["server_classes"])
    assert idx["send_sites"] > 50 and idx["handlers"] > 30
