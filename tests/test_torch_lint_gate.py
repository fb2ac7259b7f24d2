"""The port's lint gate: ``ray_tpu.analysis.lint_paths`` (graftlint, every
per-file rule and the whole-program phase) over ``ray_tpu_torch/`` gives no
finding, except the ``rpc-verb-contract`` "dead verb" findings named below.
Each is a handler whose callers are in modules the port does not have yet;
the entry leaves the list when the ROADMAP Queue 1 item it names lands, and
the list must be exactly what lint reports (a verb that gains its caller
fails here until its entry goes).

Unlike ``tests/test_aaa_lint_gate.py`` this writes no file: ``LINT.json``
reports the reference tree only.
"""
import os

import ray_tpu_torch
from ray_tpu.analysis import lint_paths

PKG_DIR = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
REPO_ROOT = os.path.dirname(PKG_DIR)

# (server class, handler) -> the ROADMAP Queue 1 item whose caller removes it,
# with the reference module that calls it.
DEAD_VERBS = {
    ("Controller", "handle_undrain_node"): "2c (autoscaler.py, __main__.py)",
    ("Controller", "handle_get_autoscaler_state"): "2c (autoscaler.py, scripts.py)",
    ("Controller", "handle_slo_summary"): "2c (scripts.py, dashboard.py)",
    ("Controller", "handle_list_flight_dumps"): "2c (dashboard.py, chaos/scenarios.py)",
    ("Controller", "handle_kv_keys"): "2c (job/manager.py)",
    ("NodeDaemon", "handle_tail_worker_log"): "2c (scripts.py)",
    ("CoreWorker", "handle_debug_observability"): "2c (__main__.py)",
}


def _dead_verb(finding):
    """(class, handler) of an rpc-verb-contract dead-verb finding, else None."""
    if finding.rule != "rpc-verb-contract" or not finding.message.startswith("dead verb: "):
        return None
    handler, _, rest = finding.message[len("dead verb: "):].partition(" on ")
    return rest.split(" ", 1)[0], handler


def test_port_lints_clean_but_for_the_named_dead_verbs():
    result = lint_paths([PKG_DIR], readme=os.path.join(REPO_ROOT, "README.md"))
    assert not result.errors, result.errors
    dead = {}
    other = []
    for f in result.findings:
        key = _dead_verb(f)
        if key is None:
            other.append(f)
        else:
            dead[key] = f
    assert not other, "\n" + "\n".join(f.render() for f in other)
    assert set(dead) == set(DEAD_VERBS), (
        f"dead verbs lint reports but the list lacks: {sorted(set(dead) - set(DEAD_VERBS))}; "
        f"listed but no longer reported (remove them): {sorted(set(DEAD_VERBS) - set(dead))}")
    report = result.to_json()
    assert report["version"] == 2 and report["total"] == len(DEAD_VERBS)
    # The whole-program phase ran over the port's real tree.
    idx = report["index"]
    assert {"Controller", "CoreWorker", "NodeDaemon"} <= set(idx["server_classes"])
    assert idx["send_sites"] > 50 and idx["handlers"] > 30
