"""The port's analyzer (``ray_tpu_torch.analysis``) against the reference's
(``ray_tpu.analysis``).

- Fixture trees: every literal fixture source of the reference's graftlint
  suites (the sources handed to ``_lint`` in ``tests/test_graftlint.py``
  and the trees handed to ``_xlint`` in ``tests/test_graftlint_xfile.py``),
  grouped into multi-file trees by a seeded shuffle, go through both
  analyzers' ``lint_sources``; the port's copy has ``ray_tpu`` ->
  ``ray_tpu_torch`` in its paths and sources. The findings are identical:
  rule id, path, line and message, modulo the package name and the
  "(the ... )" aside that names a bug class (the port's wording drops the
  reference's history there).
- The port's tree: both analyzers over ``ray_tpu_torch/`` give the same
  project index and the same finding and suppression counts for every rule
  but the two tied to a package name (``chaos-gate``, ``fsm-emitter``).
- Replay: ``python -m ray_tpu chaos run pull_source_death --quick --seed
  1234`` and the port's command, each in its own process, give equal
  normalized injection logs.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import ray_tpu.analysis as ref
import ray_tpu_torch
import ray_tpu_torch.analysis as port

REPO = Path(__file__).resolve().parents[1]
PKG_DIR = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
_NAME = re.compile(r"\bray_tpu\b")
_ASIDE = re.compile(r" \(the [^()]*\)")
_TIED_TO_THE_PACKAGE = {"chaos-gate", "fsm-emitter"}


def _to_port(text: str) -> str:
    return _NAME.sub("ray_tpu_torch", text)


def _strings(tree: ast.Module) -> dict:
    """Module-level ``NAME = "literal"`` assignments (shared fixtures)."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


def _literal(node, consts):
    """A string literal, a shared fixture's name, or ``<either>.format(...)``
    of literals; None for anything built at run time."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id]
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"):
        base = _literal(node.func.value, consts)
        args = [_literal(a, consts) for a in node.args]
        kwargs = {kw.arg: _literal(kw.value, consts) for kw in node.keywords}
        if base is not None and None not in args and None not in kwargs.values():
            return base.format(*args, **kwargs)
    return None


def _harvest():
    """(single-file fixtures as (path, source), multi-file fixture trees)."""
    singles, trees = [], []
    tree = ast.parse((REPO / "tests" / "test_graftlint.py").read_text())
    consts = _strings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_lint":
            src = _literal(node.args[0], consts) if node.args else None
            path = "fixture.py"
            for kw in node.keywords:
                if kw.arg == "path":
                    path = _literal(kw.value, consts)
            if len(node.args) > 1:
                path = _literal(node.args[1], consts)
            if src is not None and path is not None:
                singles.append((path, textwrap.dedent(src)))
    tree = ast.parse((REPO / "tests" / "test_graftlint_xfile.py").read_text())
    consts = _strings(tree)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_xlint"
                and node.args and isinstance(node.args[0], ast.Dict) and not node.keywords):
            d = node.args[0]
            files = {_literal(k, consts): _literal(v, consts) for k, v in zip(d.keys, d.values)}
            if files and None not in files and None not in files.values():
                trees.append({p: textwrap.dedent(s) for p, s in files.items()})
    return singles, trees


SINGLES, TREES = _harvest()


def _seeded_trees(seed: int) -> list:
    """Each reference fixture tree with two single-file fixtures beside it,
    then the remaining single-file fixtures in trees of five; which goes
    where is drawn from the seed."""
    rng = np.random.default_rng(seed)
    order = [SINGLES[i] for i in rng.permutation(len(SINGLES))]
    out = []
    for i, files in enumerate(TREES):
        tree = dict(files)
        for j, (path, src) in enumerate(order[2 * i: 2 * i + 2]):
            tree[f"ray_tpu/mix{i}_{j}/{path}"] = src
        out.append(tree)
    rest = order[2 * len(TREES):]
    for k in range(0, len(rest), 5):
        out.append({f"ray_tpu/case{k + j}/{path}": src for j, (path, src) in enumerate(rest[k:k + 5])})
    return out


def _findings(result, normalize: bool) -> list:
    rows = [(f.rule, f.path, f.line, _ASIDE.sub("", f.message)) for f in result.findings]
    if normalize:
        rows = [(r, p.replace("ray_tpu_torch", "ray_tpu"), ln, m.replace("ray_tpu_torch", "ray_tpu"))
                for r, p, ln, m in rows]
    return sorted(rows)


def test_the_harvest_covers_every_rule():
    """The fixtures cover every rule of the analyzer, both phases."""
    assert len(SINGLES) > 60 and len(TREES) > 15
    fired = set()
    for tree in _seeded_trees(0):
        fired |= {f.rule for f in ref.lint_sources(tree).findings}
    rule_ids = {r.id for r in ref.default_rules()} | {r.id for r in ref.default_project_rules()}
    assert rule_ids <= fired, rule_ids - fired


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identical_findings_on_seeded_fixture_trees(seed):
    n = 0
    for tree in _seeded_trees(seed):
        want = _findings(ref.lint_sources(tree), normalize=False)
        ported = {_to_port(p): _to_port(s) for p, s in tree.items()}
        got = _findings(port.lint_sources(ported), normalize=True)
        assert got == want, (sorted(tree), set(got) ^ set(want))
        n += len(want)
    assert n >= 60  # the comparison is not vacuous


def test_identical_index_over_the_port():
    got = port.lint_paths([PKG_DIR]).to_json()
    want = ref.lint_paths([PKG_DIR]).to_json()
    assert got["index"] == want["index"]
    assert got["files"] == want["files"]
    assert set(got["rules"]) == set(want["rules"])
    for rid in set(got["rules"]) - _TIED_TO_THE_PACKAGE:
        for key in ("findings", "suppressed"):
            assert got["rules"][rid][key] == want["rules"][rid][key], (rid, key)
    assert got["total"] == 0


def _chaos_run(package: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", package, "chaos", "run", "pull_source_death", "--quick", "--seed", "1234"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, (package, out.stdout[-2000:], out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_both_packages_replay_pull_source_death_alike():
    want = _chaos_run("ray_tpu")
    got = _chaos_run("ray_tpu_torch")
    assert want["ok"] and got["ok"], (want, got)
    assert got["injections"] and got["injections"] == want["injections"]
