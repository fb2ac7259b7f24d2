"""`python -m ray_tpu_torch lint` — run graftlint over the tree.

Exits non-zero on any finding (the CI contract: the committed tree is always
at zero). ``--json`` emits the stable machine-readable report (per-rule
finding + suppression rollups, the suppression inventory, and the
project-index summary) that the tier-1 gate writes to LINT.json, so the
trajectory of findings and suppressions is diffable across PRs.

Whole-program analysis always folds the FULL tree's index (cross-file
contracts are meaningless over a partial view); two knobs keep that fast:

- the parse cache (on by default, per-user path outside the repo; disable
  with ``--no-cache``) serves unchanged files' phase-1 results by content
  identity, so a re-run on an unchanged tree reparses nothing;
- ``--diff <ref>`` filters the REPORTED findings to files changed since the
  git ref (the pre-commit shape: ``lint --diff origin/main``) while the
  index still covers everything — a contract broken by an unchanged file's
  counterpart still surfaces, attributed to the changed side.

Unlike every other subcommand, lint never connects to a cluster — it is a
pure source-tree pass.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def default_target() -> str:
    """The installed ray_tpu_torch package directory (lint the shipped tree when
    no paths are given)."""
    import ray_tpu_torch

    return os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))


def default_readme(target: str) -> str | None:
    """README.md sitting next to the linted package: its documented metric
    names join the metric-contract reference surface."""
    candidate = os.path.join(os.path.dirname(os.path.abspath(target)), "README.md")
    return candidate if os.path.exists(candidate) else None


def add_lint_parser(sub) -> None:
    lp = sub.add_parser(
        "lint",
        help="AST invariant checks for the async runtime (graftlint)",
        description=(
            "Two-phase AST analysis: per-file rules (bg-strong-ref, "
            "no-blocking-in-async, mac-before-pickle, counted-trims, "
            "loop-thread-race, fsm-emitter, chaos-gate) plus whole-program "
            "contract rules over the folded project index "
            "(rpc-verb-contract, adopted-config, ctx-propagation, "
            "metric-contract, dtype-kind). "
            "Suppress a finding inline with "
            "'# graftlint: disable=<rule>  <reason>' — the reason is required."
        ),
    )
    lp.add_argument("paths", nargs="*", help="files/dirs to lint (default: the ray_tpu_torch package)")
    lp.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    lp.add_argument(
        "--diff",
        metavar="REF",
        help="report findings only for files changed since the git ref "
        "(the index still folds the whole tree)",
    )
    lp.add_argument(
        "--no-cache",
        action="store_true",
        help="disable the parse cache (always reparse every file)",
    )
    lp.add_argument(
        "--cache-path",
        metavar="FILE",
        help="parse cache location (default: per-user cache dir)",
    )


def _changed_files(ref: str, repo_dir: str) -> set | None:
    """Absolute realpaths of .py files changed since ``ref``, or None when
    git can't answer (not a repo, unknown ref) — the caller falls back to an
    unfiltered report rather than a silently-green one."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", ref, "--", "*.py"],
            cwd=repo_dir,
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    root = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        cwd=repo_dir,
        capture_output=True,
        text=True,
    ).stdout.strip()
    if not root:
        return None
    return {
        os.path.realpath(os.path.join(root, line))
        for line in out.stdout.splitlines()
        if line.strip()
    }


def cmd_lint(args) -> int:
    from ray_tpu_torch.analysis import lint_paths
    from ray_tpu_torch.analysis.cache import default_cache_path

    paths = args.paths or [default_target()]
    cache_path = None
    if not args.no_cache:
        cache_path = args.cache_path or default_cache_path()
    result = lint_paths(
        paths, cache_path=cache_path, readme=default_readme(paths[0])
    )

    filtered_note = ""
    if args.diff:
        changed = _changed_files(args.diff, os.path.dirname(default_target()))
        if changed is None:
            print(
                f"lint --diff: cannot resolve {args.diff!r} against git — "
                "reporting unfiltered findings",
                file=sys.stderr,
            )
        else:
            before = len(result.findings)
            result.findings = [
                f
                for f in result.findings
                if os.path.realpath(f.path) in changed
            ]
            hidden = before - len(result.findings)
            if hidden:
                filtered_note = (
                    f" ({hidden} finding{'s' if hidden != 1 else ''} outside "
                    f"--diff {args.diff} hidden)"
                )

    if args.json:
        print(json.dumps(result.to_json(), indent=2, sort_keys=True))
    else:
        for f in result.findings:
            print(f.render())
        for path, msg in result.errors:
            print(f"{path}: ERROR {msg}", file=sys.stderr)
        n = len(result.findings)
        sup = sum(result.suppressed_counts.values())
        cache = ""
        if result.cache_info:
            cache = (
                f", cache {result.cache_info['hits']} hit/"
                f"{result.cache_info['misses']} miss"
            )
        print(
            f"graftlint: {n} finding{'s' if n != 1 else ''} in {result.files} "
            f"files ({sup} suppressed with reasons{cache}){filtered_note}"
        )
    return 1 if (result.findings or result.errors) else 0
