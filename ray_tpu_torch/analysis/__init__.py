"""graftlint: AST-based invariant checks for the async runtime.

Usage:
    python -m ray_tpu_torch lint [--json] [paths...]

or programmatically::

    from ray_tpu_torch.analysis import lint_paths, lint_source
    result = lint_paths(["ray_tpu_torch/"])
    assert not result.findings

See engine.py for the framework (one parse per file, rule visitors
multiplexed over a single walk, inline suppressions with required reasons)
and rules_*.py for the shipped rules.
"""
from ray_tpu_torch.analysis.engine import (  # noqa: F401
    BAD_SUPPRESSION,
    UNUSED_SUPPRESSION,
    FileContext,
    Finding,
    LintResult,
    Rule,
    Suppression,
    analyze_source,
    default_rules,
    lint_paths,
    lint_source,
    lint_sources,
)
from ray_tpu_torch.analysis.index import ProjectIndex  # noqa: F401
from ray_tpu_torch.analysis.rules_xfile import (  # noqa: F401
    ProjectRule,
    default_project_rules,
)
