"""Reporters: human-readable text and machine-readable JSON (port of
repro.analysis.lint.report, the same formats).

Both group by rule so a log shows at a glance which invariant family
regressed; the JSON form is stable (sorted, versioned) for tooling.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, Sequence

from .core import RULES, Violation

__all__ = ["rule_counts", "render_text", "render_json", "render_summary"]


def rule_counts(violations: Sequence[Violation]) -> Dict[str, int]:
    counts: Dict[str, int] = collections.Counter(v.rule for v in violations)
    return dict(sorted(counts.items()))


def render_text(violations: Sequence[Violation]) -> str:
    lines = [v.format() for v in
             sorted(violations, key=lambda v: (v.path, v.line, v.col, v.rule))]
    return "\n".join(lines)


def render_summary(violations: Sequence[Violation],
                   stale: Sequence[dict] = ()) -> str:
    """Per-rule count table, e.g. for the tail of a log."""
    counts = rule_counts(violations)
    if not counts and not stale:
        return "reprolint: clean (0 violations)"
    lines = []
    if counts:
        width = max(len(r) for r in counts)
        lines.append(f"reprolint: {sum(counts.values())} violation(s) "
                     f"across {len(counts)} rule(s):")
        for rule, n in counts.items():
            lines.append(f"  {rule:<{width}}  {n}")
    for e in stale:
        lines.append(f"  stale baseline entry: {e['path']}: [{e['rule']}] "
                     f"{e['message']} (fixed — remove it from the baseline)")
    return "\n".join(lines)


def render_json(violations: Sequence[Violation],
                stale: Sequence[dict] = ()) -> str:
    payload = {
        "version": 1,
        "counts": rule_counts(violations),
        "violations": [
            {"rule": v.rule, "path": v.path, "line": v.line, "col": v.col,
             "severity": v.severity, "message": v.message}
            for v in sorted(violations,
                            key=lambda v: (v.path, v.line, v.col, v.rule))
        ],
        "stale_baseline_entries": list(stale),
        "rules": {name: {"severity": rule.severity,
                         "description": rule.description}
                  for name, rule in sorted(RULES.items())},
    }
    return json.dumps(payload, indent=1)
