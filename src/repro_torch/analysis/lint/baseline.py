"""Baseline file handling: grandfather accepted violations, block new ones
(port of repro.analysis.lint.baseline).

The port's ``lint-baseline.json`` lies beside this file (the reference's,
at the repo root, is the reference's own). It holds the violations the
port has accepted, each with a justification. Identity is (path, rule,
message) -- line numbers are deliberately excluded so unrelated edits
don't churn the file -- with a ``count`` per identity for repeated hits.

``diff_against_baseline`` splits live violations into *new* (not covered
-- these fail the check) and reports *stale* entries (baselined
violations that no longer occur -- these should be deleted so the
baseline only ever shrinks).
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Sequence, Tuple

from .core import Violation

__all__ = ["BASELINE_NAME", "baseline_path", "load_baseline",
           "save_baseline", "diff_against_baseline"]

BASELINE_NAME = "lint-baseline.json"
_VERSION = 1


def baseline_path(root: str) -> str:
    """The port's baseline under the repo root ``root``."""
    return os.path.join(root, "src", "repro_torch", "analysis", "lint",
                        BASELINE_NAME)


def load_baseline(path: str) -> List[dict]:
    """Entries of a baseline file ([] when the file doesn't exist)."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != _VERSION:
        raise ValueError(
            f"{path}: not a reprolint baseline (expected a JSON object "
            f"with version={_VERSION})")
    entries = data.get("entries", [])
    for e in entries:
        for key in ("path", "rule", "message"):
            if key not in e:
                raise ValueError(f"{path}: baseline entry missing {key!r}: "
                                 f"{e}")
        e.setdefault("count", 1)
    return entries


def save_baseline(path: str, violations: Sequence[Violation],
                  justification: str = "grandfathered by --update-baseline"
                  ) -> List[dict]:
    """Write the current violations as the new baseline (sorted, counted)."""
    counts: Dict[Tuple[str, str, str], int] = collections.Counter(
        v.ident() for v in violations)
    entries = [
        {"path": p, "rule": r, "message": m, "count": c,
         "justification": justification}
        for (p, r, m), c in sorted(counts.items())
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": _VERSION, "entries": entries}, f, indent=1)
        f.write("\n")
    return entries


def diff_against_baseline(violations: Sequence[Violation],
                          entries: Sequence[dict]
                          ) -> Tuple[List[Violation], List[dict]]:
    """(new_violations, stale_entries).

    Each baseline entry absorbs up to ``count`` live violations with the
    same (path, rule, message); the rest are new. Entries with leftover
    capacity are stale (the violation was fixed -- delete the entry)."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for e in entries:
        key = (e["path"], e["rule"], e["message"])
        budget[key] = budget.get(key, 0) + int(e.get("count", 1))
    new = []
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.col)):
        key = v.ident()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(v)
    stale = []
    for e in entries:
        key = (e["path"], e["rule"], e["message"])
        if budget.get(key, 0) > 0:
            stale.append(e)
            budget[key] = 0          # report an identity once
    return new, stale
