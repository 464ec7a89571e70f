"""reprolint command line for the port (port of
repro.analysis.lint.cli): ``python -m repro_torch.analysis.lint``.

Exit codes: 0 = clean modulo the port's baseline; 1 = new violations
(or, with ``--check-baseline``, stale baseline entries); 2 = usage error.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import List, Optional, Sequence

from . import baseline as bl
from .core import (DEFAULT_TARGETS, RULES, _load_builtin_rules, lint_paths,
                   repo_root)
from .report import render_json, render_summary, render_text

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint for the PyTorch port: enforce its env-flag, "
                    "codec, CUDA-launch and host-sync invariants")
    p.add_argument("paths", nargs="*",
                   help=f"files/directories to lint (default: "
                        f"{', '.join(DEFAULT_TARGETS)})")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable JSON report")
    p.add_argument("--rule", action="append", dest="rules", metavar="RULE",
                   help="run only this rule (repeatable)")
    p.add_argument("--baseline", metavar="PATH",
                   help="baseline file (default: <repo>/src/repro_torch/"
                        "analysis/lint/lint-baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every violation, ignoring the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to grandfather the current "
                        "violations")
    p.add_argument("--check-baseline", action="store_true",
                   help="also fail when the baseline holds stale entries "
                        "for violations that no longer exist")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    p.add_argument("--list-env", action="store_true",
                   help="print the port's REPRO_* env-flag registry as a "
                        "markdown table and exit")
    return p


def _list_rules() -> str:
    _load_builtin_rules()
    width = max(len(n) for n in RULES)
    return "\n".join(
        f"{name:<{width}}  [{rule.severity}] {rule.description}"
        for name, rule in sorted(RULES.items()))


def _list_env() -> str:
    """``repro_torch.core.envflags.markdown_table()``; the module is
    stdlib-only, loaded by its path where the package cannot be
    imported."""
    try:
        from repro_torch.core import envflags
    except ImportError:
        path = os.path.join(repo_root(), "src", "repro_torch", "core",
                            "envflags.py")
        spec = importlib.util.spec_from_file_location(
            "_repro_torch_envflags", path)
        envflags = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = envflags   # dataclasses resolves __module__
        spec.loader.exec_module(envflags)
    return envflags.markdown_table()


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if args.list_env:
        print(_list_env())
        return 0

    root = repo_root()
    if args.paths:
        targets = [p if os.path.isabs(p) else os.path.join(os.getcwd(), p)
                   for p in args.paths]
    else:
        targets = [os.path.join(root, t) for t in DEFAULT_TARGETS]
    targets = [t for t in targets if "*" in t or os.path.exists(t)]
    only = frozenset(args.rules) if args.rules else None
    if only:
        _load_builtin_rules()
        unknown = only - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"see --list-rules", file=sys.stderr)
            return 2

    violations = lint_paths(targets, root=root, only=only)

    bpath = args.baseline or bl.baseline_path(root)
    if args.update_baseline:
        entries = bl.save_baseline(bpath, violations)
        print(f"wrote {bpath}: {len(entries)} baselined identit"
              f"{'y' if len(entries) == 1 else 'ies'} covering "
              f"{len(violations)} violation(s)")
        return 0

    stale: List[dict] = []
    if not args.no_baseline:
        entries = bl.load_baseline(bpath)
        violations, stale = bl.diff_against_baseline(violations, entries)

    if args.json:
        print(render_json(violations, stale))
    else:
        text = render_text(violations)
        if text:
            print(text)
        print(render_summary(violations, stale))

    if violations:
        return 1
    if args.check_baseline and stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
