"""reprolint for the PyTorch port: AST-based static analysis of the port's
own invariants (port of ``repro.analysis.lint``; it imports nothing of
``repro``, and nothing of ``torch`` either, so it runs wherever Python
does).

A generic linter cannot know that every ``REPRO_*`` knob must flow through
the typed registry in ``repro_torch.core.envflags``, that a ``Codec``
needs a matched encode/decode pair, that a CUDA grid computed with plain
floordiv drops its remainder block, or that a ``.item()`` in the decode
launch makes the host wait for the card. These rules encode exactly those
contracts: ``env-hygiene``, ``codec-contract``, ``kernel-contract``,
``host-sync`` (the counterpart of the reference's ``tracer-leak``),
``bare-except``, ``mutable-default`` and ``missing-all``. The reference's
``donated-reuse`` (PyTorch has no buffer donation) and
``undrained-callback`` (the port makes no ``non_blocking`` device-to-host
copy) have no subject in the port.

Entry points: ``python -m repro_torch.analysis.lint`` (``cli.py``),
:func:`lint_source` / :func:`lint_paths` (library), the port's
``lint-baseline.json`` beside this file (accepted debt).
"""
from .core import (DEFAULT_TARGETS, RULES, ModuleContext, Rule, Violation,
                   _load_builtin_rules, lint_file, lint_paths, lint_source,
                   register_rule)
from .baseline import (baseline_path, diff_against_baseline, load_baseline,
                       save_baseline)
from .report import render_json, render_summary, render_text, rule_counts
from .cli import main

_load_builtin_rules()    # populate RULES at import so the registry is whole

__all__ = [
    "DEFAULT_TARGETS",
    "RULES",
    "ModuleContext",
    "Rule",
    "Violation",
    "lint_file",
    "lint_paths",
    "lint_source",
    "register_rule",
    "baseline_path",
    "diff_against_baseline",
    "load_baseline",
    "save_baseline",
    "render_json",
    "render_summary",
    "render_text",
    "rule_counts",
    "main",
]
