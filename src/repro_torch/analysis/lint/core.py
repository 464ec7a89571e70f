"""reprolint core for the port: AST visitor framework, rule registry,
suppressions (port of repro.analysis.lint.core, with its own copies of the
reference's helpers; it imports nothing of ``repro``, nor ``torch``).

The port has contracts of its own that only surface at run time when
broken: every ``REPRO_*`` read goes through ``repro_torch.core.envflags``,
a ``Codec`` registration carries its whole surface, a CUDA launch
spells out its geometry and guards its remainders, and the decode launch
does not wait on the device except where it means to. ``reprolint`` turns
them into machine-checked rules over the Python AST:

* a :class:`Rule` is a named check over one :class:`ModuleContext`
  (parsed AST + source + suppression map), registered via
  :func:`register_rule` and yielding :class:`Violation` records;
* inline suppressions (the reference's syntax):
  ``# reprolint: disable=rule-a,rule-b -- reason`` on the violating line,
  ``# reprolint: disable-file=rule`` anywhere for the whole file;
* the port's baseline (``lint-baseline.json`` beside this file, see
  ``baseline.py``) grandfathers accepted violations without letting new
  ones in.

``python -m repro_torch.analysis.lint`` is the command line (``cli.py``).
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

__all__ = [
    "Violation", "ModuleContext", "Rule", "RULES", "register_rule",
    "lint_source", "lint_file", "lint_paths", "iter_python_files",
    "dotted_name", "DEFAULT_TARGETS", "repo_root",
]

SEVERITIES = ("error", "warning")

# matches "# reprolint: disable=rule-a,rule-b -- optional justification"
_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*(?P<scope>disable|disable-file)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\- ]+)")

# what the command line lints when given no paths (repo-relative; a
# pattern with "*" is a glob): the port, its smoke script, its example
# programs and the recurrent decode A/B script
DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py", "examples/*_torch.py",
                   "scripts/recurrent_decode_ab.py")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``message`` is line-number-free on purpose: the
    baseline matches on (path, rule, message), so a violation keeps its
    identity when unrelated edits shift it up or down the file."""

    rule: str
    path: str              # repo-relative posix path
    line: int
    col: int
    message: str
    severity: str = "error"

    def ident(self) -> tuple:
        return (self.path, self.rule, self.message)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: [{self.rule}] {self.message}")


class ModuleContext:
    """Everything a rule may inspect about one module."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            # a "-- reason" justification shares the character class with
            # rule names; cut it off before splitting (names never have --)
            names = m.group("rules").split("--", 1)[0]
            rules = {r.strip() for r in names.split(",") if r.strip()}
            if m.group("scope") == "disable-file":
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions or "all" in self.file_suppressions:
            return True
        on_line = self.line_suppressions.get(line, ())
        return rule in on_line or "all" in on_line

    def violation(self, rule: "Rule", node, message: str) -> Violation:
        return Violation(rule.name, self.relpath,
                         getattr(node, "lineno", 1),
                         getattr(node, "col_offset", 0) + 1,
                         message, rule.severity)


class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    :meth:`check` yielding violations (suppressions are applied by the
    engine, not the rule)."""

    name: str = ""
    severity: str = "error"
    description: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        raise NotImplementedError


RULES: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and add to the registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if rule.severity not in SEVERITIES:
        raise ValueError(f"rule {rule.name}: bad severity {rule.severity!r}")
    if rule.name in RULES:
        raise ValueError(f"rule {rule.name!r} registered twice")
    RULES[rule.name] = rule
    return cls


def dotted_name(node) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def repo_root() -> str:
    """The repository root (four levels above this file's directory:
    lint, analysis, repro_torch, src)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def _select_rules(only: Optional[Iterable[str]]) -> List[Rule]:
    _load_builtin_rules()
    if only is None:
        return [RULES[n] for n in sorted(RULES)]
    missing = set(only) - set(RULES)
    if missing:
        raise KeyError(f"unknown rule(s) {sorted(missing)}; known: "
                       f"{', '.join(sorted(RULES))}")
    return [RULES[n] for n in sorted(only)]


_RULES_LOADED = False


def _load_builtin_rules() -> None:
    """Import the rule modules exactly once (registration is on import)."""
    global _RULES_LOADED
    if _RULES_LOADED:
        return
    from . import rules_codec, rules_env, rules_hygiene  # noqa: F401
    from . import rules_kernel, rules_torch  # noqa: F401
    _RULES_LOADED = True


def lint_source(source: str, relpath: str = "<string>",
                only: Optional[Iterable[str]] = None,
                respect_suppressions: bool = True) -> List[Violation]:
    """Lint one source string. The workhorse behind :func:`lint_file` and
    the unit-test entry point."""
    rules = _select_rules(only)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("parse-error", relpath, e.lineno or 1,
                          (e.offset or 0) + 1,
                          f"file does not parse: {e.msg}")]
    ctx = ModuleContext(relpath, source, tree)
    out = []
    for rule in rules:
        for v in rule.check(ctx):
            if respect_suppressions and ctx.suppressed(v.rule, v.line):
                continue
            out.append(v)
    return sorted(out, key=lambda v: (v.path, v.line, v.col, v.rule))


def lint_file(path: str, root: Optional[str] = None,
              only: Optional[Iterable[str]] = None) -> List[Violation]:
    root = root or repo_root()
    rel = os.path.relpath(os.path.abspath(path), root)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel, only)


def iter_python_files(paths: Sequence[str], root: Optional[str] = None
                      ) -> List[str]:
    """Expand files, directories and glob patterns into a sorted list of
    ``.py`` files."""
    root = root or repo_root()
    out = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if "*" in full:
            out.extend(f for f in glob.glob(full) if f.endswith(".py"))
            continue
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(set(out))


def lint_paths(paths: Optional[Sequence[str]] = None,
               root: Optional[str] = None,
               only: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint files/directories (default: ``DEFAULT_TARGETS``)."""
    root = root or repo_root()
    files = iter_python_files(paths or DEFAULT_TARGETS, root)
    out = []
    for f in files:
        out.extend(lint_file(f, root, only))
    return out
