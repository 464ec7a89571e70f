"""General hygiene rules: bare excepts, mutable default arguments, and
missing ``__all__`` exports on public ``repro_torch.*`` package surfaces
(port of the reference's rules, the same messages).

* ``bare-except`` — ``except:`` swallows KeyboardInterrupt/SystemExit and
  masks real faults as recoverable; the fault-tolerant serving path
  depends on exception *types* (TransientStepError vs everything else) to
  decide retry-vs-fail, so a blanket handler can turn a real fault into a
  silent retry loop (the port's guard, ``serve/guard.py``, dispatches the
  same way). Catch a concrete type, or ``Exception`` with a
  justifying comment.
* ``mutable-default`` — a ``def f(x=[])`` default is shared across calls;
  with config/stream dicts that means cross-request state bleed in the
  engine.
* ``missing-all`` — a package ``__init__.py`` under ``src/repro_torch``
  that re-exports names without declaring ``__all__`` has no
  machine-readable public surface; ``from repro_torch.x import *`` users
  see whatever happens to be imported, including transitive modules.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import ModuleContext, Rule, Violation, register_rule

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CALLS = ("list", "dict", "set", "bytearray", "defaultdict",
                  "OrderedDict", "Counter", "deque")


@register_rule
class BareExceptRule(Rule):
    name = "bare-except"
    description = "bare `except:` handlers (mask SystemExit and fault types)"

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield ctx.violation(
                    self, node,
                    "bare `except:` catches KeyboardInterrupt/SystemExit "
                    "and erases the exception type the fault-handling "
                    "paths dispatch on; catch a concrete exception class")


@register_rule
class MutableDefaultRule(Rule):
    name = "mutable-default"
    description = "mutable default argument values shared across calls"

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            defaults = list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]
            for d in defaults:
                bad = isinstance(d, _MUTABLE_LITERALS)
                if isinstance(d, ast.Call) and isinstance(d.func, ast.Name) \
                        and d.func.id in _MUTABLE_CALLS:
                    bad = True
                if bad:
                    name = getattr(fn, "name", "<lambda>")
                    yield ctx.violation(
                        self, d,
                        f"mutable default argument in '{name}' is shared "
                        f"across calls; default to None and construct "
                        f"inside the body")


@register_rule
class MissingAllRule(Rule):
    name = "missing-all"
    severity = "warning"
    description = ("public repro_torch.* package __init__ re-exports "
                   "without an __all__ declaration")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        rel = ctx.relpath.replace("\\", "/")
        if not (rel.startswith("src/repro_torch/")
                and rel.endswith("__init__.py")):
            return
        public = []
        has_all = False
        for node in ctx.tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        if t.id == "__all__":
                            has_all = True
                        elif not t.id.startswith("_"):
                            public.append(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                if not node.name.startswith("_"):
                    public.append(node.name)
            elif isinstance(node, ast.ImportFrom):
                public.extend(a.asname or a.name for a in node.names
                              if not (a.asname or a.name).startswith("_")
                              and a.name != "*")
        if public and not has_all:
            yield Violation(
                self.name, ctx.relpath, 1, 1,
                f"package __init__ exposes {len(public)} public name(s) "
                f"but declares no __all__; declare the intended public "
                f"surface", self.severity)
