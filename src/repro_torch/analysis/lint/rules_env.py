"""env-hygiene: REPRO_* reads must go through repro_torch.core.envflags
(port of the reference's rule).

Raw ``os.environ`` reads each re-implement parsing ("1" vs truthy, int
validation, choice checking) and drift apart; the typed accessor module
declares every flag once (name, type, default, docstring) and
``--list-env`` renders the table from it. *Writes*
(``os.environ[...] = ...``, ``setdefault`` in launchers, test
monkeypatching) are deliberately exempt -- setting a flag is
configuration, reading one is behavior.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import ModuleContext, Rule, Violation, dotted_name, register_rule

# the one module allowed to touch os.environ for REPRO_* reads
_ALLOWED = ("src/repro_torch/core/envflags.py",)
_MODULE = "repro_torch.core.envflags"

_READ_CALLS = ("os.environ.get", "environ.get", "os.getenv", "getenv")
_ENV_OBJS = ("os.environ", "environ")


def _repro_key(node) -> str:
    """The literal env-var name if it is a REPRO_* string constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("REPRO_"):
        return node.value
    return ""


@register_rule
class EnvHygieneRule(Rule):
    name = "env-hygiene"
    description = (f"REPRO_* environment reads outside {_MODULE} (use the "
                   f"typed get_bool/get_int/get_str accessors)")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.relpath.replace("\\", "/") in _ALLOWED:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                fn = dotted_name(node.func)
                if fn in _READ_CALLS and node.args:
                    key = _repro_key(node.args[0])
                    if key:
                        yield ctx.violation(
                            self, node,
                            f"raw environment read of {key}: declare it in "
                            f"{_MODULE} and use the typed accessor")
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and dotted_name(node.value) in _ENV_OBJS:
                key = _repro_key(node.slice)
                if key:
                    yield ctx.violation(
                        self, node,
                        f"raw environment read of {key}: declare it in "
                        f"{_MODULE} and use the typed accessor")
            elif isinstance(node, ast.Compare) \
                    and len(node.comparators) == 1 \
                    and isinstance(node.ops[0], ast.In) \
                    and dotted_name(node.comparators[0]) in _ENV_OBJS:
                key = _repro_key(node.left)
                if key:
                    yield ctx.violation(
                        self, node,
                        f"membership test on {key} in os.environ: declare "
                        f"it in {_MODULE} and use the typed accessor")
