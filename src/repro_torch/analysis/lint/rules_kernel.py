"""kernel-contract: the port's CUDA launch invariants (the counterpart of
the reference's Pallas rule).

The hazards the reference's rule guards against have the same shape on
the card, but the launch is split in two: a Python wrapper in
``src/repro_torch/kernels/*.py`` checks the operands and calls
``Binding.launch`` with the sizes, and the C host function of the
``csrc`` source it binds computes the grid and launches. So:

* **Grid remainders, Python side** -- a launch wrapper (a function that
  calls ``<kernel>.launch(...)``) that sizes something with a plain
  ``a // b`` must guard divisibility: a ``%`` check that raises or
  asserts, a call of ``check_k`` (``kernels/_build.py``: raises on
  K % 32), or a ceil-div (``-(-a // b)``). A non-dividing size would
  silently drop the remainder rows.
* **Explicit launch geometry, C side** -- in the ``.cu`` source that a
  wrapper binds (and the ``.cuh`` files it includes), every
  ``cudaLaunchConfig_t`` sets both ``gridDim`` and ``blockDim``, and every
  division in a grid expression (a ``dim3`` grid, ``gridDim = ...`` or a
  ``<<<`` launch's first argument) is a ceil-div ``(a + b - 1) / b``,
  unless the binding module guards the divisor's remainder in Python as
  above (the K / 32 of the quantize engine's grid).
* **Accumulation width** -- the kernels accumulate in f32, and their
  plain versions (``kernels/ref.py``), which the tests and chip_smoke
  hold them to, must not accumulate narrower: no product there
  (``torch.matmul`` / ``mm`` / ``bmm`` / ``einsum``, the methods, ``@``)
  takes an operand cast to bf16 or f16 (``.to(bf16)``, ``.bfloat16()``,
  ``.half()``) as it is handed to the product.

The C side is read as text (the rule has no C++ parser): a source it
cannot find (a fixture linted by itself) is not checked.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Optional, Set

from .core import (ModuleContext, Rule, Violation, dotted_name,
                   register_rule, repo_root)

_KERNELS = "src/repro_torch/kernels/"
_REF = "src/repro_torch/kernels/ref.py"
_CSRC = ("src", "repro_torch", "csrc")
_GUARD_CALLS = ("check_k",)
_PRODUCTS = ("torch.matmul", "torch.mm", "torch.bmm", "torch.einsum")
_PRODUCT_METHODS = ("matmul", "mm", "bmm")
_NARROW = ("bfloat16", "float16", "half")
_NARROW_METHODS = ("bfloat16", "half")

# a ceil-div "(a + b - 1) / b" (b an identifier, maybe qualified), or
# with a literal divisor "(a + 63) / 64"
_CEIL_RE = re.compile(r"\(\s*[^()]*?\+\s*([\w:]+)\s*-\s*1\s*\)\s*/\s*\1\b")
_CEIL_LIT_RE = re.compile(r"\(\s*[^()]*?\+\s*(\d+)\s*\)\s*/\s*(\d+)\b")
_INCLUDE_RE = re.compile(r'#include\s+"([^"]+)"')


def _floordivs(fn) -> List[ast.BinOp]:
    """The plain ``a // b`` of ``fn`` (a ceil-div's inner one excluded)."""
    ceil: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = node.operand
            if isinstance(v, ast.BinOp) and isinstance(v.op, ast.FloorDiv) \
                    and isinstance(v.left, ast.UnaryOp) \
                    and isinstance(v.left.op, ast.USub):
                ceil.add(id(v))
    return [n for n in ast.walk(fn) if isinstance(n, ast.BinOp)
            and isinstance(n.op, ast.FloorDiv) and id(n) not in ceil]


def _raises(body) -> bool:
    return any(isinstance(n, ast.Raise) for s in body for n in ast.walk(s))


def _remainder_guarded(fn) -> bool:
    """Whether ``fn`` checks a remainder and raises (or asserts), or calls
    a known guard."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and (
                (dotted_name(node.func) or "").rsplit(".", 1)[-1]
                in _GUARD_CALLS):
            return True
        if isinstance(node, (ast.Assert, ast.If)) and any(
                isinstance(s, ast.BinOp) and isinstance(s.op, ast.Mod)
                for s in ast.walk(node.test)):
            if isinstance(node, ast.Assert) or _raises(node.body):
                return True
    return False


def _launches(fn) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "launch" for n in ast.walk(fn))


def _bound_sources(tree) -> List[ast.Constant]:
    """The csrc kernel names a module binds: the string literal handed to
    ``CudaKernel(...)`` or to ``super().__init__(...)`` in a class whose
    bases name ``Binding``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and dotted_name(node.func) == "CudaKernel":
            out.append(node.args[0])
        if isinstance(node, ast.ClassDef) and any(
                (dotted_name(b) or "").endswith("Binding")
                for b in node.bases):
            for call in ast.walk(node):
                if isinstance(call, ast.Call) and isinstance(
                        call.func, ast.Attribute) \
                        and call.func.attr == "__init__" and call.args \
                        and isinstance(call.args[0], ast.Constant) \
                        and isinstance(call.args[0].value, str):
                    out.append(call.args[0])
    return out


def _source_text(name: str) -> Optional[str]:
    """``csrc/<name>.cu`` with its local includes, or None."""
    base = os.path.join(repo_root(), *_CSRC)
    path = os.path.join(base, f"{name}.cu")
    if not os.path.isfile(path):
        return None
    seen, parts, todo = set(), [], [path]
    while todo:
        p = todo.pop()
        if p in seen or not os.path.isfile(p):
            continue
        seen.add(p)
        with open(p, encoding="utf-8") as f:
            text = f.read()
        parts.append(text)
        todo.extend(os.path.join(base, i) for i in _INCLUDE_RE.findall(text))
    return "\n".join(parts)


def _grid_exprs(text: str) -> List[str]:
    """The grid expressions of a CUDA source: ``dim3 <grid...>(...)``,
    ``gridDim = ...`` and the first argument of each ``<<<`` launch (or
    the right-hand side that defines it)."""
    out = re.findall(r"dim3\s+\w*grid\w*\s*\(([^;]*)\)\s*;", text, re.I)
    out += re.findall(r"gridDim\s*=\s*([^;]*);", text)
    for arg in re.findall(r"<<<\s*([^,>]+),", text):
        arg = arg.strip()
        if re.fullmatch(r"\w+", arg):
            m = re.search(rf"\b{arg}\s*=\s*([^;]*);", text)
            out.append(m.group(1) if m else arg)
        else:
            out.append(arg)
    return out


def _plain_division(expr: str) -> bool:
    prev = None
    while prev != expr:                       # strip nested ceil-divs
        prev, expr = expr, _CEIL_RE.sub("0", expr)
        expr = _CEIL_LIT_RE.sub(
            lambda m: "0" if int(m.group(2)) == int(m.group(1)) + 1
            else m.group(0), expr)
    return "/" in expr


def _narrowing(node, aliases: Set[str]) -> bool:
    """Whether ``node`` is a cast to bf16 or f16 as it stands."""
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                        ast.Attribute):
        return False
    if node.func.attr in _NARROW_METHODS and not node.args:
        return True
    if node.func.attr != "to":
        return False
    for a in list(node.args) + [k.value for k in node.keywords
                                if k.arg == "dtype"]:
        name = dotted_name(a) or ""
        if name in aliases or name.rsplit(".", 1)[-1] in _NARROW:
            return True
    return False


def _narrow_aliases(fn) -> Set[str]:
    """Local names bound to ``torch.bfloat16`` / ``torch.float16``."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            pairs = []
            for t in node.targets:
                if isinstance(t, ast.Tuple) and isinstance(node.value,
                                                           ast.Tuple):
                    pairs += list(zip(t.elts, node.value.elts))
                else:
                    pairs.append((t, node.value))
            for t, v in pairs:
                if isinstance(t, ast.Name) and (dotted_name(v) or "") \
                        .rsplit(".", 1)[-1] in _NARROW:
                    out.add(t.id)
    return out


def _product_operands(node) -> List[ast.AST]:
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return [node.left, node.right]
    if not isinstance(node, ast.Call):
        return []
    name = dotted_name(node.func) or ""
    if name in _PRODUCTS:
        return list(node.args[1:] if name == "torch.einsum" else node.args)
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _PRODUCT_METHODS and name not in _PRODUCTS:
        return [node.func.value] + list(node.args)
    return []


@register_rule
class KernelContractRule(Rule):
    name = "kernel-contract"
    description = ("CUDA launch wrappers must guard grid remainders, the "
                   "bound sources spell out grid and block, and the plain "
                   "products accumulate in f32 or wider")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        rel = ctx.relpath
        if not rel.startswith(_KERNELS):
            return
        fns = [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        guarded = False
        for fn in fns:
            if not _launches(fn):
                continue
            ok = _remainder_guarded(fn)
            guarded = guarded or ok
            bad = _floordivs(fn)
            if bad and not ok:
                yield ctx.violation(
                    self, bad[0],
                    f"launch wrapper '{fn.name}' sizes with plain floordiv "
                    f"and no divisibility guard; a non-dividing size "
                    f"silently drops the remainder -- raise on "
                    f"misalignment (check_k) or ceil-divide")
        for lit in _bound_sources(ctx.tree):
            text = _source_text(lit.value)
            if text is None:
                continue
            for cfg in re.findall(r"cudaLaunchConfig_t\s+(\w+)", text):
                for field in ("gridDim", "blockDim"):
                    if not re.search(rf"\b{cfg}\.{field}\s*=", text):
                        yield ctx.violation(
                            self, lit,
                            f"csrc/{lit.value}.cu: launch config '{cfg}' "
                            f"never sets {field}; spell out the launch "
                            f"geometry")
            if not guarded and any(_plain_division(g)
                                   for g in _grid_exprs(text)):
                yield ctx.violation(
                    self, lit,
                    f"csrc/{lit.value}.cu: a grid expression divides "
                    f"without a ceil-div and the wrapper guards no "
                    f"remainder; a non-dividing size drops its remainder "
                    f"block")
        if rel == _REF:
            for fn in fns:
                aliases = _narrow_aliases(fn)
                for node in ast.walk(fn):
                    if any(_narrowing(o, aliases)
                           for o in _product_operands(node)):
                        yield ctx.violation(
                            self, node,
                            f"product in plain version '{fn.name}' takes a "
                            f"bf16/f16 operand; the kernels accumulate in "
                            f"f32, their plain versions in f32 or wider")
