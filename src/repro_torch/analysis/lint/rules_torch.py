"""host-sync: the decode launch does not wait on the device (the
counterpart of the reference's ``tracer-leak``).

The reference jits its decode launch, so a host read inside it is a
TracerError at trace time. The port runs eagerly: the same read compiles
and runs, and makes the host wait for the card -- the launch's kernels
are then issued one wait at a time, and the device idles between them.
Inside the decode launch's modules (``src/repro_torch/models/``,
``kernels/ops.py``, and ``ServeEngine``'s launch in ``serve/engine.py``:
``_launches``, ``_launch_decode``, ``_launch_prefill``, ``_fetch``) the
rule flags, in function bodies:

* ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()``;
* ``float()`` / ``int()`` / ``bool()`` of a tensor value, and
  ``np.asarray`` / ``np.array`` of one;
* a Python ``if`` / ``while`` on a tensor's value: a ``torch.`` call in the
  test (``torch.is_tensor``-style predicates and ``torch.cuda.*`` aside),
  a value method of a tensor (``.any()``, ``.all()``, ``.sum()``...), or
  a comparison with a tensor operand.

A tensor value is a name bound in the function to a parameter annotated
``torch.Tensor`` or to a ``torch.`` call, or computed from one; its
metadata (``.shape``, ``.dtype``, ``.device``, ``.dim()``, ``len()``...)
is host data and never syncs. Each deliberate sync (the engine's one
copy of a launch's results in ``_fetch``) carries an inline suppression
that says why.

The reference's other two jit rules have no subject in the port:
``donated-reuse`` (PyTorch has no buffer donation) and
``undrained-callback`` (the port makes no asynchronous
``non_blocking=True`` device-to-host copy whose result could be read
before a synchronize).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from .core import ModuleContext, Rule, Violation, dotted_name, register_rule

_SCOPE_DIRS = ("src/repro_torch/models/",)
_SCOPE_FILES = ("src/repro_torch/kernels/ops.py",)
_ENGINE = "src/repro_torch/serve/engine.py"
_ENGINE_LAUNCH = ("_launches", "_launch_decode", "_launch_prefill", "_fetch")

_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_NP_CONVERSIONS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
_CASTS = ("float", "int", "bool")
# tensor metadata: host values, no sync
_META_ATTRS = ("shape", "dtype", "device", "is_cuda", "is_meta", "ndim",
               "layout", "requires_grad", "is_leaf", "names", "T", "mT")
_META_METHODS = ("dim", "size", "numel", "stride", "element_size",
                 "is_contiguous", "is_floating_point", "data_ptr",
                 "get_device", "storage_offset", "nelement")
# methods whose result is a tensor value read as a truth value
_VALUE_METHODS = ("any", "all", "item", "sum", "max", "min", "amax", "amin",
                  "equal", "eq", "ne", "gt", "lt", "ge", "le", "isnan",
                  "isinf", "isfinite", "count_nonzero", "nonzero",
                  "allclose", "abs", "mean")
# torch.* calls that answer on the host
_HOST_TORCH = ("torch.is_tensor", "torch.is_floating_point",
               "torch.is_complex", "torch.is_grad_enabled",
               "torch.is_inference_mode_enabled", "torch.device",
               "torch.finfo", "torch.iinfo", "torch.Size",
               "torch.get_default_dtype")
_TENSOR_ANNOTATIONS = ("torch.Tensor", "Tensor")


def _in_scope(rel: str) -> bool:
    return rel.startswith(_SCOPE_DIRS) or rel in _SCOPE_FILES \
        or rel == _ENGINE


def _functions(ctx: ModuleContext) -> List[ast.AST]:
    """The functions the rule reads: every function of a scoped module,
    or in serve/engine.py the launch functions (nested ones included)."""
    fns = [n for n in ast.walk(ctx.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    if ctx.relpath != _ENGINE:
        return fns
    out = []
    for fn in fns:
        if fn.name in _ENGINE_LAUNCH:
            out.extend(n for n in ast.walk(fn)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
    return out


def _tensor_value(expr, names: Set[str]) -> bool:
    """Whether ``expr`` reads a tensor's value (not only its metadata)."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        if expr.attr in _META_ATTRS:
            return False
        return _tensor_value(expr.value, names)
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Attribute) and fn.attr in _META_METHODS:
            return False
        if isinstance(fn, ast.Name) and fn.id in ("len", "isinstance",
                                                  "type", "id"):
            return False
        name = dotted_name(fn) or ""
        if name in _HOST_TORCH or name.startswith("torch.cuda."):
            return False
        if name.startswith("torch."):
            return True
        # a tensor's method gives a tensor; what another function returns
        # is not known here, and is not taken for a tensor
        return isinstance(fn, ast.Attribute) and _tensor_value(fn.value,
                                                               names)
    if isinstance(expr, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(_tensor_value(c, names) for c in ast.iter_child_nodes(expr))


def _tensor_names(fn) -> Set[str]:
    """Names of ``fn`` bound to tensor values (module docstring), in
    source order, one pass."""
    names = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is not None and dotted_name(a.annotation) \
                in _TENSOR_ANNOTATIONS:
            names.add(a.arg)
    assigns = sorted((n for n in ast.walk(fn)
                      if isinstance(n, (ast.Assign, ast.AnnAssign,
                                        ast.AugAssign))),
                     key=lambda n: (n.lineno, n.col_offset))
    for node in assigns:
        value = node.value
        if value is None or not _tensor_value(value, names):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    return names


def _truth_of_tensor(test, names: Set[str]) -> bool:
    """Whether an ``if`` / ``while`` test reads a tensor's value: a
    ``torch.`` call, a value method of a tensor, a comparison with a
    tensor operand (``is`` and ``in`` aside), or a tensor name taken as a
    truth value (alone, under ``not``, in ``and`` / ``or``)."""
    def bare(t) -> bool:
        if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            return bare(t.operand)
        if isinstance(t, ast.BoolOp):
            return any(bare(v) for v in t.values)
        return isinstance(t, ast.Name) and t.id in names
    if bare(test):
        return True
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            name = dotted_name(n.func) or ""
            if name.startswith("torch.") and name not in _HOST_TORCH \
                    and not name.startswith("torch.cuda."):
                return True
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _VALUE_METHODS \
                    and _tensor_value(n.func.value, names):
                return True
        if isinstance(n, ast.Compare) and not any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in n.ops) and any(
                _tensor_value(o, names) for o in [n.left, *n.comparators]):
            return True
    return False


@register_rule
class HostSyncRule(Rule):
    name = "host-sync"
    description = ("host reads of tensor values (.item(), .cpu(), "
                   "float() of a tensor, a branch on a tensor) inside the "
                   "decode launch's modules")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if not _in_scope(ctx.relpath):
            return
        seen = set()
        for fn in _functions(ctx):
            names = _tensor_names(fn)
            for node in ast.walk(fn):
                if id(node) in seen:
                    continue
                msg = self._finding(node, names, fn.name)
                if msg:
                    seen.add(id(node))
                    yield ctx.violation(self, node, msg)

    @staticmethod
    def _finding(node, names: Set[str], where: str):
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                return (f".{node.func.attr}() in '{where}' copies a tensor "
                        f"to the host and waits for the device; keep it on "
                        f"the device or move the read out of the launch")
            if callee in _NP_CONVERSIONS and node.args \
                    and _tensor_value(node.args[0], names):
                return (f"{callee}() of a tensor in '{where}' copies it to "
                        f"the host and waits for the device")
            if isinstance(node.func, ast.Name) and node.func.id in _CASTS \
                    and len(node.args) == 1 \
                    and _tensor_value(node.args[0], names):
                return (f"{node.func.id}() of a tensor in '{where}' reads "
                        f"its value on the host and waits for the device; "
                        f"keep it a tensor")
        elif isinstance(node, (ast.If, ast.While)) \
                and _truth_of_tensor(node.test, names):
            kind = "if" if isinstance(node, ast.If) else "while"
            return (f"Python `{kind}` on a tensor's value in '{where}' "
                    f"waits for the device; use torch.where or keep the "
                    f"decision on the host")
        return None
