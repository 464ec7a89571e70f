"""codec-contract: static checks over ``Codec(...)`` registrations (port
of the reference's rule, the same messages).

The port's codec registry (``repro_torch.core.codecs``) is the single
format authority for the whole port, so a malformed entry poisons every
layer at once.
What can be checked without running code (per the OCP Microscaling spec
and this repo's stream conventions):

* the mandatory surface: ``name``, ``group``, ``ebw``, and both fake-quant
  hooks;
* path pairing — a packed serving path needs *both* ``encode`` and
  ``decode``; a packed KV path needs ``kv_encode`` + ``kv_decode`` +
  ``kv_spec``; a fused ``kernel`` hook is meaningless without a packed
  path;
* literal sanity — ``group`` ∈ {16, 32} (the port's packing constants:
  ``kernels/layout.py``'s 32-groups and NVFP4's 16-element scale
  groups), ``scale_kind`` ∈ {e8m0, e4m3, f16};
* E8M0 telemetry bounds — a *packed* e8m0 codec must declare
  ``scale_sat_bounds`` and, when literal, they must be (1, 254): the
  encoders clamp exponents to [-126, 127], byte 0 never occurs and byte
  255 is reserved/NaN;
* EBW consistency — when ``ebw`` and ``group`` are numeric literals the
  claimed bits/element must equal 4 (nibble code) + 8/group (one scale
  byte per group) + 2/8 per element of 2-bit subgroup metadata when
  ``has_meta=True``. Entries computed via ``format_ebw(...)`` are checked
  at runtime by the EBW tests instead.

Keywords given through a ``**name`` splat of a module-level ``dict(...)``
or ``{...}`` literal (the port's ``_SGEM``, shared by m2xfp and
m2xfp_ideal6) count as given. The constants are copies of the port's
(this module imports no ``torch``); tests/test_torch_lint.py holds them
to ``repro_torch.kernels.layout``.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import ModuleContext, Rule, Violation, dotted_name, register_rule

_REQUIRED = ("name", "group", "ebw", "fake_quant_weight", "fake_quant_act")
_SCALE_KINDS = ("e8m0", "e4m3", "f16")
_GROUPS = (16, 32)
# bits per element: a 4-bit code, one 8-bit scale per group, 2 bits of
# metadata per SUBGROUP elements (kernels/layout.py's SUBGROUP)
CODE_BITS, SCALE_BITS, META_BITS, SUBGROUP = 4, 8, 2, 8


def _literal(kw_map, key):
    node = kw_map.get(key)
    if isinstance(node, ast.Constant):
        return node.value
    return None


def _tuple_literal(kw_map, key) -> Optional[tuple]:
    node = kw_map.get(key)
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) for e in node.elts):
        return tuple(e.value for e in node.elts)
    return None


def _module_dicts(tree) -> dict:
    """{name: {key: value node}} of the module-level ``name = dict(k=v)``
    and ``name = {"k": v}`` assignments."""
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        if isinstance(v, ast.Call) and dotted_name(v.func) == "dict" \
                and not v.args:
            out[node.targets[0].id] = {k.arg: k.value for k in v.keywords
                                       if k.arg}
        elif isinstance(v, ast.Dict) and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                for k in v.keys):
            out[node.targets[0].id] = {k.value: val for k, val
                                       in zip(v.keys, v.values)}
    return out


@register_rule
class CodecContractRule(Rule):
    name = "codec-contract"
    description = ("Codec(...) registrations missing required surface or "
                   "with metadata inconsistent with the packing constants")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        splats = _module_dicts(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) not in ("Codec", "codecs.Codec"):
                continue
            if not node.keywords:
                continue                      # positional construction: skip
            kw = {}
            for k in node.keywords:
                if k.arg:
                    kw[k.arg] = k.value
                elif isinstance(k.value, ast.Name):
                    kw.update(splats.get(k.value.id, {}))
            yield from self._check_codec(ctx, node, kw)

    def _check_codec(self, ctx, node, kw) -> Iterator[Violation]:
        cname = _literal(kw, "name") or "<codec>"
        missing = [k for k in _REQUIRED if k not in kw]
        if missing:
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: missing required field(s) "
                f"{', '.join(missing)} (every codec must declare name, "
                f"group, ebw and both fake-quant hooks)")
        have_enc, have_dec = "encode" in kw, "decode" in kw
        if have_enc != have_dec:
            got, want = ("encode", "decode") if have_enc else ("decode",
                                                               "encode")
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: {got} given without {want} — the packed "
                f"serving path needs the exact inverse pair")
        kv = [k for k in ("kv_encode", "kv_decode", "kv_spec") if k in kw]
        if kv and len(kv) != 3:
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: partial KV path ({', '.join(kv)}); a "
                f"packed KV cache needs kv_encode + kv_decode + kv_spec")
        if "kernel" in kw and not have_enc:
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: fused kernel hook without a packed "
                f"encode/decode path — nothing can feed it packed streams")
        group = _literal(kw, "group")
        if group is not None and group not in _GROUPS:
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: group={group} but the nibble/meta "
                f"packing constants support groups {_GROUPS}")
        skind = _literal(kw, "scale_kind")
        if skind is not None and skind not in _SCALE_KINDS:
            yield ctx.violation(
                self, node,
                f"codec {cname!r}: scale_kind={skind!r} not in "
                f"{_SCALE_KINDS}")
        bounds = _tuple_literal(kw, "scale_sat_bounds")
        if skind == "e8m0" and have_enc:
            if "scale_sat_bounds" not in kw:
                yield ctx.violation(
                    self, node,
                    f"codec {cname!r}: packed e8m0 codec without "
                    f"scale_sat_bounds — the health telemetry cannot "
                    f"detect scale saturation")
            elif bounds is not None and bounds != (1, 254):
                yield ctx.violation(
                    self, node,
                    f"codec {cname!r}: e8m0 scale_sat_bounds={bounds} but "
                    f"the encoders clamp exponents to [-126, 127] (bytes "
                    f"[1, 254]; 0 never occurs, 255 is reserved/NaN)")
        ebw = _literal(kw, "ebw")
        if isinstance(ebw, (int, float)) and isinstance(group, int) \
                and group > 0:
            meta = _literal(kw, "has_meta")
            expect = CODE_BITS + SCALE_BITS / group + (
                META_BITS / SUBGROUP if meta is True else 0.0)
            if abs(float(ebw) - expect) > 1e-9:
                yield ctx.violation(
                    self, node,
                    f"codec {cname!r}: literal ebw={ebw} inconsistent with "
                    f"its streams — 4-bit nibbles + one scale byte per "
                    f"{group}-group"
                    + (" + 2-bit subgroup metadata" if meta is True else "")
                    + f" = {expect} bits/element")
