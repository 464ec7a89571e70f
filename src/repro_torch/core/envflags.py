"""Typed registry of the port's ``REPRO_*`` environment flags (port of
repro.core.envflags): the string flags ``REPRO_OBS``, ``REPRO_OBS_DIR``,
``REPRO_KV_QUANT``, ``REPRO_RULES_JSON`` and ``REPRO_REMAT_POLICY``, the
int flags ``REPRO_MOE_GROUP``, ``REPRO_ATTN_KV_CHUNK`` and
``REPRO_ATTN_Q_TILE``, and the bool flags ``REPRO_GATHER_PACKED`` and
``REPRO_BF16_TP_REDUCE``.

Two of the reference's flags have no counterpart: ``REPRO_SERVE_KERNEL``
and ``REPRO_FAITHFUL_DOTS`` choose between XLA lowerings (the Pallas
kernel or the XLA decode mirror; bf16 or f32 dot operands in the lowered
HLO). The port has no lowering to choose: a product picks its kernel by
the tensor's device (a CUDA tensor runs the hand-written kernel, a CPU
tensor its plain version, ``models/quant.py``) and keeps bf16 operands
with f32 accumulation on both (``models/numerics.py``).

A flag is *declared* once (name, type, default, docstring, a string's
``choices``, an int's ``minimum``) and *read* through the accessors, which
re-read the environment on every call, so tests can monkeypatch
``os.environ`` freely and nothing is cached behind their back. Every flag
read of the port goes through this module: a flag the port comes to read
is declared here, with the reference's parsing and error text.

Parsing (the reference's):
  * ``bool`` -- true only for the raw value ``"1"``; unset, empty or
    anything else is false;
  * ``int`` -- unset returns the default (None for an optional flag), a
    non-integer or a value below ``minimum`` raises ``ValueError``
    (``env_int``);
  * ``str`` -- unset returns the default; with ``choices`` declared, any
    other raw value (``""`` included) raises ``ValueError`` listing them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

__all__ = ["EnvFlag", "declare", "defined_flags", "get_raw", "get_str",
           "get_int", "get_bool", "env_int", "markdown_table"]

_KINDS = ("bool", "int", "str")


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One declared environment flag."""

    name: str
    kind: str                                # "bool" | "int" | "str"
    default: Any
    help: str
    choices: Optional[Tuple[str, ...]] = None   # str flags only
    minimum: Optional[int] = None               # int flags only


_FLAGS: Dict[str, EnvFlag] = {}


def declare(name: str, kind: str, default: Any, help: str, *,
            choices: Optional[Tuple[str, ...]] = None,
            minimum: Optional[int] = None) -> EnvFlag:
    """Register a flag. Redeclaring with an identical spec is a no-op; a
    conflicting spec is an error."""
    if kind not in _KINDS:
        raise ValueError(f"flag {name!r}: kind must be one of {_KINDS}, "
                         f"got {kind!r}")
    flag = EnvFlag(name, kind, default, help, choices=choices,
                   minimum=minimum)
    prev = _FLAGS.get(name)
    if prev is not None and prev != flag:
        raise ValueError(f"flag {name!r} already declared with a different "
                         f"spec: {prev} vs {flag}")
    _FLAGS[name] = flag
    return flag


def defined_flags() -> Tuple[EnvFlag, ...]:
    """Every declared flag, sorted by name."""
    return tuple(_FLAGS[n] for n in sorted(_FLAGS))


def _flag(name: str) -> EnvFlag:
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(
            f"environment flag {name!r} is not declared in "
            f"repro_torch.core.envflags; declared flags: "
            f"{', '.join(sorted(_FLAGS)) or '(none)'}") from None


def get_raw(name: str) -> Optional[str]:
    """Unparsed read of a declared flag (None when unset), for a flag with
    a grammar of its own (the REPRO_OBS pillar list)."""
    _flag(name)
    return os.environ.get(name)


def _kind_checked(name: str, kind: str) -> EnvFlag:
    flag = _flag(name)
    if flag.kind != kind:
        raise TypeError(f"flag {name!r} is declared {flag.kind!r}, "
                        f"not {kind!r}")
    return flag


def env_int(name: str, default: Optional[int],
            minimum: Optional[int] = 1) -> Optional[int]:
    """Integer read of ``name`` with the reference's validation (usable for
    a variable that is not a declared flag): unset gives ``default``; a
    non-integer or a value below ``minimum`` raises ``ValueError`` -- a
    zero or negative chunk or tile would break the tiling far from the
    setting."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: not an integer (unset it for the default "
            f"{default})") from None
    if minimum is not None and v < minimum:
        raise ValueError(
            f"{name}={raw!r}: must be >= {minimum}; unset it for the "
            f"default {default}")
    return v


def get_str(name: str) -> Optional[str]:
    """Read of a declared string flag: its default when unset; a value
    outside its ``choices`` raises ``ValueError`` listing them."""
    flag = _kind_checked(name, "str")
    raw = os.environ.get(name)
    if raw is None:
        return flag.default
    if flag.choices is not None and raw not in flag.choices:
        raise ValueError(
            f"{name}={raw!r}: expected one of "
            f"{', '.join(repr(c) for c in flag.choices)}")
    return raw


def get_int(name: str) -> Optional[int]:
    """Read of a declared int flag (``env_int`` with its default and
    minimum)."""
    flag = _kind_checked(name, "int")
    return env_int(name, flag.default, flag.minimum)


def get_bool(name: str) -> bool:
    """Read of a declared bool flag: true only for ``"1"``."""
    _kind_checked(name, "bool")
    return os.environ.get(name, "") == "1"


def markdown_table() -> str:
    """The declared flag surface as a markdown table, in the reference's
    form (rendered by ``python -m repro_torch.analysis.lint --list-env``)."""
    rows = ["| Flag | Type | Default | Description |",
            "| --- | --- | --- | --- |"]
    for f in defined_flags():
        extra = ""
        if f.choices:
            extra = " One of: " + ", ".join(f"`{c}`" for c in f.choices) + "."
        if f.minimum is not None and f.kind == "int":
            extra += f" Minimum {f.minimum}."
        default = "(unset)" if f.default in (None, "") else f"`{f.default}`"
        help_text = " ".join(f.help.split())
        rows.append(f"| `{f.name}` | {f.kind} | {default} | "
                    f"{help_text}{extra} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# The port's flag surface (the reference's declarations of these flags)
# ---------------------------------------------------------------------------

declare("REPRO_OBS", "str", "",
        "Observability master switch: unset/''/'0' all off, '1' every "
        "pillar, or a comma list of pillars (metrics, trace, health) — "
        "parsed by repro_torch.obs.registry.")
declare("REPRO_OBS_DIR", "str", "",
        "When set, components that finish a unit of work drop "
        "metrics.jsonl + trace.json snapshots there "
        "(repro_torch.obs.autodump).")
declare("REPRO_KV_QUANT", "str", "none",
        "KV-cache codec for the dry-run's serve cells: 'none' or a "
        "kv-capable codec name from repro_torch.core.codecs (e.g. "
        "'m2xfp').")
declare("REPRO_MOE_GROUP", "int", None,
        "Override moe_group_size for dry-run train cells (expert-group "
        "size of the MoE dispatch).", minimum=1)
declare("REPRO_RULES_JSON", "str", None,
        "JSON object of logical-sharding rule overrides for the dry-run, "
        "e.g. '{\"fsdp\": null, \"mlp\": [\"data\",\"model\"]}'.")
declare("REPRO_REMAT_POLICY", "str", "none",
        "Checkpoint policy of remat'd blocks (cfg.remat): 'none' keeps "
        "only block inputs, 'dots' keeps every matrix product's output, "
        "'dots_no_batch' keeps the products without batch axes (the "
        "weight projections).",
        choices=("none", "dots", "dots_no_batch"))
declare("REPRO_ATTN_KV_CHUNK", "int", 512,
        "KV-chunk length of the streaming train/prefill attention (read "
        "at import of repro_torch.models.attention).", minimum=1)
declare("REPRO_ATTN_Q_TILE", "int", 1024,
        "Query-tile length of train/prefill attention (pairs with "
        "REPRO_ATTN_KV_CHUNK).", minimum=1)
declare("REPRO_GATHER_PACKED", "bool", False,
        "Gather packed u8 weight streams along the weight-shard ('fsdp') "
        "axis before decoding, instead of the decoded weight "
        "(models/quant.py::decode_serving_weight).")
declare("REPRO_BF16_TP_REDUCE", "bool", False,
        "Round a row-parallel partial sum to bf16 before its "
        "tensor-parallel all-reduce, which then moves half the bytes "
        "(distributed/tp.py).")
