"""Typed registry of the port's ``REPRO_*`` environment flags (the part of
repro.core.envflags the port needs: the string flags ``REPRO_OBS``,
``REPRO_OBS_DIR``, ``REPRO_KV_QUANT`` and ``REPRO_RULES_JSON``, and the
int flag ``REPRO_MOE_GROUP``).

A flag is *declared* once (name, type, default, docstring, an int's
``minimum``) and *read* through the accessors, which re-read the
environment on every call, so tests can monkeypatch ``os.environ`` freely
and nothing is cached behind their back. Every flag read of the port goes
through this module: a flag the port comes to read is declared here, with
the reference's parsing and error text (its bool kind and ``choices`` are
not copied until a flag needs them).

Parsing: ``str`` -- unset returns the default; ``int`` -- unset returns
the default (None for an optional flag), a non-integer or a value below
``minimum`` raises ``ValueError`` with the reference's message.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

__all__ = ["EnvFlag", "declare", "defined_flags", "get_raw", "get_str",
           "get_int"]

_KINDS = ("int", "str")


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One declared environment flag."""

    name: str
    kind: str                                # "int" | "str"
    default: Any
    help: str
    minimum: Optional[int] = None            # int flags only


_FLAGS: Dict[str, EnvFlag] = {}


def declare(name: str, kind: str, default: Any, help: str, *,
            minimum: Optional[int] = None) -> EnvFlag:
    """Register a flag. Redeclaring with an identical spec is a no-op; a
    conflicting spec is an error."""
    if kind not in _KINDS:
        raise ValueError(f"flag {name!r}: kind must be one of {_KINDS}, "
                         f"got {kind!r}")
    flag = EnvFlag(name, kind, default, help, minimum=minimum)
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


def get_str(name: str) -> Optional[str]:
    """Read of a declared string flag: its default when unset."""
    flag = _kind_checked(name, "str")
    raw = os.environ.get(name)
    return flag.default if raw is None else raw


def get_int(name: str) -> Optional[int]:
    """Read of a declared int flag: its default when unset; a non-integer
    or a value below its ``minimum`` raises ``ValueError``."""
    flag = _kind_checked(name, "int")
    raw = os.environ.get(name)
    if raw is None:
        return flag.default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: not an integer (unset it for the default "
            f"{flag.default})") from None
    if flag.minimum is not None and v < flag.minimum:
        raise ValueError(
            f"{name}={raw!r}: must be >= {flag.minimum}; unset it for the "
            f"default {flag.default}")
    return v


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
