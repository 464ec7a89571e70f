"""Typed registry of the port's ``REPRO_*`` environment flags (the part of
repro.core.envflags the port needs: the string flags ``REPRO_OBS`` and
``REPRO_OBS_DIR``).

A flag is *declared* once (name, type, default, docstring) and *read*
through the accessors, which re-read the environment on every call, so
tests can monkeypatch ``os.environ`` freely and nothing is cached behind
their back. Every flag read of the port goes through this module: a flag
the port comes to read is declared here, with the reference's parsing
and error text (its int and bool kinds, ``choices`` and ``minimum``, are
not copied until a flag needs them).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

__all__ = ["EnvFlag", "declare", "defined_flags", "get_raw", "get_str"]


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One declared environment flag."""

    name: str
    kind: str                                # "str"
    default: Any
    help: str


_FLAGS: Dict[str, EnvFlag] = {}


def declare(name: str, kind: str, default: Any, help: str) -> EnvFlag:
    """Register a flag. Redeclaring with an identical spec is a no-op; a
    conflicting spec is an error."""
    if kind != "str":
        raise ValueError(f"flag {name!r}: kind must be one of ('str',), "
                         f"got {kind!r}")
    flag = EnvFlag(name, kind, default, help)
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


def get_str(name: str) -> Optional[str]:
    """Read of a declared string flag: its default when unset."""
    flag = _flag(name)
    raw = os.environ.get(name)
    return flag.default if raw is None else raw


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
