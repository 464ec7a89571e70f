"""Architecture registry of the port: the configurations it can serve."""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = ("paper-llama2-7b",)

_MODULES = {"paper-llama2-7b": "paper_llama2_7b"}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides):
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(name: str, **overrides):
    cfg = _module(name).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
