"""Architecture registry of the port: the configurations it can serve."""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = ("olmoe-1b-7b", "mixtral-8x22b", "qwen2.5-14b", "qwen2-0.5b",
         "gemma2-9b", "qwen3-8b", "musicgen-large", "pixtral-12b",
         "paper-llama2-7b", "xlstm-125m", "zamba2-7b")

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-8b": "qwen3_8b",
    "musicgen-large": "musicgen_large",
    "pixtral-12b": "pixtral_12b",
    "paper-llama2-7b": "paper_llama2_7b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-7b": "zamba2_7b",
}


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
