"""Prequantization: dense parameters -> packed codec parameters (port of
repro.serve.prequant without its checkpoint functions).

The engine never rematerializes a dense weight: every GEMM weight is packed
once, in ``cfg.quant_format`` (m2xfp: u8 codes + E8M0 scales + 2-bit meta,
4.5 bits per element), and the packed streams are what stays on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as _model

__all__ = ["prequantize_params", "init_packed_params"]


def _serve_cfg(cfg):
    return cfg if cfg.quant == "serve" else \
        dataclasses.replace(cfg, quant="serve")


def prequantize_params(params: dict, cfg) -> dict:
    """Dense parameter dict -> packed dict in ``cfg.quant_format``."""
    return _model.pack_params_for_serving(params, _serve_cfg(cfg))


def init_packed_params(gen: torch.Generator, cfg, device="cuda") -> dict:
    """``prequantize_params(init_params(gen, cfg, device), cfg)`` one layer
    at a time: the same draws and the same bytes, with at most one dense
    layer on the device at once (a full-width model's dense weights need
    not fit beside its packed ones)."""
    params = _model.init_head(gen, cfg, device)
    params["layers"] = [
        _model.pack_layer_for_serving(_model.init_layer(gen, cfg, device),
                                      cfg.quant_format)
        for _ in range(cfg.n_layers)]
    return params
