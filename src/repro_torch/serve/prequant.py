"""Prequantization and packed checkpoints (port of repro.serve.prequant).

The engine never rematerializes a dense weight: every GEMM weight is packed
once, in ``cfg.quant_format`` (m2xfp: u8 codes + E8M0 scales + 2-bit meta,
4.5 bits per element), and the packed streams are what a checkpoint stores
and what stays on the device.

Packed checkpoints are the reference's on disk (``repro_torch.checkpoint``):
layers stacked on axis 0, a packed weight's streams at
``<path>/.codes`` / ``.scales`` / ``.meta``, and a manifest that records the
format tag and version and the codec. ``load_packed_checkpoint`` refuses a
checkpoint whose codec is not ``cfg.quant_format`` (the streams of two
codecs are not interchangeable), so either package serves what the other
packed:

    packed = prequantize_params(params, cfg)
    save_packed_checkpoint("ckpt/packed", packed, cfg)
    ...
    packed2, extra = load_packed_checkpoint("ckpt/packed", cfg)  # same bytes

``packed_template`` lays the model out on PyTorch's "meta" device, so the
load path allocates no dense weight, only the restored streams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.checkpoint import read_manifest, restore_state, save_state
from repro_torch.convert import flat_leaves, from_flat_leaves, stack_layers
from repro_torch.core.codecs import validate_packed_tree
from repro_torch.models import model as _model

__all__ = [
    "prequantize_params", "init_packed_params", "packed_template",
    "save_packed_checkpoint", "load_packed_checkpoint",
    "prequantize_checkpoint",
]

# v1 predates the codec registry and implies codec="m2xfp"; v2 records the
# codec in the manifest; v3 guarantees a per-leaf CRC-32. v1/v2 checkpoints
# still load; they restore unverified.
_PACKED_TAG = "mx-packed"
_PACKED_VERSION = 3
_LEGACY_TAG = "m2xfp-packed-v1"


def _serve_cfg(cfg):
    return cfg if cfg.quant == "serve" else \
        dataclasses.replace(cfg, quant="serve")


def prequantize_params(params: dict, cfg) -> dict:
    """Dense parameter dict -> packed dict in ``cfg.quant_format``."""
    return _model.pack_params_for_serving(params, _serve_cfg(cfg))


def init_packed_params(gen: torch.Generator, cfg, device="cuda") -> dict:
    """``prequantize_params(init_params(gen, cfg, device), cfg)`` one block
    at a time (``models.model.init_blocks``: an attention layer, a
    recurrent block, the hybrid's shared attention block): the same draws
    and the same bytes, with at most one dense block on the device at once
    (a full-width model's dense weights need not fit beside its packed
    ones)."""
    return _model.build_params(
        gen, cfg, device, lambda group, block: _model.pack_layer_for_serving(
            block, cfg.quant_format, group))


def packed_template(cfg) -> dict:
    """The packed tree ``cfg`` implies, in the reference's layout
    (``convert.stack_layers``), with every leaf a tensor on the "meta"
    device: its keys, shapes and dtypes, and no weight memory
    (``pack_serving_weight`` packs a meta weight by shape alone)."""
    return stack_layers(init_packed_params(torch.Generator(),
                                           _serve_cfg(cfg), "meta"))


def _restore(ckpt_dir, template, cfg, step, verify, device):
    flat, extra = restore_state(ckpt_dir, flat_leaves(template), step,
                                verify=verify)
    return from_flat_leaves(flat, template, cfg, device), extra


def save_packed_checkpoint(ckpt_dir: str, packed: dict, cfg, step: int = 0,
                           extra: Optional[dict] = None,
                           keep: int = 3) -> str:
    """Atomic save of a packed parameter dict in the reference's format.
    Returns the checkpoint directory."""
    meta = {"format": _PACKED_TAG, "format_version": _PACKED_VERSION,
            "codec": cfg.quant_format, "model": cfg.name}
    meta.update(extra or {})
    return save_state(ckpt_dir, step, flat_leaves(stack_layers(packed)),
                      extra=meta, keep=keep)


def load_packed_checkpoint(ckpt_dir: str, cfg, step: Optional[int] = None,
                           shardings=None, verify: bool = True,
                           validate_streams: bool = False,
                           device="cuda") -> Tuple[dict, dict]:
    """Restore a packed checkpoint (the newest step when ``step`` is None)
    as the port's parameter dict on ``device``. Returns (packed,
    manifest extra). Raises ``ValueError`` if the checkpoint was not
    written by ``save_packed_checkpoint`` (of either package) or was packed
    with another codec than ``cfg.quant_format``.

    ``verify``: per-leaf CRC-32 check against the manifest (format v3;
    older manifests restore unverified); a flipped byte raises
    :class:`repro_torch.checkpoint.CheckpointCorruptError` naming the leaf.
    ``validate_streams``: also run the codec's stream validation
    (``repro_torch.core.codecs.validate_packed_tree``: E8M0 scale-byte
    range etc.) on the restored dict and raise ``ValueError`` listing the
    offending leaves -- it catches damage done *before* the checkpoint was
    written, which passes the CRC.
    ``shardings``: optional tree of ``NamedSharding`` on a ``DeviceMesh``
    matching the port's packed dict (``param_shardings`` of it, e.g. of
    ``init_packed_params(..., "meta")``); each restored leaf, packed
    streams included, is placed at its shard (a DTensor) after the CRC
    check and the stream validation."""
    extra = read_manifest(ckpt_dir, step).get("extra", {})
    tag = extra.get("format")
    if tag == _LEGACY_TAG:
        codec = "m2xfp"                    # v1 manifests predate the field
    elif tag == _PACKED_TAG:
        codec = extra.get("codec")
        if codec is None:
            raise ValueError(
                f"{ckpt_dir} is a packed checkpoint (format={tag!r} "
                f"v{extra.get('format_version')}) but its manifest records "
                f"no codec; re-run prequantize_checkpoint to rewrite it")
    else:
        raise ValueError(
            f"{ckpt_dir} is not a packed checkpoint (format={tag!r}); "
            f"run prequantize_checkpoint first")
    if codec != cfg.quant_format:
        raise ValueError(
            f"{ckpt_dir} was packed with codec {codec!r} but "
            f"cfg.quant_format={cfg.quant_format!r}; packed streams are "
            f"not interchangeable between codecs -- load with a matching "
            f"config (dataclasses.replace(cfg, quant_format={codec!r})) "
            f"or re-run prequantize_checkpoint with this one")
    packed, manifest_extra = _restore(ckpt_dir, packed_template(cfg), cfg,
                                      step, verify, device)
    if validate_streams:
        report = validate_packed_tree(packed)
        if report:
            detail = "; ".join(f"{k}: {'; '.join(v)}"
                               for k, v in sorted(report.items()))
            raise ValueError(
                f"{ckpt_dir} restored but {len(report)} packed leaf(s) "
                f"violate codec stream invariants ({detail}); re-run "
                f"prequantize_checkpoint from source weights")
    if shardings is not None:
        from repro_torch.distributed.sharding import place_tree
        packed = place_tree(packed, shardings)
    return packed, manifest_extra


def prequantize_checkpoint(src_dir: str, dst_dir: str, cfg,
                           step: Optional[int] = None, keep: int = 3,
                           device="cuda") -> str:
    """Offline pass: read a dense bf16 checkpoint (the reference's
    ``save_state`` of ``init_params``' tree), pack every GEMM weight on
    ``device``, write a packed checkpoint. The only time dense weights exist
    in memory is inside this converter."""
    template = stack_layers(_model.init_params(torch.Generator(), cfg,
                                               "meta"))
    src_step = read_manifest(src_dir, step)["step"]
    params, _ = _restore(src_dir, template, cfg, src_step, True, device)
    return save_packed_checkpoint(
        dst_dir, prequantize_params(params, cfg), cfg, step=src_step,
        extra={"source": src_dir}, keep=keep)
