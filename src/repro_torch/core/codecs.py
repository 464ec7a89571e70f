"""Codec registry and packed container (port of repro.core.codecs).

One :class:`Codec` record per format, looked up by name, carries what the
serve path needs: the activation fake-quant, the packed weight encoder and
its exact decoder, and the fused dequant-GEMM. The slice
registers the paper's format ``m2xfp`` and its baseline ``mxfp4``.

Packed-stream conventions (shared with ``repro_torch.kernels.layout``):

  * ``encode(w)``: (K, N) -> dict of 2-D u8 streams, groups along K,
    nibbles group-half interleaved (K % 32 == 0) -- the reference's bytes;
  * ``decode(streams, k, n)``: exact inverse to f32 (K, N);
  * ``decode_dtype``: bf16 -- every decoded E8M0-scaled value fits it;
  * ``kernel(x, streams)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import layout, ops, ref
from .formats import quantize_mxfp4
from .m2xfp import quantize_act_m2xfp

__all__ = [
    "Codec", "PackedTensor", "register_codec", "get_codec", "list_codecs",
    "packed_codecs", "kernel_codecs",
]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One MX-family format: fake-quant always, packed paths optional."""

    name: str
    fake_quant_act: Callable[[torch.Tensor], torch.Tensor]
    encode: Optional[Callable] = None        # (K, N) -> {name: u8 2-D}
    decode: Optional[Callable] = None        # (streams, k, n) -> f32 (K, N)
    decode_dtype: torch.dtype = torch.bfloat16
    kernel: Optional[Callable] = None        # fused dequant-GEMM

    @property
    def packed(self) -> bool:
        return self.encode is not None


_REGISTRY: dict = {}


def register_codec(codec: Codec) -> Codec:
    """Add a codec to the registry."""
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    """Registry lookup; unknown names raise listing every registered codec."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered codecs: "
                         f"{', '.join(list_codecs())}") from None


def list_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def packed_codecs() -> Tuple[str, ...]:
    """Codecs with a packed serving-weight path."""
    return tuple(n for n in list_codecs() if _REGISTRY[n].packed)


def kernel_codecs() -> Tuple[str, ...]:
    """Codecs with a fused dequant-GEMM."""
    return tuple(n for n in list_codecs() if _REGISTRY[n].kernel is not None)


class PackedTensor:
    """Packed weight tagged with its codec: ``streams`` maps a stream name
    (``codes``/``scales``/``meta``) to a u8 tensor, ``shape`` is the
    logical dense (K, N) shape."""

    def __init__(self, streams: dict, shape, codec: str = "m2xfp"):
        self.streams = dict(streams)
        self.shape = tuple(shape)
        self.codec = codec

    def __getitem__(self, key):
        return self.streams[key]

    def __repr__(self):
        return (f"PackedTensor(codec={self.codec!r}, shape={self.shape}, "
                f"streams={list(self.streams)})")


def _decode_sgem(streams: dict, k: int, n: int) -> torch.Tensor:
    """Sg-EM-2bit decode: fp4 * (1 + meta/4) * 2^(scale-127), f32 (K, N)."""
    return ref.decode_w_sgem_ref(streams).reshape(k, n)


def _decode_mxfp4(streams: dict, k: int, n: int) -> torch.Tensor:
    """MXFP4 decode: fp4 * 2^(scale-127), f32 (K, N)."""
    return ref.decode_w_mxfp4_ref(streams).reshape(k, n)


register_codec(Codec(
    name="m2xfp",
    fake_quant_act=quantize_act_m2xfp,
    encode=layout.pack_w_sgem, decode=_decode_sgem,
    kernel=ops.m2xfp_matmul))

register_codec(Codec(
    name="mxfp4",
    fake_quant_act=quantize_mxfp4,
    encode=layout.pack_w_mxfp4, decode=_decode_mxfp4,
    kernel=ops.mxfp4_matmul))
