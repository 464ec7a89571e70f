"""Quantized linear layers of the serve path (port of repro.models.quant).

Modes (``ModelConfig.quant``):
  none  : plain bf16 GEMM with f32 accumulation.
  serve : the weight is a packed :class:`PackedTensor` resident on the
          device at its codec's bits per element; the activations are
          fake-quantized online with the same codec and rounded to bf16.
          A codec with a fused dequant-GEMM (``kernel_codecs()``) takes
          it -- the hand-written CUDA kernel for a CUDA tensor, its plain
          version for a CPU tensor; one without (nvfp4) decodes the weight
          in its exact dtype and multiplies (``dot_f32acc``), as the
          reference's decode mirror does.

Training's ``qat`` mode is not ported yet. Every format decision goes
through the codec registry (``repro_torch.core.codecs``):
``fake_quant_weight`` / ``fake_quant_act`` look a codec up by name.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.codecs import PackedTensor, get_codec, packed_codecs
from repro_torch.kernels.ops import packed_matmul
from .numerics import dot_f32acc

__all__ = [
    "fake_quant_weight", "fake_quant_act", "init_linear",
    "pack_serving_weight", "decode_serving_weight", "quantized_matmul",
    "PackedTensor",
]


def fake_quant_weight(w: torch.Tensor, fmt: str = "m2xfp") -> torch.Tensor:
    """Weight fake-quant along the contraction (first) axis."""
    wt = w.reshape(w.shape[0], -1).T        # (out, in): groups along in-dim
    return get_codec(fmt).fake_quant_weight(wt).T.reshape(w.shape)


def fake_quant_act(x: torch.Tensor, fmt: str = "m2xfp") -> torch.Tensor:
    """Activation fake-quant along the last (contraction) axis."""
    return get_codec(fmt).fake_quant_act(x)


def init_linear(gen: torch.Generator, d_in: int, d_out, device="cuda",
                dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) init, fan-in scaled, (d_in, d_out) in
    ``dtype``; ``d_out`` may be a tuple."""
    shape = (d_in, *d_out) if isinstance(d_out, tuple) else (d_in, d_out)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * d_in ** -0.5).to(dtype)


def _tail_streams(p: PackedTensor) -> tuple:
    """Names of the streams laid out (rows, *weight tail) -- every stream
    but a per-tensor scalar such as nvfp4's ``tscale``."""
    tail = tuple(p.shape[1:])
    return tuple(name for name, s in p.streams.items()
                 if s.dim() == len(p.shape) and tuple(s.shape[1:]) == tail)


def pack_serving_weight(w: torch.Tensor, fmt: str = "m2xfp") -> PackedTensor:
    """(K, N...) weight -> packed codec streams, groups along K (axis 0):
    each stream is (rows, N...) (a mixture-of-experts weight (K, E, N)
    gives (rows, E, N) streams), a per-tensor scalar (nvfp4's ``tscale``
    (1, 1)) keeps its shape. A weight on the "meta" device gives streams
    of the right shapes and dtypes on "meta" without running the encoder:
    each stream's rows per group of 32 are read off the encode of one
    group of two columns."""
    codec = get_codec(fmt)
    if not codec.packed:
        raise ValueError(f"codec {fmt!r} has no packed serving path; "
                         f"packable codecs: {', '.join(packed_codecs())}")
    if w.dim() < 2:
        raise ValueError(f"pack_serving_weight takes a (K, N...) weight, "
                         f"got shape {tuple(w.shape)}")
    k, tail = w.shape[0], tuple(w.shape[1:])
    n = math.prod(tail)
    if w.is_meta:
        streams = {name: torch.empty(
            (s.shape[0] * (k // 32), n) if s.shape[1] == 2 else s.shape,
            dtype=s.dtype, device="meta")
            for name, s in codec.encode(torch.zeros(32, 2)).items()}
    else:
        streams = codec.encode(w.reshape(k, n))
    streams = {name: s.reshape(s.shape[0], *tail)
               if s.dim() == 2 and s.shape[1] == n else s
               for name, s in streams.items()}
    return PackedTensor(streams, (k, *tail), fmt)


def decode_serving_weight(p: PackedTensor, dtype=None) -> torch.Tensor:
    """Packed streams -> dense (K, N...) weight in the codec's exact dtype
    (bf16 for the E8M0-scaled codecs, f32 for nvfp4) unless ``dtype``
    overrides it."""
    codec = get_codec(p.codec)
    k, n = p.shape[0], math.prod(p.shape[1:])
    tail = _tail_streams(p)
    streams = {name: s.reshape(s.shape[0], n) if name in tail else s
               for name, s in p.streams.items()}
    return codec.decode(streams, k, n).reshape(p.shape).to(
        dtype or codec.decode_dtype)


def _serve_matmul(x: torch.Tensor, w: PackedTensor) -> torch.Tensor:
    """Online activation fake-quant with the weight's codec and bf16
    rounding, then the codec's packed GEMM, or, for a codec without one,
    its decode and ``dot_f32acc`` of the activations upcast to the decoded
    dtype. The f32 result is cast back to ``x.dtype``."""
    codec = get_codec(w.codec)
    k = w.shape[0]
    n = math.prod(w.shape[1:])
    xq = codec.fake_quant_act(x.to(torch.float32)).to(torch.bfloat16)
    if codec.kernel is None:
        wd = decode_serving_weight(w)
        return dot_f32acc(xq.to(wd.dtype), wd).to(x.dtype)
    out = packed_matmul(xq.reshape(-1, k), w.streams, w.codec)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def quantized_matmul(x: torch.Tensor, w, quant: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) under the configured quantization mode. ``w``
    is a dense tensor for ``none`` and a PackedTensor for ``serve`` (a
    dense weight under ``serve`` -- one too narrow to pack -- runs the
    dense GEMM, as in the reference)."""
    if quant == "serve" and isinstance(w, PackedTensor):
        return _serve_matmul(x, w)
    if quant not in ("none", "serve"):
        raise NotImplementedError(f"quant={quant!r} is not ported yet")
    return dot_f32acc(x, w).to(x.dtype)
