"""Codec registry and packed container (port of repro.core.codecs).

One :class:`Codec` record per format, looked up by name, carries the
paper's format matrix (Tbl. 2/3/4/6): the weight and activation
fake-quant of every format, and, where a format has them, the packed
weight encoder and its exact decoder, the fused dequant-GEMM, and the packed
KV cache's encode, decode and zero page. The registry holds the reference's
seven codecs: m2xfp, its Tbl. 4 ablation m2xfp_ideal6, m2nvfp4, mxfp4,
nvfp4, smx4 and fp4. Asking for a path a codec lacks raises a
``ValueError`` naming the codecs that have it.

Packed-stream conventions (shared with ``repro_torch.kernels.layout``):

  * ``encode(w)``: (K, N) -> dict of 2-D streams, groups along K, nibbles
    group-half interleaved (K % 32 == 0) -- the reference's bytes; a
    per-tensor scalar (nvfp4's ``tscale``) is an f32 (1, 1);
  * ``decode(streams, k, n)``: exact inverse to f32 (K, N), bit-identical
    to the codec's ``fake_quant_weight`` of the original tensor;
  * ``decode_dtype``: the narrowest dtype the decode is exact in: bf16 for
    the E8M0-scaled codecs, f32 for nvfp4 (its tensor scale is any f32);
  * ``kernel(x, streams)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``repro_torch.kernels.ops``); a packed codec
    without one serves through its decode (``models.quant``);
  * ``kv_encode(x)``: (..., hd) -> dict of u8 streams along hd (paper
    Sec. 6.4, K/V as right-hand GEMM operands); ``kv_decode`` its exact
    inverse to bf16; ``kv_spec(b, w, nkv, hd, device)`` a zero page.
    These are plain PyTorch on either device: elementwise ops, a max, and
    error sums in a fixed order (``m2xfp._sum_last``), so the bytes do not
    depend on how many tokens share a call. The encode probes its scaled
    values for the ``health`` pillar of ``REPRO_OBS`` (site
    ``kv_encode``), as the reference's does.

Packed-stream validation (``validate_packed``, ``validate_packed_tree``)
checks a packed weight against what its encoder can emit and reports each
problem in the reference's words. The port keeps the layers of a model as
a list of per-layer dicts, where the reference stacks them on axis 0:
``packed_leaves`` names each packed weight by the reference's key
(``layers/attn/wq``) with its list of per-layer leaves, and a report's
index tuple starts with the layer, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import layout, ops, ref
from repro_torch.obs import quant_health
from .dtypes import FP4_E2M1, exp2int, round_to_grid, sign_mag_code, \
    signed_fp4
from .ebw import format_ebw
from .formats import quantize_fp4_fp16scale, quantize_mxfp4, \
    quantize_nvfp4, quantize_smx4
from .m2xfp import GROUP, SUBGROUP, quantize_act_m2nvfp4, \
    quantize_act_m2xfp, quantize_weight_m2nvfp4, quantize_weight_m2xfp, \
    sg_em_dequant_with_scale
from .packing import group_reshape, pack_meta2, pack_nibbles, \
    unpack_meta2, unpack_nibbles
from .scaling import e8m0_decode, e8m0_encode, shared_scale_exponent

__all__ = [
    "Codec", "PackedTensor", "register_codec", "get_codec", "list_codecs",
    "packed_codecs", "kv_codecs", "kernel_codecs", "packed_leaves",
    "validate_packed", "validate_packed_tree",
]

N_SUB = GROUP // SUBGROUP


@dataclasses.dataclass(frozen=True)
class Codec:
    """One MX-family format: fake-quant always, packed paths optional."""

    name: str
    group: int
    ebw: float
    fake_quant_weight: Callable[[torch.Tensor], torch.Tensor]
    fake_quant_act: Callable[[torch.Tensor], torch.Tensor]
    encode: Optional[Callable] = None        # (K, N) -> {name: 2-D}
    decode: Optional[Callable] = None        # (streams, k, n) -> f32 (K, N)
    decode_dtype: torch.dtype = torch.bfloat16
    kernel: Optional[Callable] = None        # fused dequant-GEMM
    kv_encode: Optional[Callable] = None     # (..., hd) -> {name: u8}
    kv_decode: Optional[Callable] = None     # inverse -> bf16 (..., hd)
    kv_spec: Optional[Callable] = None       # (b, w, nkv, hd, device) -> page
    scale_kind: str = "e8m0"                 # e8m0 | e4m3 | f16
    scale_sat_bounds: Optional[Tuple[int, int]] = None  # saturated bytes
    has_meta: bool = False                   # streams carry 2-bit metadata
    # False where fake_quant_act scales per tensor (nvfp4-style): the
    # online activation quantization then depends on which tokens share a
    # launch, so chunked prefill and batched decode are not bit-identical
    # to serving token by token (the cause that rules out a packed KV path)
    act_batch_invariant: bool = True

    @property
    def packed(self) -> bool:
        return self.encode is not None

    @property
    def kv_capable(self) -> bool:
        return self.kv_encode is not None


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


def kv_codecs() -> Tuple[str, ...]:
    """Codecs with a packed KV-cache path."""
    return tuple(n for n in list_codecs() if _REGISTRY[n].kv_capable)


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


# ---------------------------------------------------------------------------
# Packed-stream integrity validation
# ---------------------------------------------------------------------------

def packed_leaves(tree) -> dict:
    """{reference key: (stacked, [leaf, ...])} for every PackedTensor of a
    parameter dict, in the reference's flatten order (dict keys sorted at
    every level). A weight under a list (``layers``) is stacked: its list
    holds one leaf per layer, in layer order."""
    out = {}

    def walk(node, path, stacked):
        if isinstance(node, PackedTensor):
            out.setdefault("/".join(path), (stacked, []))[1].append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),), stacked)
        elif isinstance(node, list):
            for item in node:
                walk(item, path, True)
    walk(tree, (), False)
    return out


def _unravel(flat: int, shape) -> tuple:
    idx = []
    for n in reversed(shape):
        idx.append(flat % n)
        flat //= n
    return tuple(reversed(idx))


# what a u8 scale stream of each kind may hold: E8M0 bytes in [1, 254]
# (byte 0 is never emitted, byte 255 is reserved and decodes to inf); any
# E4M3 byte but the NaN encodings 0x7F / 0xFF
_LEGAL_SCALES = {"e8m0": "[1, 254]", "e4m3": "any non-NaN e4m3 byte"}


def _bad_scale_stats(sc: torch.Tensor, kind: str) -> torch.Tensor:
    """(count, first flat index, byte there) of the illegal scale bytes of
    ``kind``, as one int64 tensor on ``sc``'s device (index 0 if none)."""
    flat = sc.reshape(-1)
    bad = ((flat < 1) | (flat > 254) if kind == "e8m0"
           else (flat & 0x7F) == 0x7F)
    first = torch.argmax(bad.to(torch.int32))       # the first maximum
    return torch.stack([bad.sum(), first, flat[first].long()])


def validate_packed(p: Union[PackedTensor, Sequence[PackedTensor]]) -> list:
    """Integrity-check a packed tensor's streams against the encoder
    invariants of its codec. Returns the problems in the reference's words
    (empty list = valid). ``p`` may be the list of per-layer leaves of one
    weight (``packed_leaves``): it is checked as the reference checks the
    layer-stacked leaf, and an index tuple starts with the layer.

    Checks: E8M0 scale bytes lie in [1, 254] (the encoders clamp exponents
    to [-126, 127], so byte 0 is never emitted and byte 255, reserved,
    decodes to inf: either means the stream was damaged after packing);
    E4M3 scale bytes are not a NaN encoding (0x7F / 0xFF); float streams
    (nvfp4's ``tscale``) are finite; the code stream holds two nibbles per
    logical element. On CUDA tensors the reductions run on the card and one
    small tensor per weight comes back to the host, never the streams."""
    stacked = not isinstance(p, PackedTensor)
    leaves = list(p) if stacked else [p]
    first = leaves[0]
    codec = get_codec(first.codec)
    if not codec.packed:
        return [f"codec {first.codec!r} has no packed path"]
    problems = []
    sc = first.streams.get("scales")
    kind = codec.scale_kind
    if sc is not None and sc.dtype == torch.uint8 and kind in _LEGAL_SCALES:
        stats = torch.stack([_bad_scale_stats(leaf.streams["scales"], kind)
                             for leaf in leaves]).cpu()   # (layers, 3)
        total = int(stats[:, 0].sum())
        if total:
            layer = int(torch.nonzero(stats[:, 0])[0, 0])
            idx = _unravel(int(stats[layer, 1]),
                           leaves[layer].streams["scales"].shape)
            idx = ((layer,) if stacked else ()) + idx
            problems.append(
                f"{total} scale byte(s) outside the legal {kind} range "
                f"{_LEGAL_SCALES[kind]} (first at index {idx}, byte "
                f"{int(stats[layer, 2])})")
    for name, s in first.streams.items():
        if s.dtype.is_floating_point and bool(torch.stack(
                [~torch.isfinite(leaf.streams[name].float()).all()
                 for leaf in leaves]).any()):
            problems.append(f"non-finite value in float stream {name!r}")
    if "codes" in first.streams:
        n_elems = math.prod(first.shape)
        nibbles = 2 * sum(leaf.streams["codes"].numel() for leaf in leaves)
        if n_elems and nibbles % n_elems != 0:
            problems.append(
                f"code stream holds {nibbles} nibbles, not a multiple of "
                f"the {n_elems} logical elements of shape {first.shape}")
    return problems


def validate_packed_tree(tree) -> dict:
    """:func:`validate_packed` over every packed weight of a parameter
    dict. Returns {reference key: [problems]} for invalid weights only
    (empty dict = every packed stream is intact)."""
    report = {}
    for key, (stacked, leaves) in packed_leaves(tree).items():
        problems = validate_packed(leaves if stacked else leaves[0])
        if problems:
            report[key] = problems
    return report


def _decode_sgem(streams: dict, k: int, n: int) -> torch.Tensor:
    """Sg-EM-2bit decode: fp4 * (1 + meta/4) * 2^(scale-127), f32 (K, N)."""
    return ref.decode_w_sgem_ref(streams).reshape(k, n)


def _decode_mxfp4(streams: dict, k: int, n: int) -> torch.Tensor:
    """MXFP4 decode: fp4 * 2^(scale-127), f32 (K, N)."""
    return ref.decode_w_mxfp4_ref(streams).reshape(k, n)


def _decode_nvfp4(streams: dict, k: int, n: int) -> torch.Tensor:
    """NVFP4 decode: fp4 * (E4M3 group scale * f32 tensor scale), f32
    (K, N). Exact in f32 only: the tensor scale is any float."""
    c = layout.interleave_unpack(streams["codes"])
    s8 = streams["scales"].view(torch.float8_e4m3fn).to(torch.float32)
    s = s8 * streams["tscale"].reshape(())
    s = torch.where(s == 0, 1.0, s)                  # as the encode
    w = signed_fp4(c).reshape(k // 16, 16, n) * s[:, None, :]
    return w.reshape(k, n)


# ---------------------------------------------------------------------------
# Packed KV cache (paper Sec. 6.4): groups of 32 along hd, E8M0 floor scale
# ---------------------------------------------------------------------------

def _kv_scale(x: torch.Tensor):
    """(..., hd) -> (groups (..., hd/32, 32) f32, exponent (..., hd/32, 1),
    scale 2^E (..., hd/32, 1))."""
    xg = group_reshape(x.to(torch.float32), GROUP)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True))
    return xg, e, exp2int(e)


def _kv_encode_sgem(x: torch.Tensor) -> dict:
    """(..., hd) -> Sg-EM fixed-scale streams: codes (..., hd/2), scales
    and meta (..., hd/32) u8 (no group-bias search: b = 0)."""
    hd = x.shape[-1]
    xg, e, s = _kv_scale(x)
    _, k_sel, _ = sg_em_dequant_with_scale(
        xg, s, SUBGROUP, bits=2, adaptive=False, return_codes=True)
    s_final = (1.0 + k_sel.to(torch.float32) / 4.0) * s     # (..., ng, ns)
    xsub = xg.reshape(*xg.shape[:-1], N_SUB, SUBGROUP)
    if quant_health.enabled("health"):      # REPRO_OBS health pillar
        quant_health.probe_scaled("kv_encode", xsub / s_final[..., None], e,
                                  k_sel, codec="m2xfp")
    q = round_to_grid(xsub / s_final[..., None], FP4_E2M1)
    codes = sign_mag_code(q, xsub < 0).reshape(*x.shape[:-1], hd)
    return {
        "codes": pack_nibbles(codes),
        "scales": e8m0_encode(e[..., 0]),
        "meta": pack_meta2(k_sel.reshape(*x.shape[:-1], -1)),
    }


def _kv_decode_sgem(p: dict) -> torch.Tensor:
    """Sg-EM page -> bf16 (..., hd): fp4 * (1 + k/4) * 2^(scale-127)."""
    codes = unpack_nibbles(p["codes"])
    lead, hd = codes.shape[:-1], codes.shape[-1]
    s = e8m0_decode(p["scales"])[..., None]                  # (..., ng, 1)
    k = unpack_meta2(p["meta"], (hd // GROUP) * N_SUB)
    mult = 1.0 + k.to(torch.float32) / 4.0
    vals = signed_fp4(codes).reshape(*lead, hd // GROUP, N_SUB, SUBGROUP)
    out = vals * mult.reshape(*lead, hd // GROUP, N_SUB, 1) * s[..., None]
    return out.reshape(*lead, hd).to(torch.bfloat16)


def _kv_encode_mxfp4(x: torch.Tensor) -> dict:
    """(..., hd) -> plain MXFP4 streams (no meta byte)."""
    hd = x.shape[-1]
    xg, e, s = _kv_scale(x)
    if quant_health.enabled("health"):      # REPRO_OBS health pillar
        quant_health.probe_scaled("kv_encode", xg / s, e, None,
                                  codec="mxfp4")
    q = round_to_grid(xg / s, FP4_E2M1)
    return {
        "codes": pack_nibbles(sign_mag_code(q, xg < 0).reshape(
            *x.shape[:-1], hd)),
        "scales": e8m0_encode(e[..., 0]),
    }


def _kv_decode_mxfp4(p: dict) -> torch.Tensor:
    """MXFP4 page -> bf16 (..., hd): fp4 * 2^(scale-127)."""
    codes = unpack_nibbles(p["codes"])
    lead, hd = codes.shape[:-1], codes.shape[-1]
    s = e8m0_decode(p["scales"])[..., None]
    vals = signed_fp4(codes).reshape(*lead, hd // GROUP, GROUP) * s
    return vals.reshape(*lead, hd).to(torch.bfloat16)


def _kv_spec(streams: Tuple[str, ...]) -> Callable:
    """Zero page of ``streams``: codes (b, w, nkv, hd/2), the others
    (b, w, nkv, hd/32), all u8."""
    def spec(batch: int, w: int, nkv: int, hd: int, device="cuda") -> dict:
        return {name: torch.zeros(
            (batch, w, nkv, hd // 2 if name == "codes" else hd // GROUP),
            dtype=torch.uint8, device=device) for name in streams}
    return spec


_SGEM = dict(
    encode=layout.pack_w_sgem, decode=_decode_sgem, kernel=ops.m2xfp_matmul,
    kv_encode=_kv_encode_sgem, kv_decode=_kv_decode_sgem,
    kv_spec=_kv_spec(("codes", "scales", "meta")),
    scale_kind="e8m0", scale_sat_bounds=(1, 254), has_meta=True)

register_codec(Codec(
    name="m2xfp", group=32, ebw=format_ebw("m2xfp"),
    fake_quant_weight=quantize_weight_m2xfp,
    fake_quant_act=quantize_act_m2xfp, **_SGEM))

# Ablation (paper Tbl. 4): weights identical to m2xfp's (the same bytes,
# kernel and KV path); activations refine the subgroup top-1 with an
# unclamped FP6 instead of the 2-bit encoding.
register_codec(Codec(
    name="m2xfp_ideal6", group=32, ebw=format_ebw("m2xfp"),
    fake_quant_weight=quantize_weight_m2xfp,
    fake_quant_act=functools.partial(quantize_act_m2xfp, encoding="ideal"),
    **_SGEM))

register_codec(Codec(
    name="m2nvfp4", group=16, ebw=format_ebw("m2nvfp4"),
    fake_quant_weight=quantize_weight_m2nvfp4,
    fake_quant_act=quantize_act_m2nvfp4,
    scale_kind="e4m3", act_batch_invariant=False))

register_codec(Codec(
    name="mxfp4", group=32, ebw=format_ebw("mxfp4"),
    fake_quant_weight=quantize_mxfp4, fake_quant_act=quantize_mxfp4,
    encode=layout.pack_w_mxfp4, decode=_decode_mxfp4,
    kernel=ops.mxfp4_matmul,
    kv_encode=_kv_encode_mxfp4, kv_decode=_kv_decode_mxfp4,
    kv_spec=_kv_spec(("codes", "scales")),
    scale_kind="e8m0", scale_sat_bounds=(1, 254)))

# NVFP4's element scale is (E4M3 byte) * (per-tensor f32): an exact decode
# needs f32, and per-call tensor scales make online KV packing depend on
# which tokens share a call -- no KV path. It has no fused kernel in the
# reference either: it serves through its decode (models.quant).
register_codec(Codec(
    name="nvfp4", group=16, ebw=format_ebw("nvfp4"),
    fake_quant_weight=quantize_nvfp4, fake_quant_act=quantize_nvfp4,
    encode=layout.pack_w_nvfp4, decode=_decode_nvfp4,
    decode_dtype=torch.float32,
    scale_kind="e4m3", scale_sat_bounds=(0, 126),
    act_batch_invariant=False))

register_codec(Codec(
    name="smx4", group=16, ebw=format_ebw("smx4"),
    fake_quant_weight=quantize_smx4, fake_quant_act=quantize_smx4))

register_codec(Codec(
    name="fp4", group=32, ebw=format_ebw("fp4_fp16scale"),
    fake_quant_weight=quantize_fp4_fp16scale,
    fake_quant_act=quantize_fp4_fp16scale, scale_kind="f16"))
