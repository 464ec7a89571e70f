"""Codec registry and packed container (port of repro.core.codecs).

One :class:`Codec` record per format, looked up by name, carries what the
serve path needs: the activation fake-quant, the packed weight encoder and
its exact decoder, the fused dequant-GEMM, and the packed KV cache's
encode, decode and zero page. The slice registers the paper's format
``m2xfp`` and its baseline ``mxfp4``; asking for a path a codec lacks
raises a ``ValueError`` naming the codecs that have it.

Packed-stream conventions (shared with ``repro_torch.kernels.layout``):

  * ``encode(w)``: (K, N) -> dict of 2-D u8 streams, groups along K,
    nibbles group-half interleaved (K % 32 == 0) -- the reference's bytes;
  * ``decode(streams, k, n)``: exact inverse to f32 (K, N);
  * ``decode_dtype``: bf16 -- every decoded E8M0-scaled value fits it;
  * ``kernel(x, streams)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``repro_torch.kernels.ops``);
  * ``kv_encode(x)``: (..., hd) -> dict of u8 streams along hd (paper
    Sec. 6.4, K/V as right-hand GEMM operands); ``kv_decode`` its exact
    inverse to bf16; ``kv_spec(b, w, nkv, hd, device)`` a zero page.
    These are plain PyTorch on either device: elementwise ops, a max, and
    error sums in a fixed order (``m2xfp._sum_last``), so the bytes do not
    depend on how many tokens share a call.

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
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import layout, ops, ref
from .dtypes import FP4_E2M1, exp2int, fp4_code_to_value, \
    fp4_value_to_code, round_to_grid
from .formats import quantize_mxfp4
from .m2xfp import GROUP, SUBGROUP, quantize_act_m2xfp, \
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
    fake_quant_act: Callable[[torch.Tensor], torch.Tensor]
    encode: Optional[Callable] = None        # (K, N) -> {name: u8 2-D}
    decode: Optional[Callable] = None        # (streams, k, n) -> f32 (K, N)
    decode_dtype: torch.dtype = torch.bfloat16
    kernel: Optional[Callable] = None        # fused dequant-GEMM
    kv_encode: Optional[Callable] = None     # (..., hd) -> {name: u8}
    kv_decode: Optional[Callable] = None     # inverse -> bf16 (..., hd)
    kv_spec: Optional[Callable] = None       # (b, w, nkv, hd, device) -> page
    scale_kind: str = "e8m0"                 # u8 scale stream's encoding

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


def _bad_scale_stats(sc: torch.Tensor) -> torch.Tensor:
    """(count, first flat index, byte there) of the E8M0 bytes outside
    [1, 254], as one int64 tensor on ``sc``'s device (index 0 if none)."""
    flat = sc.reshape(-1)
    bad = (flat < 1) | (flat > 254)
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
    float streams are finite; the code stream holds two nibbles per
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
    if sc is not None and sc.dtype == torch.uint8:
        if codec.scale_kind != "e8m0":
            raise NotImplementedError(
                f"scale kind {codec.scale_kind!r}: only e8m0 scales are "
                f"validated in the port")
        stats = torch.stack([_bad_scale_stats(leaf.streams["scales"])
                             for leaf in leaves]).cpu()   # (layers, 3)
        total = int(stats[:, 0].sum())
        if total:
            layer = int(torch.nonzero(stats[:, 0])[0, 0])
            idx = _unravel(int(stats[layer, 1]),
                           leaves[layer].streams["scales"].shape)
            idx = ((layer,) if stacked else ()) + idx
            problems.append(
                f"{total} scale byte(s) outside the legal "
                f"{codec.scale_kind} range [1, 254] (first at index {idx}, "
                f"byte {int(stats[layer, 2])})")
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


# ---------------------------------------------------------------------------
# Packed KV cache (paper Sec. 6.4): groups of 32 along hd, E8M0 floor scale
# ---------------------------------------------------------------------------

def _kv_scale(x: torch.Tensor):
    """(..., hd) -> (groups (..., hd/32, 32) f32, exponent (..., hd/32, 1),
    scale 2^E (..., hd/32, 1))."""
    xg = group_reshape(x.to(torch.float32), GROUP)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True))
    return xg, e, exp2int(e)


def _sign_mag_codes(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """FP4 grid values ``q`` of ``x`` -> 4-bit sign-magnitude codes (bit 3
    set where x < 0, so -0.0 gets the positive code)."""
    mag = fp4_value_to_code(q.abs())
    return torch.where(x < 0, mag | 8, mag)


def _signed_fp4(codes: torch.Tensor) -> torch.Tensor:
    """4-bit sign-magnitude codes -> f32 values (code 8 gives -0.0)."""
    sgn = torch.where((codes & 8) != 0, -1.0, 1.0)
    return fp4_code_to_value(codes & 7) * sgn


def _kv_encode_sgem(x: torch.Tensor) -> dict:
    """(..., hd) -> Sg-EM fixed-scale streams: codes (..., hd/2), scales
    and meta (..., hd/32) u8 (no group-bias search: b = 0)."""
    hd = x.shape[-1]
    xg, e, s = _kv_scale(x)
    _, k_sel, _ = sg_em_dequant_with_scale(
        xg, s, SUBGROUP, bits=2, adaptive=False, return_codes=True)
    s_final = (1.0 + k_sel.to(torch.float32) / 4.0) * s     # (..., ng, ns)
    xsub = xg.reshape(*xg.shape[:-1], N_SUB, SUBGROUP)
    q = round_to_grid(xsub / s_final[..., None], FP4_E2M1)
    codes = _sign_mag_codes(xsub, q).reshape(*x.shape[:-1], hd)
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
    vals = _signed_fp4(codes).reshape(*lead, hd // GROUP, N_SUB, SUBGROUP)
    out = vals * mult.reshape(*lead, hd // GROUP, N_SUB, 1) * s[..., None]
    return out.reshape(*lead, hd).to(torch.bfloat16)


def _kv_encode_mxfp4(x: torch.Tensor) -> dict:
    """(..., hd) -> plain MXFP4 streams (no meta byte)."""
    hd = x.shape[-1]
    xg, e, s = _kv_scale(x)
    q = round_to_grid(xg / s, FP4_E2M1)
    return {
        "codes": pack_nibbles(_sign_mag_codes(xg, q).reshape(
            *x.shape[:-1], hd)),
        "scales": e8m0_encode(e[..., 0]),
    }


def _kv_decode_mxfp4(p: dict) -> torch.Tensor:
    """MXFP4 page -> bf16 (..., hd): fp4 * 2^(scale-127)."""
    codes = unpack_nibbles(p["codes"])
    lead, hd = codes.shape[:-1], codes.shape[-1]
    s = e8m0_decode(p["scales"])[..., None]
    vals = _signed_fp4(codes).reshape(*lead, hd // GROUP, GROUP) * s
    return vals.reshape(*lead, hd).to(torch.bfloat16)


def _kv_spec(streams: Tuple[str, ...]) -> Callable:
    """Zero page of ``streams``: codes (b, w, nkv, hd/2), the others
    (b, w, nkv, hd/32), all u8."""
    def spec(batch: int, w: int, nkv: int, hd: int, device="cuda") -> dict:
        return {name: torch.zeros(
            (batch, w, nkv, hd // 2 if name == "codes" else hd // GROUP),
            dtype=torch.uint8, device=device) for name in streams}
    return spec


register_codec(Codec(
    name="m2xfp",
    fake_quant_act=quantize_act_m2xfp,
    encode=layout.pack_w_sgem, decode=_decode_sgem,
    kernel=ops.m2xfp_matmul,
    kv_encode=_kv_encode_sgem, kv_decode=_kv_decode_sgem,
    kv_spec=_kv_spec(("codes", "scales", "meta"))))

register_codec(Codec(
    name="mxfp4",
    fake_quant_act=quantize_mxfp4,
    encode=layout.pack_w_mxfp4, decode=_decode_mxfp4,
    kernel=ops.mxfp4_matmul,
    kv_encode=_kv_encode_mxfp4, kv_decode=_kv_decode_mxfp4,
    kv_spec=_kv_spec(("codes", "scales"))))
