"""Packed KV cache (paper Sec. 6.4), codec-dispatched (port of
repro.models.kvquant).

K and V are right-hand GEMM operands (P = Q K^T, O = P V), so the weight
formats apply to them: groups of 32 along head_dim share an E8M0 scale (and,
for m2xfp, a 2-bit multiplier per subgroup of 8) and stay resident packed
instead of in bf16. Each new token's K/V is encoded online as it is written;
a read decodes the whole page to bf16 before the attention contractions.

Which codecs can back the cache is a registry property (``kv_codecs()``):
the encode must not depend on which tokens share a call, so that chunked
prefill and sequential decode write the same pages. m2xfp (4.5 bits per
element) and mxfp4 (4.25) qualify.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codecs import get_codec, kv_codecs

__all__ = ["kv_codec", "kv_encode", "kv_decode", "kv_page_write",
           "kv_cache_spec"]


def kv_codec(fmt: str):
    """Resolve ``fmt`` to a codec with a packed KV path, or raise
    ``ValueError`` with the list of codecs that have one (for a name the
    registry does not know, too)."""
    try:
        codec = get_codec(fmt)
    except ValueError as e:
        raise ValueError(f"{e}; KV-capable codecs: "
                         f"{', '.join(kv_codecs())}") from None
    if not codec.kv_capable:
        raise ValueError(
            f"codec {fmt!r} has no packed KV-cache path (its encode is not "
            f"order-independent or not implemented); KV-capable codecs: "
            f"{', '.join(kv_codecs())}")
    return codec


def kv_encode(x: torch.Tensor, fmt: str = "m2xfp") -> dict:
    """(..., hd) -> packed stream dict (for m2xfp: codes (..., hd/2) u8,
    scales (..., hd/32) u8, meta (..., hd/32) u8)."""
    return kv_codec(fmt).kv_encode(x)


def kv_decode(p: dict, fmt: str = "m2xfp") -> torch.Tensor:
    """Inverse of kv_encode -> bf16 (..., hd)."""
    return kv_codec(fmt).kv_decode(p)


def kv_page_write(page: dict, enc: dict, slot: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> None:
    """Per-slot ring write of one encoded token per batch row, in place.

    ``page``: dict of tensors with leading (B, W) axes; ``enc``: the same
    keys (or a subset) with leading (B, 1); ``slot`` (B,): ring offset per
    row (``index % W``). ``valid`` (B,) bool, optional: rows where it is
    False keep their old bytes -- the masked write of chunked prefill for
    positions past a slot's chunk length."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    for key, new in enc.items():
        buf = page[key]
        new = new[:, 0].to(buf.dtype)
        if valid is not None:
            keep = valid.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, buf[rows, slot])
        buf[rows, slot] = new


def kv_cache_spec(batch: int, w: int, nkv: int, hd: int,
                  fmt: str = "m2xfp", device="cuda") -> dict:
    """Zero-initialized packed K or V page of ``fmt`` on ``device``."""
    return kv_codec(fmt).kv_spec(batch, w, nkv, hd, device)
