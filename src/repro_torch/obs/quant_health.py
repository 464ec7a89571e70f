"""Quantization-health telemetry, the ``health`` pillar of ``REPRO_OBS``
(port of repro.obs.quant_health: the same statistics, metric names and
labels).

What the paper's accuracy claims hinge on is *observable* encoder
behaviour: how often elements clip against the FP4 grid, how often the
shared scale byte saturates its representable range, which metadata modes
the encoders use, and whether pack -> decode -> re-pack drifts. This
module turns those into metrics labeled by **codec name**
(``repro_torch.core.codecs``):

* **Probes** (:func:`probe_act`, :func:`probe_scaled`) -- reductions on the
  tensor's own device, stacked into one small int64 tensor per probe and
  handed to a :class:`ProbeBuffer`; nothing waits for the device there.
  The serving engine gives each launch its own buffer and copies the
  pending statistics to the host together with the sampled logit rows, in
  the one copy it makes anyway (as the reference drains its
  ``jax.debug.callback`` probes after each launch). A probe outside an
  engine goes to a process-wide buffer that :func:`flush` drains (the
  reference's ``jax.effects_barrier``; ``obs.dump`` flushes first). With
  the ``health`` pillar off a probe is one flag check: no device tensor,
  no kernel.

* **Host-side sweep** (:func:`weight_tree_health`) -- per-layer clip rate,
  scale-byte saturation, metadata-mode histogram and re-encode drift over
  a packed parameter dict, each reduced on the weight's device and copied
  to the host once for the whole dict, recorded as per-layer gauges (the
  serving engine runs it once at start-up).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import numpy as np
import torch

from .registry import counter, enabled, gauge

__all__ = [
    "probe_act", "probe_scaled", "drain_stats", "weight_tree_health",
    "act_reencode_drift", "ProbeBuffer", "collect", "flush", "act_stats",
    "E8M0_BYTE_LOW", "E8M0_BYTE_HIGH",
]

# Biased E8M0 scale-byte bounds: the scaling rules clamp exponents to
# [-126, 127] -> stored bytes [1, 254]. A group whose scale byte sits at a
# bound had its exponent clipped -- its elements may be misscaled. (Codecs
# with other scale encodings carry their own bounds: Codec.scale_sat_bounds.)
E8M0_BYTE_LOW = 1
E8M0_BYTE_HIGH = 254

_FP4_MAX = 6.0          # FP4 E2M1 top grid value (|x|/s beyond it clips)
_FP4_TOP_CODE = 7       # magnitude code of the 6.0 grid point


def _site_counters(site: str, codec: str, n, clipped, groups, sat_lo,
                   sat_hi, meta):
    """Host-side accumulation of one probe's scalars into the registry."""
    counter("repro_quant_elems_total",
            "elements seen by quantization encoders").inc(
        float(n), site=site, codec=codec)
    counter("repro_quant_clipped_total",
            "elements clipped against the FP4 grid").inc(
        float(clipped), site=site, codec=codec)
    counter("repro_quant_groups_total",
            "scale groups seen by quantization encoders").inc(
        float(groups), site=site, codec=codec)
    counter("repro_quant_scale_saturated_total",
            "groups whose scale byte hit a representable-range bound").inc(
        float(sat_lo), site=site, codec=codec, bound="low")
    counter("repro_quant_scale_saturated_total", "").inc(
        float(sat_hi), site=site, codec=codec, bound="high")
    mh = np.asarray(meta).reshape(-1)
    for code in range(mh.shape[0]):
        counter("repro_quant_meta_total",
                "metadata-mode occupancy (2-bit code histogram)").inc(
            float(mh[code]), site=site, codec=codec, code=str(code))
    elems = counter("repro_quant_elems_total").value(site=site, codec=codec)
    if elems > 0:
        gauge("repro_quant_clip_rate",
              "cumulative clipped / seen element fraction").set(
            counter("repro_quant_clipped_total").value(
                site=site, codec=codec) / elems,
            site=site, codec=codec, kind="online")


def drain_stats(site: str, codec: str, stats: tuple) -> None:
    """Record one probe's host scalars: ``stats`` = (elements, clipped,
    groups, saturated low, saturated high, meta histogram (4,)), the
    reference's callback tuple."""
    _site_counters(site, codec, *stats)


# ---------------------------------------------------------------------------
# Probes: statistics on the device, recorded when the host next copies
# ---------------------------------------------------------------------------

class ProbeBuffer:
    """Probe statistics waiting for the host. :meth:`put` keeps, per probe,
    the site and codec, the element and group counts (known on the host)
    and an int64 (7,) tensor on the device: clipped elements, groups
    saturated low and high, the 2-bit metadata histogram. :meth:`take`
    hands the pending tensors to a caller that copies them with its own
    data, which then calls :meth:`deliver` with the host rows; :meth:`flush`
    makes that copy itself."""

    def __init__(self):
        self._keys: List[Tuple[str, str, int, int]] = []
        self._stats: List[torch.Tensor] = []

    def put(self, site: str, codec: str, n: int, groups: int,
            stats: torch.Tensor) -> None:
        self._keys.append((site, codec, n, groups))
        self._stats.append(stats)

    def take(self):
        """(keys, tensors) pending, and the buffer emptied."""
        out = (self._keys, self._stats)
        self._keys, self._stats = [], []
        return out

    @staticmethod
    def deliver(keys, host: np.ndarray) -> None:
        """Record ``host`` (probes, 7) int64, row i the statistics of
        ``keys[i]``, into the registry in probe order."""
        for (site, codec, n, groups), row in zip(keys, host):
            drain_stats(site, codec,
                        (n, row[0], groups, row[1], row[2], row[3:7]))

    def flush(self) -> None:
        """Copy the pending statistics to the host (one copy) and record
        them."""
        keys, stats = self.take()
        if stats:
            dev = stats[0].device
            self.deliver(keys, torch.stack(
                [s.to(dev) for s in stats]).cpu().numpy())


_DEFAULT = ProbeBuffer()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_probe_buffer", default=_DEFAULT)


@contextlib.contextmanager
def collect(buf: ProbeBuffer):
    """Send the probes of the enclosed calls to ``buf`` (an engine's launch:
    the engine drains ``buf`` at its own copy to the host)."""
    token = _ACTIVE.set(buf)
    try:
        yield buf
    finally:
        _ACTIVE.reset(token)


def flush() -> None:
    """Record the probes made outside any :func:`collect` (one copy)."""
    _DEFAULT.flush()


def _meta_hist(codes: torch.Tensor) -> torch.Tensor:
    """int64 (4,) counts of the values 0..3 of ``codes``, on its device
    (compare and sum: no host sync, unlike a device ``bincount``)."""
    levels = torch.arange(4, device=codes.device)
    return (codes.reshape(-1, 1) == levels).sum(0)


def _pack(clipped, sat_lo, sat_hi, hist) -> torch.Tensor:
    return torch.cat([torch.stack([clipped, sat_lo, sat_hi]).to(torch.int64),
                      hist.to(torch.int64)])


def act_stats(x: torch.Tensor, codec: str = "m2xfp"):
    """Health statistics of activations ``x`` about to be quantized with
    ``codec``: (elements, groups, int64 (7,) on x's device), or None for a
    codec without an E8M0 shared scale. The shared scale is recomputed
    here (floor rule), as the reference's probe does."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.dtypes import exp2int
    from repro_torch.core.packing import group_reshape
    from repro_torch.core.scaling import shared_scale_exponent
    cd = get_codec(codec)
    if cd.scale_kind != "e8m0":
        return None
    xg = group_reshape(x.to(torch.float32), cd.group)
    amax = xg.abs().amax(dim=-1, keepdim=True)
    e = shared_scale_exponent(amax, "floor")
    s = exp2int(e)
    clipped = (xg.abs() > _FP4_MAX * s).sum()
    sat_lo = (e <= E8M0_BYTE_LOW - 127).sum()
    sat_hi = (e >= E8M0_BYTE_HIGH - 127).sum()
    if cd.has_meta:
        from repro_torch.core.m2xfp import elem_em_encode_parts
        _, _, _, meta, _ = elem_em_encode_parts(xg, s, 8)
        hist = _meta_hist(meta)
    else:
        hist = torch.zeros(4, dtype=torch.int64, device=x.device)
    return x.numel(), e.numel(), _pack(clipped, sat_lo, sat_hi, hist)


def _scaled_stats(xs_over_s: torch.Tensor, e: torch.Tensor,
                  meta_codes: Optional[torch.Tensor]):
    """(elements, groups, int64 (7,)) of an encoder's scaled values."""
    clipped = (xs_over_s.abs() > _FP4_MAX).sum()
    sat_lo = (e <= E8M0_BYTE_LOW - 127).sum()
    sat_hi = (e >= E8M0_BYTE_HIGH - 127).sum()
    if meta_codes is None:
        hist = torch.zeros(4, dtype=torch.int64, device=e.device)
    else:
        hist = _meta_hist(meta_codes)
    return xs_over_s.numel(), e.numel(), _pack(clipped, sat_lo, sat_hi,
                                               hist)


def probe_act(x: torch.Tensor, site: str, codec: str = "m2xfp") -> None:
    """Health statistics of activations about to be quantized with
    ``codec``, for the current :class:`ProbeBuffer`. No-op unless the
    ``health`` pillar is on; codecs without an E8M0 shared scale are
    skipped (their scale statistics live in the weight sweep)."""
    if not enabled("health"):
        return
    got = act_stats(x, codec)
    if got is not None:
        _ACTIVE.get().put(site, codec, *got)


def probe_scaled(site: str, xs_over_s: torch.Tensor, e: torch.Tensor,
                 meta_codes: Optional[torch.Tensor] = None,
                 codec: str = "m2xfp") -> None:
    """Probe for an encoder that already holds the scaled values:
    ``xs_over_s`` = x / s per element, ``e`` the integer scale exponents,
    ``meta_codes`` int 0..3 codes (any shape; None for metadata-free
    codecs). No-op unless the ``health`` pillar is on; a call site whose
    arguments cost device work checks ``enabled("health")`` first."""
    if not enabled("health"):
        return
    _ACTIVE.get().put(site, codec, *_scaled_stats(xs_over_s, e, meta_codes))


# ---------------------------------------------------------------------------
# Per-layer sweep over a packed parameter dict
# ---------------------------------------------------------------------------

def _stream_counts(streams: dict, codec) -> torch.Tensor:
    """float64 (7,) on the streams' device: FP4 top codes, scale bytes at
    the low and high bound, the metadata histogram (4,) (zeros where the
    reference reports none). Counts below 2^53 are exact in float64."""
    codes = streams["codes"]
    top = ((codes & 7) == _FP4_TOP_CODE).sum() \
        + (((codes >> 4) & 7) == _FP4_TOP_CODE).sum()
    zero = torch.zeros((), dtype=torch.int64, device=codes.device)
    lo = hi = zero
    scales = streams.get("scales")
    if scales is not None and codec.scale_sat_bounds is not None:
        b_lo, b_hi = codec.scale_sat_bounds
        lo, hi = (scales <= b_lo).sum(), (scales >= b_hi).sum()
    if codec.has_meta and "meta" in streams:
        meta = streams["meta"]
        hist = _meta_hist(torch.stack([(meta >> (2 * j)) & 3
                                       for j in range(4)]))
    else:
        hist = zero.expand(4)
    return torch.cat([torch.stack([top, lo, hi]), hist]).to(torch.float64)


def _layer_drift(leaf) -> torch.Tensor:
    """float64 (2,) on the leaf's device: the f32 means of (w1 - w2)^2 and
    w1^2, w1 the decoded layer and w2 its decode -> repack -> decode round
    trip (encoder idempotence; ~0 means the packed weight is a fixed point
    of the encoder)."""
    from repro_torch.models.quant import (decode_serving_weight,
                                          pack_serving_weight)
    w1 = decode_serving_weight(leaf, dtype=torch.float32)
    w2 = decode_serving_weight(pack_serving_weight(w1, leaf.codec),
                               dtype=torch.float32)
    return torch.stack([((w1 - w2) ** 2).mean(),
                        (w1 ** 2).mean()]).to(torch.float64)


def weight_tree_health(tree, drift: bool = True) -> dict:
    """Sweep every packed weight of a parameter dict and record per-layer
    gauges (labeled by the weight's codec):

      repro_quant_clip_rate{layer,codec,kind="weight"}  FP4 top-code occupancy
      repro_quant_scale_saturation_rate{layer,codec,bound}  scale bytes at a
                                                        representable bound
      repro_quant_meta_fraction{layer,codec,code}       2-bit mode histogram
      repro_quant_reencode_drift{layer,codec}           decode->repack rel. MSE

    A weight of the layer list is reported per layer as ``<path>[i]``, the
    reference's name for index i of its layer-stacked leaf (``path`` as
    ``codecs.packed_leaves`` names it). Returns {layer: stats dict}. The
    statistics are reduced on the weights' device and come to the host in
    one copy; the drift costs one decode and one repack per layer."""
    from repro_torch.core.codecs import get_codec, packed_leaves
    names, codecs, rows = [], [], []
    for key, (stacked, leaves) in packed_leaves(tree).items():
        for i, leaf in enumerate(leaves):
            codec = get_codec(leaf.codec)
            parts = [_stream_counts(leaf.streams, codec)]
            if drift:
                parts.append(_layer_drift(leaf).to(parts[0].device))
            names.append((f"{key}[{i}]" if stacked else key, leaf))
            codecs.append(codec)
            rows.append(torch.cat(parts))
    if not rows:
        return {}
    host = torch.stack([r.to(rows[0].device) for r in rows]).cpu().numpy()
    report = {}
    for (name, leaf), codec, row in zip(names, codecs, host):
        elems = 2 * leaf.streams["codes"].numel()
        st = {"elems": int(elems), "clip_rate": float(row[0]) / elems}
        scales = leaf.streams.get("scales")
        groups = scales.numel() if scales is not None else 0
        st["groups"] = int(groups)
        if scales is not None and codec.scale_sat_bounds is not None:
            st["sat_low_rate"] = float(row[1]) / groups
            st["sat_high_rate"] = float(row[2]) / groups
        else:
            st["sat_low_rate"] = 0.0
            st["sat_high_rate"] = 0.0
        st["meta_hist"] = [int(c) for c in row[3:7]]
        st["codec"] = codec.name
        if drift:
            st["reencode_drift"] = float(row[7]) / (float(row[8]) + 1e-30)
        report[name] = st
        gauge("repro_quant_clip_rate",
              "per-layer FP4 top-code occupancy of packed weights").set(
            st["clip_rate"], layer=name, codec=codec.name, kind="weight")
        gauge("repro_quant_scale_saturation_rate",
              "per-layer fraction of scale bytes at a bound").set(
            st["sat_low_rate"], layer=name, codec=codec.name, bound="low")
        gauge("repro_quant_scale_saturation_rate", "").set(
            st["sat_high_rate"], layer=name, codec=codec.name, bound="high")
        total = max(1, sum(st["meta_hist"]))
        for code, cnt in enumerate(st["meta_hist"]):
            gauge("repro_quant_meta_fraction",
                  "per-layer metadata-mode occupancy").set(
                cnt / total, layer=name, codec=codec.name, code=str(code))
        if drift:
            gauge("repro_quant_reencode_drift",
                  "per-layer decode->repack relative MSE").set(
                st["reencode_drift"], layer=name, codec=codec.name)
    return report


def act_reencode_drift(x, fmt: str = "m2xfp") -> float:
    """Relative MSE of one activation fake-quant round trip applied twice --
    the activation-side idempotence check (host helper, not a hot-path
    probe)."""
    from repro_torch.core.codecs import get_codec
    fq = get_codec(fmt).fake_quant_act
    q1 = fq(torch.as_tensor(x, dtype=torch.float32))
    q2 = fq(q1)
    num = float(((q1 - q2) ** 2).mean())
    den = float((q1 ** 2).mean()) + 1e-30
    return num / den
