"""Serving-engine fault tolerance: health state machine and poison
sentinels (port of repro.serve.guard).

One batched launch serves every slot, so one poisoned slot -- a NaN in its
logits, a corrupt byte in its packed KV page -- must not take down the
other ``n_slots - 1`` requests. This module gives ``ServeEngine`` what it
needs to contain it:

* **Sentinels** (:func:`probe_logits`, :func:`probe_kv`): per-slot
  reductions on the launch's device. ``probe_logits`` counts non-finite
  values in the logit row each slot samples from; ``probe_kv`` counts
  non-finite values in float cache leaves and the reserved scale byte 255
  in packed ``scales`` streams (legal pages hold [0, 254], 0 being an empty
  page). They return (B,) int32 counts on the device; the engine copies
  them to the host together with the sampled logit rows, in one copy, and
  adds them to a :class:`SentinelMailbox`.

* **A health state machine** (:class:`EngineGuard`): HEALTHY, DEGRADED
  (faults seen and contained: quarantines, scrubs, watchdog trips, step
  retries; service goes on) and FAILED (fault budget exhausted; the engine
  refuses further steps), with the knobs of :class:`GuardConfig` and the
  reference's fault counters in :meth:`EngineGuard.summary`. The same
  events feed the reference's ten ``repro_guard_*`` metrics, each gated by
  ``REPRO_OBS`` (``obs.enabled()``).

* **Packed-stream verification** (:func:`verify_packed_tree`): codec
  stream validation over a packed weight dict, repaired by re-quantizing
  the broken weights from source weights when given (the encoders are
  deterministic, so an intact weight re-packs to the same bytes), else by
  clamping scale bytes into range, else :class:`StreamIntegrityError`.

Containment relies on batch-row independence: every launch computes slot
rows independently, so evicting a poisoned slot leaves the other slots'
tokens bit-identical to a fault-free run (tests/test_torch_faults.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.codecs import (PackedTensor, get_codec, packed_leaves,
                                     validate_packed, validate_packed_tree)

__all__ = [
    "HEALTHY", "DEGRADED", "FAILED", "HEALTH_LEVEL",
    "TransientStepError", "EngineFailedError", "StreamIntegrityError",
    "GuardConfig", "SentinelMailbox", "EngineGuard",
    "probe_logits", "probe_kv", "verify_packed_tree",
]

HEALTHY, DEGRADED, FAILED = "healthy", "degraded", "failed"
HEALTH_LEVEL = {HEALTHY: 0, DEGRADED: 1, FAILED: 2}

# u8 scale byte that no encoder emits: E8M0 reserved (decodes to 2^128).
# Byte 0 is legal in a KV page: it is the zero-init of an empty page.
_POISON_SCALE_BYTE = 255


class TransientStepError(RuntimeError):
    """A launch failed before touching device state and is safe to retry:
    the caches, which a launch writes in place, are untouched."""


class EngineFailedError(RuntimeError):
    """The engine's fault budget is exhausted (FAILED state); it refuses
    further steps. Restart from a verified checkpoint."""


class StreamIntegrityError(RuntimeError):
    """Packed weight streams are corrupt and no repair path is available
    (no source weights to re-quantize from, damage beyond scale clamping).
    ``leaves`` maps leaf path -> problem list."""

    def __init__(self, message: str, leaves: Optional[dict] = None):
        super().__init__(message)
        self.leaves = leaves or {}


@dataclasses.dataclass
class GuardConfig:
    """Fault-tolerance knobs for :class:`EngineGuard`.

    nan_checks / kv_checks : run the logits / KV sentinels in every launch.
        With both off the launches run the model alone.
    watchdog_s : wall-clock budget per launch; a slower step trips the
        watchdog and degrades the engine (None = no watchdog). Warm the
        engine first: the first launch on the card builds the kernels.
    max_step_retries : retries of a launch that raised
        :class:`TransientStepError` before the engine gives up and FAILs.
    retry_backoff_s : sleep before retry i is ``retry_backoff_s * 2**i``.
    recovery_steps : consecutive clean steps after which a DEGRADED engine
        returns to HEALTHY.
    max_quarantines : quarantine budget; exceeding it FAILs the engine
        (None = unlimited: quarantines degrade but never kill).
    verify_on_admit : probability of validating one packed weight's
        streams when requests are admitted (0.0 = never).
    seed : RNG seed of the verify-on-admit coin flips and picks.
    """

    nan_checks: bool = True
    kv_checks: bool = True
    watchdog_s: Optional[float] = None
    max_step_retries: int = 2
    retry_backoff_s: float = 0.05
    recovery_steps: int = 3
    max_quarantines: Optional[int] = None
    verify_on_admit: float = 0.0
    seed: int = 0


class SentinelMailbox:
    """Accumulates the sentinels' per-slot counts between launches:
    ``deliver`` adds a count vector for a site, ``drain`` returns and clears
    {site: summed counts}. The engine delivers from its own thread, so no
    lock is needed."""

    def __init__(self):
        self._counts: Dict[str, np.ndarray] = {}

    def deliver(self, site: str, counts) -> None:
        c = np.asarray(counts, np.int64).reshape(-1)
        prev = self._counts.get(site)
        self._counts[site] = c if prev is None else prev + c

    def drain(self) -> Dict[str, np.ndarray]:
        out, self._counts = self._counts, {}
        return out


def probe_logits(logits: torch.Tensor, lengths=None) -> torch.Tensor:
    """Per-slot count of non-finite values in the logit row each slot
    samples from, as (B,) int32 on ``logits``' device.

    ``logits``: (B, V). ``lengths``: optional (B,) planned chunk lengths;
    rows planned 0 tokens are masked out (an idle prefill row softmaxes
    over an all-masked attention window and may be NaN: nothing samples
    from it)."""
    bad = (~torch.isfinite(logits.float())).sum(-1)
    if lengths is not None:
        bad = torch.where(lengths > 0, bad, torch.zeros_like(bad))
    return bad.to(torch.int32)


def _page_tensors(leaf):
    """(stream name, tensor) of a K or V page: bf16, or packed streams."""
    if isinstance(leaf, dict):
        return list(leaf.items())
    return [("", leaf)]


def probe_kv(caches: dict, n_slots: int) -> torch.Tensor:
    """Per-slot poison count over the cache pool, as (n_slots,) int32 on
    the caches' device. Call on the caches after the launch wrote them.

    The port's caches are lists of per-layer dicts (``layers``; for the
    recurrent families ``mlstm``/``slstm`` or ``mamba``/``attn``) with the
    slot on axis 0. Counted: non-finite values in float pages and
    recurrent states (an empty mLSTM/sLSTM log-max of -1e30 is finite),
    and the reserved byte 255 in packed ``scales`` streams (codes and meta
    bytes are all legal, and the integer ``pos`` tracks are skipped)."""
    counts = []
    for blocks in caches.values():
        for layer in blocks:
            for name, leaf in layer.items():
                if name == "pos":
                    continue
                for stream, t in _page_tensors(leaf):
                    flat = t.reshape(n_slots, -1)
                    if t.dtype.is_floating_point:
                        counts.append((~torch.isfinite(flat)).sum(-1))
                    elif t.dtype == torch.uint8 and stream == "scales":
                        counts.append((flat == _POISON_SCALE_BYTE).sum(-1))
    return torch.stack(counts).sum(0).to(torch.int32)


class EngineGuard:
    """Health state machine and fault accounting for one ``ServeEngine``.

    The engine delivers the sentinels' counts after every launch and
    drains them (:meth:`drain`), records contained faults through the
    ``record_*`` methods, and calls :meth:`note_step` at the end of each
    step, which runs the watchdog and the DEGRADED -> HEALTHY recovery
    streak. All ``repro_guard_*`` metrics are gated by ``REPRO_OBS``
    (``obs.enabled()``) like every other pillar."""

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg or GuardConfig()
        self.state = HEALTHY
        self.mailbox = SentinelMailbox()
        self.quarantines = 0
        self.scrubs = 0
        self.retries = 0
        self.watchdog_trips = 0
        self.expired = 0
        self.shed = 0
        self.degraded_steps = 0
        self.fail_reason = ""
        self._streak = 0                   # consecutive clean steps
        self._dirty_step = False           # fault recorded this step
        self._rng = np.random.default_rng(self.cfg.seed)
        self._set_state_gauge()

    # -- state machine -----------------------------------------------------

    def _set_state_gauge(self) -> None:
        if obs.enabled():
            obs.gauge("repro_guard_health_state",
                      "engine health (0 healthy, 1 degraded, 2 failed)"
                      ).set(HEALTH_LEVEL[self.state])

    def _escalate(self, to: str) -> None:
        if HEALTH_LEVEL[to] > HEALTH_LEVEL[self.state]:
            self.state = to
            self._set_state_gauge()

    def degrade(self) -> None:
        self._streak = 0
        self._dirty_step = True
        self._escalate(DEGRADED)

    def fail(self, reason: str) -> None:
        self.fail_reason = self.fail_reason or reason
        self._escalate(FAILED)

    def check_alive(self) -> None:
        if self.state == FAILED:
            raise EngineFailedError(
                f"engine is FAILED ({self.fail_reason}); restart from a "
                f"verified checkpoint (load_packed_checkpoint(..., "
                f"verify=True))")

    def note_step(self, dt: float) -> None:
        """End-of-step bookkeeping: watchdog + recovery streak."""
        if self.cfg.watchdog_s is not None and dt > self.cfg.watchdog_s:
            self.watchdog_trips += 1
            if obs.enabled():
                obs.counter("repro_guard_watchdog_trips_total",
                            "launches over the wall-clock budget").inc()
            self.degrade()
        if self.state == DEGRADED:
            self.degraded_steps += 1
            if obs.enabled():
                obs.counter("repro_guard_degraded_steps_total",
                            "steps served while DEGRADED").inc()
            if self._dirty_step:
                self._streak = 0
            else:
                self._streak += 1
                if self._streak >= self.cfg.recovery_steps:
                    self.state = HEALTHY
                    self._streak = 0
                    self._set_state_gauge()
        self._dirty_step = False

    # -- sentinel plumbing -------------------------------------------------

    def drain(self) -> Dict[str, np.ndarray]:
        """{site: per-slot poison counts} delivered since the last drain."""
        return self.mailbox.drain()

    # -- fault accounting --------------------------------------------------

    def record_quarantine(self, site: str) -> None:
        self.quarantines += 1
        if obs.enabled():
            obs.counter("repro_guard_quarantine_total",
                        "requests evicted for poisoned state").inc(site=site)
        self.degrade()
        if self.cfg.max_quarantines is not None \
                and self.quarantines > self.cfg.max_quarantines:
            self.fail(f"quarantine budget exhausted "
                      f"({self.quarantines} > {self.cfg.max_quarantines})")

    def record_scrub(self, site: str) -> None:
        """Poison seen in an *unoccupied* slot: scrubbed, nobody evicted."""
        self.scrubs += 1
        if obs.enabled():
            obs.counter("repro_guard_scrub_total",
                        "idle-slot cache scrubs").inc(site=site)
        self.degrade()

    def record_retry(self) -> None:
        self.retries += 1
        if obs.enabled():
            obs.counter("repro_guard_step_retries_total",
                        "transient launch failures retried").inc()
        self.degrade()

    def record_expired(self, where: str, n: int = 1) -> None:
        self.expired += n
        if obs.enabled():
            obs.counter("repro_guard_expired_total",
                        "requests past their deadline").inc(n, where=where)

    def record_shed(self, reason: str) -> None:
        self.shed += 1
        if obs.enabled():
            obs.counter("repro_guard_shed_total",
                        "requests rejected at admission").inc(reason=reason)

    def maybe_verify_admit(self) -> bool:
        """Seeded coin flip for the verify-on-admit spot check."""
        p = self.cfg.verify_on_admit
        return p > 0 and bool(self._rng.random() < p)

    def summary(self) -> dict:
        return {
            "state": self.state,
            "quarantines": self.quarantines,
            "scrubs": self.scrubs,
            "retries": self.retries,
            "watchdog_trips": self.watchdog_trips,
            "expired": self.expired,
            "shed": self.shed,
            "degraded_steps": self.degraded_steps,
            "fail_reason": self.fail_reason,
        }


# ---------------------------------------------------------------------------
# Packed-stream verification with graceful degradation
# ---------------------------------------------------------------------------

def _replace_packed(tree, fixed: dict, path=(), layer=0):
    """``tree`` with the packed leaves named in ``fixed`` ({reference key:
    [leaf per layer]}) replaced; the other leaves are shared, not copied."""
    if isinstance(tree, PackedTensor):
        leaves = fixed.get("/".join(path))
        return tree if leaves is None else leaves[layer]
    if isinstance(tree, dict):
        return {k: _replace_packed(v, fixed, path + (str(k),), layer)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replace_packed(v, fixed, path, i)
                for i, v in enumerate(tree)]
    return tree


def verify_packed_tree(packed, cfg=None, source_params=None,
                       repair: bool = True):
    """Codec stream validation over a packed weight dict, with repair.

    Returns ``(tree, repairs)`` where ``repairs`` is a list of ``(reference
    key, mode)``, empty when every stream was intact (then ``tree is
    packed``). Repair modes, best first:

    ``requantize``
        ``source_params`` (the dense dict) and ``cfg`` given: re-pack the
        source and splice the fresh leaves over the broken ones (every
        layer of the weight). The encoders are deterministic, so this is an
        exact restore.
    ``clamp``
        No source, but the damage is confined to u8 scale bytes: clamp them
        into the codec's legal range, so values decode wrong by a bounded
        factor instead of to inf/NaN.

    Anything else raises :class:`StreamIntegrityError` naming the leaves.
    The given tree is not modified. Metrics:
    ``repro_guard_stream_invalid_total{stage="weights"}`` per bad weight,
    ``repro_guard_stream_repair_total{mode}`` per repair."""
    report = validate_packed_tree(packed)
    if not report:
        return packed, []
    if obs.enabled():
        obs.counter("repro_guard_stream_invalid_total",
                    "packed leaves failing codec stream validation").inc(
            len(report), stage="weights")
    if not repair:
        detail = "; ".join(f"{k}: {'; '.join(v)}"
                           for k, v in sorted(report.items()))
        raise StreamIntegrityError(
            f"{len(report)} packed leaf(s) violate codec stream invariants "
            f"and repair is disabled ({detail})", leaves=report)

    fresh = {}
    if source_params is not None and cfg is not None:
        from .prequant import prequantize_params
        fresh = packed_leaves(prequantize_params(source_params, cfg))

    repairs, unrepairable, fixed = [], {}, {}
    for key, (stacked, leaves) in packed_leaves(packed).items():
        if key not in report:
            continue
        if key in fresh:
            fixed[key] = fresh[key][1]
            repairs.append((key, "requantize"))
            continue
        clamped = [_clamp_scales(leaf, get_codec(leaf.codec))
                   for leaf in leaves]
        if all(c is not None for c in clamped) and not validate_packed(
                clamped if stacked else clamped[0]):
            fixed[key] = clamped
            repairs.append((key, "clamp"))
        else:
            unrepairable[key] = report[key]
    if unrepairable:
        detail = "; ".join(f"{k}: {'; '.join(v)}"
                           for k, v in sorted(unrepairable.items()))
        raise StreamIntegrityError(
            f"{len(unrepairable)} packed leaf(s) are corrupt beyond scale "
            f"clamping and no source weights were given to re-quantize "
            f"from ({detail}); re-run prequantize_checkpoint",
            leaves=unrepairable)
    if obs.enabled():
        for _, mode in repairs:
            obs.counter("repro_guard_stream_repair_total",
                        "packed-leaf repairs by mode").inc(mode=mode)
    return _replace_packed(packed, fixed), repairs


def _clamp_scales(p: PackedTensor, codec) -> Optional[PackedTensor]:
    """A copy of ``p`` with its u8 scale bytes pulled into the codec's
    legal range: E8M0 bytes clamped into [1, 254], E4M3 NaN patterns
    (0x7F / 0xFF) lowered to the largest normal (0x7E / 0xFE); None if it
    has no such stream to clamp."""
    sc = p.streams.get("scales")
    if sc is None or sc.dtype != torch.uint8:
        return None
    if codec.scale_kind == "e8m0":
        fixed = sc.clamp(1, 254)
    elif codec.scale_kind == "e4m3":
        fixed = torch.where((sc & 0x7F) == 0x7F, sc - 1, sc)
    else:
        return None
    return PackedTensor({**p.streams, "scales": fixed}, p.shape, p.codec)
