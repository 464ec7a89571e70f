"""Deterministic, seed-driven fault injection for the serving stack (port
of repro.testing.faults).

It injects the fault classes the engine's guard (``repro_torch.serve
.guard``) is built to contain:

* **bit flips in packed streams**: :func:`poison_kv_scale` writes the
  reserved scale byte 255 into one slot's packed KV page (what a flipped
  high bit does to a legal E8M0 byte); :func:`corrupt_checkpoint_leaf`
  flips one bit of one array inside a written checkpoint (the CRC-32 must
  catch it on load and name the leaf);
* **NaN activations**: a slot's logit row is overwritten with NaN after a
  launch (:class:`FaultInjector`), or a bf16 K/V page entry is poisoned
  (:func:`poison_kv_nan`);
* **truncated checkpoints**: :func:`truncate_checkpoint` cuts the npz
  short (restore must raise ``CheckpointCorruptError``);
* **delayed / failed steps**: a launch sleeps past the watchdog budget, or
  raises ``TransientStepError`` *before* the model runs. The port's
  launches write the caches in place, so a retryable fault must fire
  before the launch touches them; this harness guarantees it.

Everything is keyed on the engine's step counter and a :class:`FaultPlan`;
the same seed gives the same schedule (:func:`chaos_plan`) as the
reference's, and the cache poisoning writes the entry the reference's
writes, in place on the port's per-layer caches.

Usage::

    plan = chaos_plan(seed=7, n_slots=4, first_step=2, horizon=40)
    with FaultInjector(eng, plan) as inj:
        eng.run()
    assert eng.health != "failed"
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.serve.guard import TransientStepError

__all__ = [
    "FaultPlan", "FaultInjector", "chaos_plan",
    "poison_kv_scale", "poison_kv_nan",
    "corrupt_checkpoint_leaf", "truncate_checkpoint",
]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule, keyed on the engine step counter
    (``engine.stats.steps`` at launch time). Each entry fires exactly once:
    a launch retried after a transient failure sees no new fault."""

    seed: int = 0
    nan_logit_steps: Tuple[Tuple[int, int], ...] = ()   # (step, slot)
    kv_poison_steps: Tuple[Tuple[int, int], ...] = ()   # (step, slot)
    fail_steps: Tuple[int, ...] = ()                    # TransientStepError
    delay_steps: Tuple[Tuple[int, float], ...] = ()     # (step, seconds)

    def describe(self) -> str:
        return (f"FaultPlan(seed={self.seed}, "
                f"nan_logits={list(self.nan_logit_steps)}, "
                f"kv_poison={list(self.kv_poison_steps)}, "
                f"fails={list(self.fail_steps)}, "
                f"delays={list(self.delay_steps)})")


def chaos_plan(seed: int, n_slots: int, first_step: int = 2,
               horizon: int = 40, delay_s: float = 0.0) -> FaultPlan:
    """One fault of each class at seed-determined steps in ``[first_step,
    first_step + horizon)``: distinct steps, distinct slots, so every
    containment path runs on its own. ``first_step`` must be past the
    warm-up when a watchdog is armed."""
    rng = np.random.default_rng(seed)
    steps = first_step + rng.choice(max(4, horizon), size=4, replace=False)
    slots = rng.choice(n_slots, size=2, replace=n_slots < 2)
    return FaultPlan(
        seed=seed,
        nan_logit_steps=((int(steps[0]), int(slots[0])),),
        kv_poison_steps=((int(steps[1]), int(slots[1])),),
        fail_steps=(int(steps[2]),),
        delay_steps=(((int(steps[3]), delay_s),) if delay_s > 0 else ()),
    )


# ---------------------------------------------------------------------------
# Cache poisoning (in place on the engine's caches)
# ---------------------------------------------------------------------------

def _layer0_leaves(caches):
    """[(reference key, layer 0's tensor)] of the port's caches, in the
    order the reference flattens its layer-stacked caches (keys sorted at
    every level: ``attn/...`` before ``mamba/...``, ``mlstm/C`` before
    ``mlstm/conv``); each tensor has the slot on axis 0 where the
    reference's has the layer on axis 0 and the slot on axis 1."""
    out = []
    for group in sorted(caches):
        layer = caches[group][0]
        for name in sorted(layer):
            leaf = layer[name]
            if isinstance(leaf, dict):
                out += [(f"{group}/{name}/{s}", leaf[s])
                        for s in sorted(leaf)]
            else:
                out.append((f"{group}/{name}", leaf))
    return out


def _poison(caches, slot: int, pick, value) -> str:
    """Write ``value`` into layer 0 of the first leaf ``pick`` accepts, at
    ``slot``'s last page position (not overwritten by the slot's next KV
    write), head 0, element or group 0. Returns the reference's leaf
    path."""
    for key, t in _layer0_leaves(caches):
        if pick(key, t):
            pos = t.shape[1] - 1 if t.ndim >= 2 else 0
            at = (slot, pos)[:t.ndim] + (0,) * max(0, t.ndim - 2)
            t[at] = value
            return key
    raise ValueError("no matching cache leaf to poison")


def poison_kv_scale(caches, slot: int) -> str:
    """Write the reserved byte 255 over one entry of the first packed-KV
    u8 ``scales`` stream in ``slot``'s page (layer 0, K). Returns the leaf
    path (``layers/k/scales``). Needs a packed KV cache (``cfg.kv_quant``);
    raises ``ValueError`` otherwise."""
    return _poison(
        caches, slot,
        lambda k, t: k.endswith("scales") and t.dtype == torch.uint8, 255)


def poison_kv_nan(caches, slot: int) -> str:
    """NaN one entry of the first float K/V page (bf16 KV caches) in
    ``slot``'s row (layer 0, K). Returns the leaf path (``layers/k``, or
    ``attn/k`` for a hybrid model). Recurrent states are not pages: an
    ``ssm`` model has none, and raises ``ValueError`` as the reference
    does."""
    return _poison(caches, slot,
                   lambda k, t: t.dtype.is_floating_point and t.ndim >= 2
                   and not any(g in k for g in ("mlstm", "slstm", "mamba")),
                   float("nan"))


# ---------------------------------------------------------------------------
# Launch interception
# ---------------------------------------------------------------------------

class FaultInjector:
    """Wraps a ``ServeEngine``'s launches (``engine._step``,
    ``engine._prefill``) and fires the plan's faults at their steps. Use
    as a context manager (restores the launches on exit)::

        with FaultInjector(engine, plan) as inj:
            engine.run()
        inj.fired   # {(kind, step), ...}: what actually triggered

    At a planned step:

    ``fail``   raise :class:`TransientStepError` before the model runs
               (the caches are untouched, so a retry is safe).
    ``delay``  sleep before the launch (trips an armed watchdog).
    ``kv``     poison the planned slot's cache page before the launch
               (scale byte 255 with a packed KV cache, NaN with bf16).
    ``nan``    overwrite the planned slot's logits with NaN after the
               launch returns.
    """

    def __init__(self, engine, plan: FaultPlan):
        self.engine = engine
        self.plan = plan
        self.fired: set = set()
        self._orig_step = None
        self._orig_prefill = None

    # -- plan lookup (fire-once) -------------------------------------------

    def _take(self, kind: str, step: int):
        table = {
            "nan": dict(self.plan.nan_logit_steps),
            "kv": dict(self.plan.kv_poison_steps),
            "fail": {s: True for s in self.plan.fail_steps},
            "delay": dict(self.plan.delay_steps),
        }[kind]
        if step in table and (kind, step) not in self.fired:
            self.fired.add((kind, step))
            return table[step]
        return None

    # -- wrappers ----------------------------------------------------------

    def _pre(self, caches) -> None:
        step = self.engine.stats.steps
        delay = self._take("delay", step)
        if delay is not None:
            time.sleep(float(delay))
        if self._take("fail", step) is not None:
            raise TransientStepError(
                f"injected transient failure at step {step} "
                f"(seed {self.plan.seed})")
        slot = self._take("kv", step)
        if slot is not None:
            try:
                poison_kv_scale(caches, slot)
            except ValueError:
                poison_kv_nan(caches, slot)

    def _post_logits(self, logits: torch.Tensor) -> torch.Tensor:
        slot = self._take("nan", self.engine.stats.steps)
        if slot is not None:
            logits[slot] = float("nan")
        return logits

    def install(self) -> "FaultInjector":
        eng = self.engine
        if self._orig_step is not None:
            return self
        self._orig_step = eng._step
        self._orig_prefill = eng._prefill

        def step(p, b, c, i):
            self._pre(c)
            logits, counts = self._orig_step(p, b, c, i)
            return self._post_logits(logits), counts

        def prefill(p, b, c, i, lengths):
            self._pre(c)
            logits, counts = self._orig_prefill(p, b, c, i, lengths)
            return self._post_logits(logits), counts

        eng._step = step
        eng._prefill = prefill
        return self

    def uninstall(self) -> None:
        if self._orig_step is not None:
            self.engine._step = self._orig_step
            self.engine._prefill = self._orig_prefill
            self._orig_step = self._orig_prefill = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# ---------------------------------------------------------------------------
# On-disk checkpoint corruption
# ---------------------------------------------------------------------------

def _ckpt_npz(ckpt_dir: str, step: Optional[int]) -> str:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")


def corrupt_checkpoint_leaf(ckpt_dir: str, step: Optional[int] = None,
                            leaf: Optional[str] = None,
                            seed: int = 0) -> str:
    """Flip one bit of one array inside a written checkpoint and re-write
    the npz (the container stays well formed, so only the manifest's CRC-32
    can catch it). ``leaf`` picks the manifest key to damage (seed-chosen
    otherwise, as the reference chooses). Returns the damaged leaf's
    manifest key."""
    path = _ckpt_npz(ckpt_dir, step)
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    rng = np.random.default_rng(seed)
    keys = sorted(arrays)
    key = leaf.replace("/", "|") if leaf is not None \
        else keys[rng.integers(len(keys))]
    arr = arrays[key]
    raw = bytearray(arr.tobytes())
    if not raw:
        raise ValueError(f"leaf {key!r} has no bytes to corrupt")
    bit = int(rng.integers(8 * len(raw)))
    raw[bit // 8] ^= 1 << (bit % 8)
    arrays[key] = np.frombuffer(bytes(raw), dtype=arr.dtype
                                ).reshape(arr.shape)
    np.savez(path, **arrays)
    return key.replace("|", "/")


def truncate_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                        nbytes: int = 256) -> str:
    """Truncate a checkpoint's npz container to ``nbytes`` (a crash or a
    full disk mid-copy). Returns the truncated file's path."""
    path = _ckpt_npz(ckpt_dir, step)
    with open(path, "r+b") as f:
        f.truncate(nbytes)
    return path
