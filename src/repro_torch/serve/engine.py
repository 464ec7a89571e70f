"""Batched autoregressive serving engine over packed weights (port of
repro.serve.engine).

The engine owns a packed parameter dict (``prequantize_params`` or
``load_packed_checkpoint``), per-slot KV caches (``init_caches``: batch row
b is request slot b, with its own position track; the K/V pages are bf16,
or packed in ``cfg.kv_quant``, e.g. m2xfp at 4.5 bits per element) and a
host-side ``SlotScheduler``. Every step is ONE
launch over all slots: when every planned chunk is one token it is a
``decode_step``; otherwise a ``prefill_chunk`` in which prefilling slots
consume up to ``prefill_chunk`` prompt tokens, decode slots their next
token, and idle slots nothing (length 0, masked out of every cache write).
Both launches give bit-identical logits per token. Admission resets only
the slot's position track, which masks every stale KV entry, packed bytes
included.

The guard (``repro_torch.serve.guard``) is on by default: each launch also
runs the poison sentinels on the device, and their per-slot counts come to
the host in the same copy as the sampled logit rows. A slot whose logits or
cache pages are poisoned is quarantined and scrubbed (its pages zeroed in
every layer) while the other slots go on bit-identical; a launch that
raises :class:`TransientStepError` before it runs is retried; requests may
carry deadlines and the admission queue may be bounded. Nothing else is
caught: a CUDA error propagates, and no step moves to the CPU.

Telemetry (``repro_torch.obs``, gated by ``REPRO_OBS``) is the reference's:
spans around run, step, admit, plan, the phase, each launch
(``serve.kernel.dispatch``) and the sampling, instants at expiry,
quarantine and eviction; step, token, TTFT, queue and occupancy metrics;
and under the ``health`` pillar a per-layer sweep of the packed weights at
start-up and the probes of each launch, whose statistics come to the host
in the launch's one copy. With ``REPRO_OBS`` unset a launch runs exactly
the kernels it runs without telemetry; with the ``metrics`` and ``trace``
pillars alone too (they are host-side).

Tensor parallelism (ROADMAP A13): an engine built under ``use_sharding``
with a ``DeviceMesh`` that has a "model" dim, on placed parameters
(``place_tree(params, param_shardings(params, mesh))``; unplaced ones
serve as without a mesh), places its caches
at ``cache_shardings`` and runs every launch under that mesh, so each
product runs on the rank's weight shard (``repro_torch.distributed.tp``)
and the K/V pages stay sequence-sharded. Every rank runs the same engine
with the same requests and samples the same tokens from the whole logits.
The recurrent families' states are placed by the same specs: Mamba2's
``ssm`` and the mLSTM's C, n and m head-sharded (each rank's decode
updates its own heads), the conv windows and the sLSTM's c and h
replicated (n and m, sharded over "heads" by name, are gathered for the
sLSTM's whole step). Slot resets and scrubs write each rank's own part of
the pages and states, and the KV sentinel's counts are summed over
"model", so the guard decides alike on every rank. The start-up weight
sweep of the ``health`` pillar reads the gathered weights (a diagnostic,
off the serve path). The batch (slot) dims stay whole: a mesh whose
"data" dims are larger than 1 is refused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.codecs import PackedTensor, packed_leaves, \
    validate_packed
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import (cache_shardings, current_rules,
                                              gather_tree, local_tree,
                                              map_with_path, place_tree,
                                              use_sharding)
from repro_torch.models.model import RECURRENT, decode_step, init_caches, \
    prefill_chunk
from repro_torch.models.quant import pad_row_shards, traced_once
from repro_torch.obs import quant_health
from . import guard as _guard
from .guard import (EngineFailedError, EngineGuard, GuardConfig,
                    TransientStepError)
from .scheduler import AdmissionError, Request, SlotScheduler

# TTFT is quantized in engine steps; buckets cover 1..256-step prompts
_TTFT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_OFF = contextlib.nullcontext()     # a launch's telemetry with REPRO_OBS off

__all__ = ["ServeEngine", "ServeStats", "tree_nbytes"]


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor in a nested dict / list / PackedTensor
    (what the tree keeps resident)."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, PackedTensor):
        tree = tree.streams
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(x) for x in tree)
    return 0


@dataclasses.dataclass
class ServeStats:
    n_slots: int = 1
    steps: int = 0                 # launches (decode or mixed prefill)
    decode_steps: int = 0          # pure one-token launches
    prefill_steps: int = 0         # launches that carried prefill chunks
    slot_steps: int = 0            # sum over steps of slots making progress
    prefill_tokens: int = 0        # prompt tokens fed (excl. sampling step)
    generated_tokens: int = 0      # tokens sampled and returned
    wall_s: float = 0.0
    prefill_wall_s: float = 0.0    # wall attributed to prefill launches
    decode_wall_s: float = 0.0     # wall attributed to pure decode launches
    quarantined: int = 0           # requests evicted for poisoned state
    expired: int = 0               # requests past their deadline
    shed: int = 0                  # requests rejected at admission

    @property
    def tokens_per_sec(self) -> float:
        total = self.prefill_tokens + self.generated_tokens
        return total / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def prefill_tokens_per_sec(self) -> float:
        if self.prefill_wall_s <= 0:
            return 0.0
        return self.prefill_tokens / self.prefill_wall_s

    @property
    def decode_tokens_per_sec(self) -> float:
        if self.decode_wall_s <= 0:
            return 0.0
        return self.generated_tokens / self.decode_wall_s

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per step."""
        if not self.steps:
            return 0.0
        return self.slot_steps / (self.steps * self.n_slots)

    def to_dict(self) -> dict:
        """Every field plus every derived property, as plain floats/ints."""
        out = dataclasses.asdict(self)
        out.update(
            tokens_per_sec=self.tokens_per_sec,
            prefill_tokens_per_sec=self.prefill_tokens_per_sec,
            decode_tokens_per_sec=self.decode_tokens_per_sec,
            occupancy=self.occupancy,
        )
        return out


def _greedy(logits: np.ndarray) -> np.ndarray:
    """(B, V) -> (B,) argmax token ids (first maximum on ties)."""
    return np.argmax(logits, axis=-1).astype(np.int32)


def _reset_slot(caches: dict, slot: int, scrub: bool = False) -> None:
    """Put one slot's rows of every layer's cache back in their init state,
    in place. An admit-time reset writes the position track (-1 masks
    every stale K/V entry) and every recurrent state (``mlstm``, ``slstm``,
    ``mamba``: the running log-max ``m`` to -1e30, the rest to 0), as the
    reference does. ``scrub=True`` (quarantine) also zeroes the slot's
    bf16 pages or every packed stream: a poisoned page (NaN, scale byte
    255) would trip the KV sentinel every later step if left masked but
    resident, and zero is every page stream's init state."""
    for group, blocks in caches.items():
        recurrent = group in RECURRENT
        for block in blocks:
            for name, leaf in block.items():
                if name == "pos":
                    leaf[slot] = -1
                elif recurrent:
                    leaf[slot] = -1e30 if name == "m" else 0.0
                elif scrub:
                    for t in (leaf.values() if isinstance(leaf, dict)
                              else (leaf,)):
                        t[slot] = 0


def _placed(params) -> bool:
    """Whether any parameter leaf is a DTensor (placed on a mesh)."""
    found = []
    map_with_path(lambda _, t: found.append(tp.is_dtensor(t)), params)
    return any(found)


def _launches(cfg, n_slots: int, nan_checks: bool, kv_checks: bool,
              group=None):
    """The engine's decode and prefill launches. Each runs the model on the
    caches in place and returns (logits, {site: per-slot sentinel counts on
    the device}), the counts of the checks that are on. With ``group`` (the
    "model" group of placed caches) the KV counts of each rank's part of
    the pages are summed over it."""
    def sentinels(rows, lengths, caches) -> dict:
        out = {}
        if nan_checks:
            out["logits"] = _guard.probe_logits(rows, lengths)
        if kv_checks:
            if group is None:
                out["kv"] = _guard.probe_kv(caches, n_slots)
            else:
                import torch.distributed as dist
                counts = _guard.probe_kv(local_tree(caches), n_slots)
                dist.all_reduce(counts, group=group)
                out["kv"] = counts
        return out

    def decode(p, b, c, i):
        logits = decode_step(p, cfg, b, c, i)
        # decode rows always attend over >= 1 valid entry (the token just
        # written), so no masking is needed
        return logits, sentinels(logits[:, -1], None, c)

    def prefill(p, b, c, i, lengths):
        logits = prefill_chunk(p, cfg, b, c, i, lengths)
        # probe only the row each slot samples from; idle rows (length 0)
        # softmax over an all-masked window
        rows = logits[torch.arange(logits.shape[0], device=logits.device),
                      (lengths - 1).clamp_min(0)]
        return logits, sentinels(rows, lengths, c)

    return decode, prefill


class ServeEngine:
    """Continuous-batching decode engine. See module docstring.

    params : packed parameter dict on ``device`` (``prequantize_params``),
        or a dense one when ``cfg.quant != 'serve'``.
    cfg : ModelConfig, normally with ``quant='serve'``.
    n_slots : batch width = concurrently served requests.
    max_len : cache capacity per slot (prompt + generated tokens).
    sample_fn : (B, V) f32 numpy logits -> (B,) token ids; greedy default.
    prefill_chunk : max prompt tokens a slot consumes per step; 1 for the
        recurrent ``ssm`` and ``hybrid`` families whatever is asked, as in
        the reference (their state takes one token at a time).
    prefill_budget : cap on prefill tokens per step across slots (None =
        unlimited); the oldest prefilling request always progresses.
    guard : ``GuardConfig``; None (default) = guard on with default knobs
        (sentinels, quarantine, retries, health state machine), ``False``
        = guard off: the launches run the model alone.
    max_queue : bound on the admission queue (None = unbounded); a full
        queue sheds submissions with ``AdmissionError``.
    default_ttl_steps : deadline in engine steps for every request that
        carries no ``ttl_steps`` of its own (None = no deadline).
    verify_weights : validate the packed streams at init and repair broken
        weights (``guard.verify_packed_tree``).
    source_params : optional dense parameter dict, for exact repair by
        re-quantization.
    device : where the caches live; the parameters must be there too.
    """

    def __init__(self, params, cfg, n_slots: int = 8, max_len: int = 256,
                 sample_fn: Optional[Callable] = None,
                 prefill_chunk: int = 8,
                 prefill_budget: Optional[int] = None,
                 guard=None, max_queue: Optional[int] = None,
                 default_ttl_steps: Optional[int] = None,
                 verify_weights: bool = False, source_params=None,
                 device="cuda"):
        if cfg.input_mode == "embeddings":
            # the reference's engine builds, then fails at its first step
            # (KeyError 'embeds'): its launches always pass token ids
            raise NotImplementedError(
                f"{cfg.name}: input_mode='embeddings' cannot be served by "
                f"the engine, whose prompts are token ids; run the model "
                f"directly: decode_step and prefill_chunk take "
                f'{{"embeds": (B, T, d_model)}}')
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sample_fn = sample_fn or _greedy
        self.chunk = max(1, int(prefill_chunk))
        if cfg.family in ("ssm", "hybrid"):
            self.chunk = 1           # recurrent state updates token by token
        self.prefill_budget = prefill_budget
        self.device = torch.device(device)
        if guard is False:
            gcfg = None
        else:
            gcfg = guard if isinstance(guard, GuardConfig) else GuardConfig()
        self.guard: Optional[EngineGuard] = \
            EngineGuard(gcfg) if gcfg is not None else None
        self.default_ttl_steps = default_ttl_steps
        self.source_params = source_params
        # sliding-window configs accept prompts longer than the page (the
        # reference's rule: with local/global layers the global rings wrap
        # too)
        self.scheduler = SlotScheduler(
            n_slots, max_queue=max_queue,
            max_prompt_len=None if cfg.sliding_window else max_len)
        self.stats = ServeStats(n_slots=n_slots)

        if verify_weights:
            self.params, repairs = _guard.verify_packed_tree(
                params, cfg=cfg, source_params=source_params)
            # clamped weights decode degraded (bounded error): say so
            if self.guard and any(mode == "clamp" for _, mode in repairs):
                self.guard.degrade()

        self.caches = init_caches(cfg, n_slots, max_len, self.device)
        self._mesh = None
        if tp.tp_mesh() is not None and _placed(params):
            self._place()
        self._tokens = np.zeros((n_slots, 1), np.int64)   # last sampled
        self._index = np.zeros((n_slots,), np.int64)      # absolute position

        # FaultInjector wraps these two attributes
        self._step, self._prefill = _launches(
            cfg, n_slots, bool(gcfg and gcfg.nan_checks),
            bool(gcfg and gcfg.kv_checks),
            tp.tp_mesh().get_group() if self._mesh is not None else None)
        # telemetry state: the probes of the launch in flight, and the
        # serve-GEMM call sites counted per launch kind (the reference
        # counts them once per trace of each jitted launch)
        self._probes = quant_health.ProbeBuffer()
        self._gemm_sites = {"decode_step": set(), "prefill_chunk": set()}

        # quantization-health sweep of the packed weights: per-layer clip
        # rate / scale saturation / meta modes / re-encode drift gauges,
        # once at startup (off the decode hot path)
        if obs.enabled("health"):
            with obs.span("serve.weight_health", cat="obs"):
                obs.quant_health.weight_tree_health(
                    gather_tree(params) if self._mesh is not None
                    else params)

    def _place(self) -> None:
        """Tensor-parallel serving (module docstring): keep the active mesh
        and rules for the launches, place the caches, and give each packed
        weight whose row shard splits 32-groups its padded shard
        (``pad_row_shards``, ROADMAP C3)."""
        from repro_torch.distributed.sharding import active_mesh
        from repro_torch.launch.mesh import mesh_axis_sizes
        mesh = active_mesh()
        sizes = mesh_axis_sizes(mesh)
        if any(n > 1 for a, n in sizes.items() if a != "model"):
            raise NotImplementedError(
                f"a tensor-parallel engine keeps its slots whole: mesh "
                f"{sizes} has batch dims larger than 1")
        self._mesh, self._rules = mesh, current_rules()
        self.params = pad_row_shards(self.params)
        self.caches = place_tree(self.caches,
                                 cache_shardings(self.caches, mesh))

    def _sharded(self):
        """The launches' sharding context (a no-op unplaced)."""
        if self._mesh is None:
            return _OFF
        return use_sharding(self._mesh, self._rules)

    def _local_caches(self) -> dict:
        """The caches as this rank's tensors (aliases of placed leaves)."""
        return self.caches if self._mesh is None else local_tree(self.caches)

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               ttl_steps: Optional[int] = None) -> Request:
        """Queue a request; it is admitted when a slot frees up.

        Raises ``ValueError`` on an invalid request (empty prompt,
        non-positive ``max_new_tokens``, prompt + generation beyond
        ``max_len`` unless ``cfg.sliding_window`` is set),
        :class:`AdmissionError` when the queue is full
        (counted as shed), :class:`EngineFailedError` once the engine's
        fault budget is exhausted."""
        if self.guard:
            self.guard.check_alive()
        if prompt and len(prompt) + max_new_tokens > self.max_len \
                and not self.cfg.sliding_window:
            raise ValueError(
                f"prompt+generation {len(prompt)}+{max_new_tokens} exceeds "
                f"cache capacity {self.max_len}")
        if ttl_steps is None:
            ttl_steps = self.default_ttl_steps
        try:
            return self.scheduler.submit(
                list(prompt), max_new_tokens, eos_id,
                ttl_steps=ttl_steps, step=self.stats.steps)
        except AdmissionError as e:
            self.stats.shed += 1
            if self.guard:
                self.guard.record_shed(e.reason)
            raise

    def _admit(self) -> None:
        admitted = self.scheduler.admit(self.stats.steps)
        for req in admitted:
            _reset_slot(self._local_caches(), req.slot)
            self._index[req.slot] = 0
        if admitted and self.guard and self.guard.maybe_verify_admit():
            self._spot_check_weights()

    def _spot_check_weights(self) -> None:
        """verify_on_admit: validate one seeded pick of the packed weights
        (all its layers); on damage, repair the whole dict (re-quantize
        from source when available, else clamp) and degrade."""
        weights = list(packed_leaves(self.params).values())
        if not weights:
            return
        stacked, leaves = weights[int(self.guard._rng.integers(len(weights)))]
        if not validate_packed(leaves if stacked else leaves[0]):
            return
        if obs.enabled():
            obs.counter("repro_guard_stream_invalid_total",
                        "packed leaves failing codec stream validation"
                        ).inc(stage="admit")
        self.params, _ = _guard.verify_packed_tree(
            self.params, cfg=self.cfg, source_params=self.source_params)
        if self._mesh is not None:       # the repaired leaves' padded shards
            with self._sharded():
                self.params = pad_row_shards(self.params)
        self.guard.degrade()

    # -- launches ----------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fetch(self, rows: torch.Tensor, counts: dict) -> np.ndarray:
        """Copy the sampled rows (B, V) f32, the sentinels' per-slot counts
        and the launch's pending health-probe statistics to the host in one
        copy (one wait for the device), deliver the counts to the guard's
        mailbox and the statistics to the registry, return the rows."""
        sites = list(counts)
        keys, stats = self._probes.take()
        if not sites and not stats:
            return rows.float().cpu().numpy()  # reprolint: disable=host-sync -- the launch's one copy of its results to the host, which the sampler reads
        b, v = rows.shape
        table = torch.cat([rows.float().view(torch.int32)]
                          + [counts[s].to(torch.int32)[:, None]
                             for s in sites], dim=1)        # (B, V + sites)
        if stats:
            flat = torch.cat([table.reshape(-1), torch.stack(stats).view(  # reprolint: disable=host-sync -- the launch's one copy of its results to the host, which the sampler reads
                torch.int32).reshape(-1)]).cpu().numpy()
            cut = table.numel()
            self._probes.deliver(keys, flat[cut:].copy().view(
                np.int64).reshape(len(stats), -1))
            host = flat[:cut].reshape(table.shape)
        else:
            host = table.cpu().numpy()  # reprolint: disable=host-sync -- the launch's one copy of its results to the host, which the sampler reads
        for j, site in enumerate(sites):
            self.guard.mailbox.deliver(site, host[:, v + j])
        return np.ascontiguousarray(host[:, :v]).view(np.float32)

    def _observed(self, kind: str, **args):
        """The telemetry of one launch of ``kind``: with ``REPRO_OBS`` off
        a shared no-op context; else the ``serve.kernel.dispatch`` span,
        the kind's serve-GEMM call sites (``traced_once``) and this engine's
        probe buffer (drained by ``_fetch``)."""
        if not obs.pillars():
            return _OFF
        stack = contextlib.ExitStack()
        stack.enter_context(obs.span("serve.kernel.dispatch", kind=kind,
                                     **args))
        stack.enter_context(traced_once(self._gemm_sites[kind]))
        stack.enter_context(quant_health.collect(self._probes))
        return stack

    def _launch_decode(self, chunks) -> np.ndarray:
        """One-token launch for every slot -> (B, V) f32 logits."""
        for slot, req in self.scheduler.active.items():
            if req.phase == "prefill":
                self._tokens[slot, 0] = req.prompt[req.consumed]
        with self._observed("decode_step", slots=self.n_slots), \
                self._sharded():
            logits, counts = self._step(
                self.params, {"tokens": self._to_device(self._tokens)},
                self.caches, self._to_device(self._index))
            return self._fetch(logits[:, -1], counts)

    def _launch_prefill(self, chunks) -> np.ndarray:
        """Mixed chunked launch -> (B, V) f32 logits at each slot's last
        valid position."""
        toks = np.zeros((self.n_slots, self.chunk), np.int64)
        lens = np.zeros((self.n_slots,), np.int64)
        for slot, req in self.scheduler.active.items():
            c = chunks.get(slot, 0)
            if c == 0:
                continue
            lens[slot] = c
            if req.phase == "prefill":
                toks[slot, :c] = req.prompt[req.consumed:req.consumed + c]
            else:
                toks[slot, 0] = self._tokens[slot, 0]
        with self._observed("prefill_chunk", slots=self.n_slots,
                            tokens=int(lens.sum())), self._sharded():
            logits, counts = self._prefill(
                self.params, {"tokens": self._to_device(toks)}, self.caches,
                self._to_device(self._index), self._to_device(lens))
            last = self._to_device(np.maximum(lens - 1, 0))
            rows = torch.arange(self.n_slots, device=self.device)
            return self._fetch(logits[rows, last], counts)

    # -- the step loop -----------------------------------------------------

    def step(self) -> int:
        """Admit, plan per-slot chunks, run one launch, route tokens.
        Returns the number of requests that finished this step.

        Raises :class:`EngineFailedError` once the guard's fault budget is
        exhausted (transient failures persisted past the retry budget, or
        quarantines beyond ``max_quarantines``)."""
        if self.guard:
            self.guard.check_alive()
        with obs.span("serve.step", step=self.stats.steps):
            return self._step_inner()

    def _guarded_launch(self, fn, chunks) -> np.ndarray:
        """Run a launch with the guard's retry policy. Only
        :class:`TransientStepError` is retried: it is raised before the
        launch writes the caches, so running it again is safe. Anything
        else (a CUDA error, a failed kernel build) propagates."""
        if not self.guard:
            return fn(chunks)
        attempts = 0
        while True:
            try:
                return fn(chunks)
            except TransientStepError as e:
                if attempts >= self.guard.cfg.max_step_retries:
                    self.guard.fail(
                        f"transient step failure persisted after "
                        f"{attempts} retries: {e}")
                    raise EngineFailedError(
                        f"launch failed {attempts + 1} times "
                        f"({e}); engine is FAILED") from e
                self.guard.record_retry()
                time.sleep(self.guard.cfg.retry_backoff_s * (2 ** attempts))
                attempts += 1

    def _expire_deadlines(self) -> None:
        for req in self.scheduler.expire(self.stats.steps):
            self.stats.expired += 1
            where = ("running" if req.fail_reason == "deadline_running"
                     else "queued")
            if self.guard:
                self.guard.record_expired(where)
            obs.instant("serve.expire", rid=req.rid, where=where)

    def _contain_faults(self, chunks, rows: np.ndarray) -> None:
        """Poisoned-slot containment, between launch and token routing.

        Unions the sentinels' counts with a host-side non-finite scan of
        the sampled rows, then for every flagged slot: quarantine its
        request (if occupied), scrub its cache rows to the init state, and
        mask it out of this step's routing. The other slots' rows are
        untouched, so their tokens stay bit-identical to a fault-free
        run."""
        faults = self.guard.drain()
        poisoned = {}                              # slot -> first bad site
        kv = faults.get("kv")
        if kv is not None:
            for slot in np.nonzero(kv)[0]:
                poisoned[int(slot)] = "kv"
        lg = faults.get("logits")
        if lg is not None:
            for slot in np.nonzero(lg)[0]:
                if chunks.get(int(slot), 0) > 0:
                    poisoned.setdefault(int(slot), "logits")
        # host-side check of the sampled rows (also covers a guard with the
        # sentinels turned off)
        for slot in np.nonzero(~np.isfinite(rows).all(axis=-1))[0]:
            if chunks.get(int(slot), 0) > 0:
                poisoned.setdefault(int(slot), "logits")
        for slot, site in sorted(poisoned.items()):
            occupied = slot in self.scheduler.active
            _reset_slot(self._local_caches(), slot, scrub=True)
            self._index[slot] = 0
            self._tokens[slot, 0] = 0
            chunks[slot] = 0                       # no routing this step
            if occupied:
                req = self.scheduler.quarantine(slot, self.stats.steps,
                                                reason=site)
                self.stats.quarantined += 1
                self.guard.record_quarantine(site)
                obs.instant("serve.quarantine", rid=req.rid, slot=slot,
                            site=site)
            else:
                self.guard.record_scrub(site)

    def _step_inner(self) -> int:
        self._expire_deadlines()
        with obs.span("serve.admit"):
            self._admit()
        if not self.scheduler.active:
            return 0
        with obs.span("serve.plan"):
            chunks = self.scheduler.plan_chunks(self.chunk,
                                                self.prefill_budget)
        decode_only = all(c == 1 for c in chunks.values())
        phase = "decode" if decode_only else "prefill"
        t0 = time.perf_counter()
        with obs.span(f"serve.phase.{phase}",
                      slots=len(self.scheduler.active)):
            launch = self._launch_decode if decode_only \
                else self._launch_prefill
            sampled_from = self._guarded_launch(launch, chunks)  # syncs
        dt = time.perf_counter() - t0
        if self.guard:
            self._contain_faults(chunks, sampled_from)
        with obs.span("serve.sample"):
            sampled = self.sample_fn(sampled_from)

        finished = 0
        first_tokens, new_prefill, new_generated = [], 0, 0
        self.stats.steps += 1
        if decode_only:
            self.stats.decode_steps += 1
            self.stats.decode_wall_s += dt
        else:
            self.stats.prefill_steps += 1
            self.stats.prefill_wall_s += dt
        for slot, req in list(self.scheduler.active.items()):
            c = chunks.get(slot, 0)
            if c == 0:
                continue                       # budget-starved: no progress
            self.stats.slot_steps += 1
            if req.phase == "prefill":
                req.consumed += c
                still_prefilling = req.consumed < len(req.prompt)
                fed = c - (0 if still_prefilling else 1)
                self.stats.prefill_tokens += fed
                new_prefill += fed
                if still_prefilling:
                    self._index[slot] += c
                    continue                   # logits discarded
                # the chunk ended on the last prompt token: its logits
                # sample the first generated token
            self.stats.generated_tokens += 1
            new_generated += 1
            tok = int(sampled[slot])
            req.output.append(tok)
            if req.first_token_step < 0:
                req.first_token_step = self.stats.steps
                first_tokens.append(req)
            self._tokens[slot, 0] = tok
            self._index[slot] += c
            if req.done:
                self.scheduler.evict(slot, self.stats.steps)
                obs.instant("serve.evict", rid=req.rid)
                finished += 1
        if self.guard:
            self.guard.note_step(dt)
        if obs.enabled():
            self._record_step_metrics(phase, dt, first_tokens,
                                      new_prefill, new_generated, finished)
        return finished

    def _record_step_metrics(self, phase, dt, first_tokens, new_prefill,
                             new_generated, finished) -> None:
        obs.histogram("repro_serve_step_latency_seconds",
                      "wall seconds per engine launch").observe(
            dt, phase=phase)
        obs.counter("repro_serve_steps_total",
                    "engine launches").inc(phase=phase)
        if new_prefill:
            obs.counter("repro_serve_tokens_total",
                        "tokens through the engine").inc(
                new_prefill, kind="prefill")
        if new_generated:
            obs.counter("repro_serve_tokens_total", "").inc(
                new_generated, kind="generated")
        if finished:
            obs.counter("repro_serve_requests_finished_total",
                        "requests that completed").inc(finished)
        for req in first_tokens:
            obs.histogram("repro_serve_ttft_steps",
                          "engine steps from admission to first token",
                          buckets=_TTFT_BUCKETS).observe(req.ttft_steps)
        obs.gauge("repro_serve_queue_depth",
                  "requests waiting for a slot").set(
            len(self.scheduler.queue))
        obs.gauge("repro_serve_active_slots",
                  "slots holding a running request").set(
            len(self.scheduler.active))
        obs.gauge("repro_serve_occupancy",
                  "mean fraction of slots progressing per step").set(
            self.stats.occupancy)

    def run(self) -> List[Request]:
        """Step until queue and slots drain. Returns the requests that
        finished during this drain, in submission order."""
        already_done = len(self.scheduler.finished)
        t0 = time.perf_counter()
        with obs.span("serve.run", slots=self.n_slots):
            while self.scheduler.has_work:
                self.step()
        self.stats.wall_s += time.perf_counter() - t0
        obs.autodump()          # metrics.jsonl + trace.json -> REPRO_OBS_DIR
        return sorted(self.scheduler.finished[already_done:],
                      key=lambda r: r.rid)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Submit every prompt, drain, return the outputs in order."""
        reqs = [self.submit(p, max_new_tokens, eos_id) for p in prompts]
        self.run()
        return [r.output for r in reqs]

    # -- accounting --------------------------------------------------------

    @property
    def health(self) -> str:
        """Current health state ('healthy' when the guard is off)."""
        return self.guard.state if self.guard else _guard.HEALTHY

    def guard_summary(self) -> dict:
        """Fault-accounting snapshot (state, quarantines, retries, ...);
        empty dict when the guard is off."""
        return self.guard.summary() if self.guard else {}

    def mean_ttft_steps(self) -> float:
        """Mean engine steps from admission to first sampled token, over
        every request that produced output."""
        ttfts = [r.ttft_steps for r in self.scheduler.finished
                 if r.ttft_steps >= 0]
        ttfts += [r.ttft_steps for r in self.scheduler.active.values()
                  if r.ttft_steps >= 0]
        return float(np.mean(ttfts)) if ttfts else 0.0

    def weight_bytes(self) -> int:
        return tree_nbytes(self.params)

    def kv_bytes(self) -> int:
        return tree_nbytes(self.caches)
