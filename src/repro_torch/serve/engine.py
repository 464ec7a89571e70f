"""Batched autoregressive serving engine over packed weights (port of
repro.serve.engine without its guard, telemetry and weight verification).

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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import decode_step, init_caches, prefill_chunk
from .scheduler import Request, SlotScheduler

__all__ = ["ServeEngine", "ServeStats"]


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


def _greedy(logits: np.ndarray) -> np.ndarray:
    """(B, V) -> (B,) argmax token ids (first maximum on ties)."""
    return np.argmax(logits, axis=-1).astype(np.int32)


class ServeEngine:
    """Continuous-batching decode engine. See module docstring.

    params : packed parameter dict on ``device`` (``prequantize_params``),
        or a dense one when ``cfg.quant != 'serve'``.
    cfg : ModelConfig, normally with ``quant='serve'``.
    n_slots : batch width = concurrently served requests.
    max_len : cache capacity per slot (prompt + generated tokens).
    sample_fn : (B, V) f32 numpy logits -> (B,) token ids; greedy default.
    prefill_chunk : max prompt tokens a slot consumes per step.
    prefill_budget : cap on prefill tokens per step across slots (None =
        unlimited); the oldest prefilling request always progresses.
    device : where the caches live; the parameters must be there too.
    """

    def __init__(self, params, cfg, n_slots: int = 8, max_len: int = 256,
                 sample_fn: Optional[Callable] = None,
                 prefill_chunk: int = 8,
                 prefill_budget: Optional[int] = None, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sample_fn = sample_fn or _greedy
        self.chunk = max(1, int(prefill_chunk))
        self.prefill_budget = prefill_budget
        self.device = torch.device(device)
        self.scheduler = SlotScheduler(n_slots, max_prompt_len=max_len)
        self.stats = ServeStats(n_slots=n_slots)
        self.caches = init_caches(cfg, n_slots, max_len, self.device)
        self._tokens = np.zeros((n_slots, 1), np.int64)   # last sampled
        self._index = np.zeros((n_slots,), np.int64)      # absolute position

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        """Queue a request; it is admitted when a slot frees up. Raises
        ``ValueError`` on an empty prompt, a non-positive
        ``max_new_tokens`` or prompt + generation beyond ``max_len``."""
        if prompt and len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+generation {len(prompt)}+{max_new_tokens} exceeds "
                f"cache capacity {self.max_len}")
        return self.scheduler.submit(list(prompt), max_new_tokens, eos_id,
                                     step=self.stats.steps)

    def _admit(self) -> None:
        for req in self.scheduler.admit(self.stats.steps):
            for cache in self.caches["layers"]:
                cache["pos"][req.slot] = -1
            self._index[req.slot] = 0

    # -- launches ----------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _launch_decode(self, chunks) -> np.ndarray:
        """One-token launch for every slot -> (B, V) f32 logits."""
        for slot, req in self.scheduler.active.items():
            if req.phase == "prefill":
                self._tokens[slot, 0] = req.prompt[req.consumed]
        logits = decode_step(self.params, self.cfg,
                             {"tokens": self._to_device(self._tokens)},
                             self.caches, self._to_device(self._index))
        return logits[:, -1].cpu().numpy()

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
        logits = prefill_chunk(self.params, self.cfg,
                               {"tokens": self._to_device(toks)},
                               self.caches, self._to_device(self._index),
                               self._to_device(lens))
        last = self._to_device(np.maximum(lens - 1, 0))
        rows = torch.arange(self.n_slots, device=self.device)
        return logits[rows, last].cpu().numpy()

    # -- the step loop -----------------------------------------------------

    def step(self) -> int:
        """Admit, plan per-slot chunks, run one launch, route tokens.
        Returns the number of requests that finished this step."""
        self._admit()
        if not self.scheduler.active:
            return 0
        chunks = self.scheduler.plan_chunks(self.chunk, self.prefill_budget)
        decode_only = all(c == 1 for c in chunks.values())
        t0 = time.perf_counter()
        launch = self._launch_decode if decode_only else self._launch_prefill
        sampled = self.sample_fn(launch(chunks))   # host copy synchronizes
        dt = time.perf_counter() - t0

        self.stats.steps += 1
        if decode_only:
            self.stats.decode_steps += 1
            self.stats.decode_wall_s += dt
        else:
            self.stats.prefill_steps += 1
            self.stats.prefill_wall_s += dt
        finished = 0
        for slot, req in list(self.scheduler.active.items()):
            c = chunks.get(slot, 0)
            if c == 0:
                continue                       # budget-starved: no progress
            self.stats.slot_steps += 1
            if req.phase == "prefill":
                req.consumed += c
                if req.consumed < len(req.prompt):
                    self.stats.prefill_tokens += c
                    self._index[slot] += c
                    continue                   # logits discarded
                # the chunk ended on the last prompt token: its logits
                # sample the first generated token
                self.stats.prefill_tokens += c - 1
            self.stats.generated_tokens += 1
            tok = int(sampled[slot])
            req.output.append(tok)
            if req.first_token_step < 0:
                req.first_token_step = self.stats.steps
            self._tokens[slot, 0] = tok
            self._index[slot] += c
            if req.done:
                self.scheduler.evict(slot, self.stats.steps)
                finished += 1
        return finished

    def run(self) -> List[Request]:
        """Step until queue and slots drain. Returns the requests that
        finished during this drain, in submission order."""
        already_done = len(self.scheduler.finished)
        t0 = time.perf_counter()
        while self.scheduler.has_work:
            self.step()
        self.stats.wall_s += time.perf_counter() - t0
        return sorted(self.scheduler.finished[already_done:],
                      key=lambda r: r.rid)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Submit every prompt, drain, return the outputs in order."""
        reqs = [self.submit(p, max_new_tokens, eos_id) for p in prompts]
        self.run()
        return [r.output for r in reqs]

    def mean_ttft_steps(self) -> float:
        """Mean engine steps from admission to first sampled token."""
        ttfts = [r.ttft_steps for r in self.scheduler.finished
                 if r.ttft_steps >= 0]
        return float(np.mean(ttfts)) if ttfts else 0.0
