"""Deterministic, host-sharded data pipeline (a copy of
repro.data.pipeline, numpy only: the same Philox keys and counters, so the
same batches, int32 tokens and labels).

Design requirements at 1000+ node scale:
  * determinism keyed by (seed, step, host) — any host can regenerate any
    batch, so restart/elastic-reshard replays the exact token stream with no
    data service round-trip;
  * no host reads more than its shard (batch dim split over hosts);
  * background prefetch thread overlaps host data generation with device
    compute.

Two sources:
  * SyntheticLM — a *learnable* synthetic stream: each sequence repeats a
    per-sequence random motif with noise, so next-token loss has real signal
    (used by examples/ and the accuracy-proxy benchmark).
  * ByteCorpus — byte-level tokenization of a real text file with seeded
    window sampling.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "ByteCorpus", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int                    # GLOBAL batch
    seq: int
    vocab: int
    seed: int = 0
    motif_len: int = 16           # SyntheticLM pattern length
    noise: float = 0.02
    host_id: int = 0
    num_hosts: int = 1


class SyntheticLM:
    """Deterministic learnable stream: seq = repeated random motif + noise."""

    def __init__(self, cfg: DataConfig):
        assert cfg.batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.batch // cfg.num_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        out = np.empty((self.local_batch, cfg.seq + 1), np.int32)
        for i in range(self.local_batch):
            # key: (seed, step, global row index) -> independent Philox
            row = cfg.host_id * self.local_batch + i
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed, counter=[0, 0, step, row]))
            m = cfg.motif_len
            motif = rng.integers(0, cfg.vocab, m)
            reps = (cfg.seq + 1 + m - 1) // m
            seq = np.tile(motif, reps)[: cfg.seq + 1]
            flip = rng.random(cfg.seq + 1) < cfg.noise
            seq = np.where(flip, rng.integers(0, cfg.vocab, cfg.seq + 1), seq)
            out[i] = seq
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level LM windows over a text file, seeded window sampling."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        assert len(data) > cfg.seq + 1, "corpus too small"
        self.data = data.astype(np.int32) % cfg.vocab
        self.local_batch = cfg.batch // cfg.num_hosts

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed + 1, counter=[0, 0, step, cfg.host_id]))
        starts = rng.integers(0, len(self.data) - cfg.seq - 1,
                              self.local_batch)
        rows = np.stack([self.data[s:s + cfg.seq + 1] for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any batch source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)
