"""Atomic, self-verifying checkpoints on disk (port of
repro.checkpoint.checkpoint), and ``CheckpointManager``, which writes
train states in the background and resumes from the newest.

The on-disk format is the reference's, so either package restores what the
other saved:

  * ``<dir>/step_<10 digits>/arrays.npz`` holds one array per leaf, keyed by
    the leaf's path with "|" between components;
  * ``<dir>/step_<10 digits>/manifest.json`` holds ``step``, ``extra`` and
    ``leaves``: per "/"-joined path, the shape, the dtype name and the
    CRC-32 of the leaf's bytes.

bf16 leaves are stored as 2-byte void records (numpy has no bf16 type) and
the manifest names their real dtype; the restore takes them back by a bit
view, never through a float round trip, so it needs numpy and torch only.

A state here is a flat mapping of leaf path -> tensor or numpy array, in
the order the leaves are to be written (``repro_torch.convert.flat_leaves``
gives the reference's paths and order for a parameter tree).

  * atomic: the step is written to ``step_N.tmp`` and renamed; a crash
    mid-write never damages the newest complete step;
  * bounded: ``keep`` newest steps stay, older ones are deleted;
  * verified: a restore checks each leaf's CRC-32 against the manifest
    (manifests written before CRCs existed restore unverified) and raises
    :class:`CheckpointCorruptError` naming the leaf.

``CheckpointManager`` keeps one write in flight: it copies the train
state to the host on the caller's thread (a consistent snapshot while
training goes on) and writes it with ``save_state`` on a worker thread, in
the reference's leaf paths (``repro_torch.convert.train_state_leaves``),
so either package resumes what the other saved.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
import zlib
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["save_state", "restore_state", "read_manifest", "latest_step",
           "all_steps", "CheckpointCorruptError", "leaf_crc32",
           "CheckpointManager"]

_MANIFEST = "manifest.json"
_BF16_RECORD = np.dtype("V2")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's on-disk bytes are damaged (truncation, bit flip, bad
    media). ``leaf`` names the first array that failed to read or verify
    when that is known, else None (the npz container itself is
    unreadable)."""

    def __init__(self, message: str, leaf: Optional[str] = None,
                 ckpt_dir: Optional[str] = None):
        super().__init__(message)
        self.leaf = leaf
        self.ckpt_dir = ckpt_dir


def leaf_crc32(arr: np.ndarray) -> int:
    """CRC-32 of an array's raw bytes (a bf16 leaf hashes the bytes the npz
    stores)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _to_numpy(leaf):
    """Tensor or array -> (numpy array as the npz stores it, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save_state(ckpt_dir: str, step: int, leaves: Mapping,
               extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomic checkpoint write of ``leaves`` (path -> tensor or array).
    Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    arrays = {}
    for key, leaf in leaves.items():
        arr, dtype = _to_numpy(leaf)
        arrays[key.replace("/", "|")] = arr
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": dtype,
            "crc32": leaf_crc32(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomicity point

    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> list:
    """Steps with a complete checkpoint (a manifest), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """Manifest of a checkpoint (the newest when ``step`` is None), without
    touching the arrays."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with open(os.path.join(_step_dir(ckpt_dir, step), _MANIFEST)) as f:
        return json.load(f)


_REMEDY = ("the checkpoint bytes are damaged -- restore an older step "
           "(repro_torch.checkpoint.all_steps) or re-write it from source")


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """npz array -> CPU tensor with the same bytes."""
    if arr.dtype.kind == "V":
        if dtype != "bfloat16":
            raise ValueError(f"cannot restore a leaf of dtype {dtype!r}")
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_state(ckpt_dir: str, template: Mapping,
                  step: Optional[int] = None, verify: bool = True):
    """Restore the leaves named by ``template`` (path -> anything with a
    ``.shape``, e.g. a tensor on the "meta" device) from step ``step`` (the
    newest when None). ``verify`` checks each leaf's CRC-32 against the
    manifest. Returns ({path: CPU tensor}, manifest extra).

    Raises :class:`CheckpointCorruptError`, naming the leaf whenever the
    container is readable enough to know it, when the npz is truncated or
    unreadable, a leaf is missing or a leaf fails its CRC; ``ValueError``
    when a leaf's shape differs from the template's."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    manifest = read_manifest(ckpt_dir, step)
    npz_path = os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")
    try:
        npz = np.load(npz_path)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"{npz_path} is unreadable ({type(e).__name__}: {e}); "
            f"{_REMEDY}", ckpt_dir=ckpt_dir) from e
    out = {}
    with npz:
        for key, spec in template.items():
            try:
                arr = npz[key.replace("/", "|")]
            except KeyError:
                raise CheckpointCorruptError(
                    f"{npz_path} holds no array for leaf {key!r}; "
                    f"{_REMEDY}", leaf=key, ckpt_dir=ckpt_dir) from None
            except (OSError, ValueError, EOFError, zipfile.BadZipFile,
                    zlib.error) as e:
                raise CheckpointCorruptError(
                    f"leaf {key!r} of {npz_path} failed to read "
                    f"({type(e).__name__}: {e}); {_REMEDY}",
                    leaf=key, ckpt_dir=ckpt_dir) from e
            entry = manifest["leaves"].get(key, {})
            want_crc = entry.get("crc32")
            if verify and want_crc is not None:
                got_crc = leaf_crc32(arr)
                if got_crc != want_crc:
                    raise CheckpointCorruptError(
                        f"leaf {key!r} of {npz_path} failed CRC-32 "
                        f"verification (manifest 0x{want_crc:08x}, on disk "
                        f"0x{got_crc:08x}); {_REMEDY}",
                        leaf=key, ckpt_dir=ckpt_dir)
            expect = tuple(spec.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs {expect}")
            out[key] = _to_tensor(arr, entry.get("dtype", str(arr.dtype)))
    return out, manifest["extra"]


class CheckpointManager:
    """Background checkpointing of train states, and resume from the newest
    complete step. ``maybe_save`` writes every ``every`` steps (or when
    forced), keeping the ``keep`` newest."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, state: dict,
                   extra: Optional[dict] = None, force: bool = False) -> bool:
        """Snapshot ``state`` (the port's train state) to the host now and
        write it as step ``step`` on a worker thread, after the previous
        write has finished. Returns whether a write started."""
        from repro_torch.convert import train_state_leaves
        if not force and step % self.every != 0:
            return False
        self.wait()                             # one in flight at a time
        snapshot = train_state_leaves(state, "cpu")     # fresh host copies

        def work():
            try:
                save_state(self.dir, step, snapshot, extra, self.keep)
            except BaseException as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk; re-raise
        its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def resume(self, template: dict, cfg, device="cuda"):
        """(state, extra, step) from the newest complete checkpoint, shaped
        like the train state ``template`` (its values are not read), on
        ``device``; (None, None, None) when there is none."""
        from repro_torch.convert import (from_train_state_leaves,
                                         train_state_leaves)
        step = latest_step(self.dir)
        if step is None:
            return None, None, None
        flat, extra = restore_state(
            self.dir, train_state_leaves(template, "meta"), step)
        return from_train_state_leaves(flat, template, cfg, device), \
            extra, step
