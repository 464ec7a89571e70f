"""The port's packed checkpoints against the reference's files.

One child per module (the reference, as in test_torch_serve.py) saves a
dense checkpoint, packed m2xfp and mxfp4 checkpoints of the same weights and
its own ``prequantize_checkpoint`` of the dense one, and records its
engine's greedy tokens with an m2xfp KV cache. Then:

(a) ``load_packed_checkpoint`` gives the bytes of ``from_jax_tree`` on the
    reference's in-memory tree, and the port's engine serves the restored
    tree with the reference engine's tokens (the North star's closing
    condition, from a file);
(b) a flipped byte raises ``CheckpointCorruptError`` naming the leaf, a
    truncated file raises it too, a codec mismatch or a dense checkpoint
    raises ``ValueError``; v1 and v2 manifests restore unverified;
(c) the port's ``save_packed_checkpoint`` and ``prequantize_checkpoint``
    write the reference's manifest leaves (paths, shapes, dtype names,
    CRC-32s) and equal arrays, so the reference restores them.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_serve import (ENGINE, N_NEW, PROMPTS, _assert_same_tree,
                              _flatten, run_reference_child)

BASE = dict(name="ckpt-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, head_dim=64, d_ff=128, vocab_size=97,
            remat=False, quant="serve")
FORMATS = ("m2xfp", "mxfp4")
LEAF = "layers/attn/wq/.codes"


def _reference_main(out_path: str) -> None:
    """Child process: the checkpoints (beside ``out_path``), the packed
    trees and the engine's tokens with an m2xfp KV cache."""
    import pickle

    import jax
    from repro.checkpoint import save_state
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import ServeEngine, prequantize_params
    from repro.serve.prequant import (prequantize_checkpoint,
                                      save_packed_checkpoint)

    root = os.path.dirname(out_path)
    params = init_params(jax.random.PRNGKey(0), ModelConfig(**BASE))
    save_state(os.path.join(root, "dense"), 0, params)
    out = {"root": root, "packed": {}}
    for fmt in FORMATS:
        cfg = ModelConfig(**BASE, quant_format=fmt)
        packed = prequantize_params(params, cfg)
        out["packed"][fmt] = _flatten(packed)
        save_packed_checkpoint(os.path.join(root, fmt), packed, cfg)
        if fmt == "m2xfp":
            kv_cfg = ModelConfig(**BASE, quant_format=fmt, kv_quant=fmt)
            out["tokens"] = ServeEngine(packed, kv_cfg, guard=False, **ENGINE
                                        ).generate(PROMPTS, N_NEW)
            prequantize_checkpoint(os.path.join(root, "dense"),
                                   os.path.join(root, "prequant"), cfg)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


def _cfg(fmt="m2xfp", **kw):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**BASE, quant_format=fmt, **kw)


def _ckpt(reference, name, tmp_path):
    """A private copy of the reference's checkpoint ``name``."""
    dst = tmp_path / name
    shutil.copytree(os.path.join(reference["root"], name), dst)
    return str(dst)


def _step_files(ckpt_dir):
    d = os.path.join(ckpt_dir, "step_0000000000")
    return os.path.join(d, "manifest.json"), os.path.join(d, "arrays.npz")


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flip_byte(ckpt_dir, leaf):
    """Flip one bit of ``leaf`` and re-write the npz, so the container
    stays well formed and only the manifest's CRC-32 can tell."""
    _, npz = _step_files(ckpt_dir)
    arrays = _npz(npz)
    key = leaf.replace("/", "|")
    raw = bytearray(arrays[key].tobytes())
    raw[len(raw) // 2] ^= 0x10
    arrays[key] = np.frombuffer(bytes(raw), arrays[key].dtype).reshape(
        arrays[key].shape)
    np.savez(npz, **arrays)


# ---------------------------------------------------------------------------
# (a) restore and serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_load_packed_checkpoint_equals_in_memory_tree(reference, fmt,
                                                      tmp_path):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import load_packed_checkpoint
    got, extra = load_packed_checkpoint(_ckpt(reference, fmt, tmp_path),
                                        _cfg(fmt), device="cpu")
    assert extra == {"format": "mx-packed", "format_version": 3,
                     "codec": fmt, "model": "ckpt-test"}
    assert got["embed"].dtype == torch.bfloat16
    _assert_same_tree(got, from_jax_tree(reference["packed"][fmt], _cfg(fmt),
                                         "cpu"))


def test_engine_serves_restored_checkpoint_with_reference_tokens(
        reference, tmp_path):
    """m2xfp weights from the reference's file, an m2xfp KV cache: the
    port's engine emits the reference engine's greedy tokens."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import load_packed_checkpoint
    cfg = _cfg(kv_quant="m2xfp")
    params, _ = load_packed_checkpoint(_ckpt(reference, "m2xfp", tmp_path),
                                       cfg, device="cpu")
    eng = ServeEngine(params, cfg, device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == reference["tokens"]


# ---------------------------------------------------------------------------
# (b) damage, mismatches and old manifests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", [LEAF, "embed", "layers/ffn_norm"])
def test_flipped_byte_raises_naming_the_leaf(reference, tmp_path, leaf):
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.serve.prequant import load_packed_checkpoint
    ckpt = _ckpt(reference, "m2xfp", tmp_path)
    _flip_byte(ckpt, leaf)
    with pytest.raises(CheckpointCorruptError, match="CRC-32") as ei:
        load_packed_checkpoint(ckpt, _cfg(), device="cpu")
    assert ei.value.leaf == leaf and ei.value.ckpt_dir == ckpt
    params, _ = load_packed_checkpoint(ckpt, _cfg(), verify=False,
                                       device="cpu")
    assert params["embed"].shape == (97, 64)


def test_truncated_npz_raises(reference, tmp_path):
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.serve.prequant import load_packed_checkpoint
    ckpt = _ckpt(reference, "m2xfp", tmp_path)
    with open(_step_files(ckpt)[1], "r+b") as f:
        f.truncate(256)
    with pytest.raises(CheckpointCorruptError, match="unreadable") as ei:
        load_packed_checkpoint(ckpt, _cfg(), device="cpu")
    assert ei.value.leaf is None


@pytest.mark.parametrize("name,fmt,match", [
    ("m2xfp", "mxfp4", "packed with codec 'm2xfp'"),
    ("dense", "m2xfp", "not a packed checkpoint")])
def test_codec_mismatch_and_dense_checkpoint_raise(reference, name, fmt,
                                                   match):
    from repro_torch.serve.prequant import load_packed_checkpoint
    with pytest.raises(ValueError, match=match):
        load_packed_checkpoint(os.path.join(reference["root"], name),
                               _cfg(fmt), device="cpu")


@pytest.mark.parametrize("version", [1, 2])
def test_old_manifests_restore_unverified(reference, tmp_path, version):
    """A v2 manifest (codec, no CRCs) and a v1 one (legacy tag, no codec,
    no CRCs) restore the same bytes, and a flipped byte goes unnoticed."""
    from repro_torch.convert import flat_leaves, from_jax_tree, stack_layers
    from repro_torch.serve.prequant import load_packed_checkpoint
    ckpt = _ckpt(reference, "m2xfp", tmp_path)
    path = _step_files(ckpt)[0]
    with open(path) as f:
        manifest = json.load(f)
    for entry in manifest["leaves"].values():
        del entry["crc32"]
    manifest["extra"] = ({"format": "mx-packed", "format_version": 2,
                          "codec": "m2xfp"} if version == 2
                         else {"format": "m2xfp-packed-v1"})
    with open(path, "w") as f:
        json.dump(manifest, f)
    got, _ = load_packed_checkpoint(ckpt, _cfg(), device="cpu")
    _assert_same_tree(got, from_jax_tree(reference["packed"]["m2xfp"],
                                         _cfg(), "cpu"))
    _flip_byte(ckpt, LEAF)
    got, _ = load_packed_checkpoint(ckpt, _cfg(), device="cpu")
    want = reference["packed"]["m2xfp"]["layers"]["attn"]["wq"]["streams"]
    assert int((flat_leaves(stack_layers(got))[LEAF].numpy()
                != want["codes"]).sum()) == 1


def test_validate_streams_not_ported(reference):
    """``validate_streams=True`` on an intact checkpoint restores what the
    load without it restores (a damaged one: test_torch_faults.py)."""
    from repro_torch.serve.prequant import load_packed_checkpoint
    path = os.path.join(reference["root"], "m2xfp")
    got, _ = load_packed_checkpoint(path, _cfg(), validate_streams=True,
                                    device="cpu")
    _assert_same_tree(got, load_packed_checkpoint(path, _cfg(),
                                                  device="cpu")[0])


# ---------------------------------------------------------------------------
# (c) the port writes the reference's files
# ---------------------------------------------------------------------------

def _assert_same_checkpoint(got_dir, want_dir, same_extra=True):
    (gm, gz), (wm, wz) = _step_files(got_dir), _step_files(want_dir)
    with open(gm) as f, open(wm) as g:
        got, want = json.load(f), json.load(g)
    assert list(got["leaves"].items()) == list(want["leaves"].items())
    assert got["step"] == want["step"]
    if same_extra:
        assert got["extra"] == want["extra"]
    got, want = _npz(gz), _npz(wz)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_save_writes_reference_checkpoint(reference, tmp_path, fmt):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import save_packed_checkpoint
    packed = from_jax_tree(reference["packed"][fmt], _cfg(fmt), "cpu")
    got = save_packed_checkpoint(str(tmp_path / fmt), packed, _cfg(fmt))
    assert got == str(tmp_path / fmt / "step_0000000000")
    _assert_same_checkpoint(str(tmp_path / fmt),
                            os.path.join(reference["root"], fmt))


def test_port_prequantize_checkpoint_writes_reference_checkpoint(
        reference, tmp_path):
    """The port packs the reference's dense checkpoint into the reference's
    packed one (its manifest's ``extra`` names its own source)."""
    from repro_torch.serve.prequant import prequantize_checkpoint
    dst = str(tmp_path / "prequant")
    prequantize_checkpoint(os.path.join(reference["root"], "dense"), dst,
                           _cfg(), device="cpu")
    _assert_same_checkpoint(dst, os.path.join(reference["root"], "prequant"),
                            same_extra=False)


def test_save_state_retention_and_steps(tmp_path):
    """Atomic writes keep the ``keep`` newest steps; a leftover ``.tmp``
    directory is not a step; leaves restore by path."""
    from repro_torch.checkpoint import (all_steps, latest_step,
                                        restore_state, save_state)
    d = str(tmp_path)
    leaves = {"a/b": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              "c": np.arange(4, dtype=np.int32)}
    for step in range(3):
        save_state(d, step, leaves, extra={"step": step}, keep=2)
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert all_steps(d) == [1, 2] and latest_step(d) == 2
    got, extra = restore_state(d, {k: v for k, v in leaves.items()})
    assert extra == {"step": 2}
    assert torch.equal(got["a/b"], leaves["a/b"])
    assert torch.equal(got["c"], torch.arange(4, dtype=torch.int32))


if __name__ == "__main__":
    _reference_main(sys.argv[1])
