"""The port's recurrent (ssm: xLSTM) and hybrid (Zamba2) families against
the reference.

One child (the reference, run as in test_torch_serve.py with XLA's excess
precision off) computes, for xlstm-smoke and zamba2-smoke (7 blocks: one
segment of 5 Mamba layers, the shared attention block, one trailing Mamba
layer):

(a) the dense tree and the packed trees (m2xfp, mxfp4), a packed m2xfp
    checkpoint; the port's ``from_jax_tree`` of the packed tree equals its
    own ``prequantize_params`` of the converted dense tree byte for byte,
    its "meta" template has the reference's checkpoint leaves, and the
    weight sweep (``weight_tree_health``) names and measures the packed
    leaves as the reference's does;
(b) per-position ``decode_step`` logits over SEQ_T tokens in 2 slots and
    every cache leaf after them;
(c) ``forward``'s logits and ``loss_fn`` under none and qat (m2xfp), and
    ``loss_fn``'s gradients (``jax.grad``);
(d) the engine's greedy tokens, 3 requests through 2 slots (a slot is
    reused, so its recurrent state is reset), m2xfp and mxfp4, each step's
    top-2 logit margin;
(e) what the reference refuses: ``prefill_chunk`` (NotImplementedError)
    with its message, the engine's chunk of 1, zamba2-smoke with an m2xfp
    KV cache (head_dim 16 is no multiple of the 32-element group:
    ValueError at the first ``decode_step``, which writes a K row),
    ``poison_kv_nan`` on xlstm (no page);
(f) ``probe_kv`` over caches with a NaN planted in a recurrent leaf, and
    ``_reset_slot``'s scrub of that slot;
(g) the blocks at tests/test_recurrent.py's sizes: ``mamba2_forward``,
    ``mlstm_forward``, ``slstm_forward`` and the chunkwise mLSTM cell on
    that file's inputs;
(h) the compute cast and one train step (ROADMAP C2) from f32 masters
    whose vectors lie off the bf16 grid (test_torch_train.py's
    ``offgrid_vectors`` and ``reference_train_step``).

The port also holds its own copies of tests/test_recurrent.py's four
properties (chunkwise == sequential, forward == decode), and restores the
reference's checkpoints and writes them. The port side runs on one torch
thread (test_torch_moe.py says why).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.testing.recurrent import BLOCKS
from repro_torch.testing.train import grad_agreement
from test_torch_checkpoint import _assert_same_checkpoint
from test_torch_serve import _assert_same_tree, _flatten, run_reference_child
from test_torch_train import (assert_cast_matches_reference,
                              assert_step_matches_reference,
                              offgrid_vectors, reference_loss,
                              reference_train_step)
from test_torch_variants import _margin_recorder

CASES = {"xlstm-smoke": "xlstm-125m", "zamba2-smoke": "zamba2-7b"}
FORMATS = ("m2xfp", "mxfp4")
SLOTS, PAGE = 2, 32
SEQ_T = 12
PROMPTS = [[94, 14, 95, 36, 16], [89, 10, 25, 13, 30, 51, 11, 77, 23],
           [76, 30, 76]]
N_NEW = 6
# (c): B x S tokens, every seventh label ignored
B, S = 2, 32
# (g): tests/test_recurrent.py's sizes and inputs
REC = dict(name="t", family="ssm", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=0, vocab_size=128, ssm_state=16,
           ssm_head_dim=16)
BLOCK_INPUTS = {"mamba": (0, 256), "mlstm": (2, 64), "slstm": (3, 48)}
BLOCK_HEADS = {"mamba": 4, "mlstm": 2, "slstm": 4}
CELL = (2, 256, 3, 16)                      # B, S, H, P
# (f): the leaf that gets a NaN, in layer 0 of slot POISON_SLOT
POISON = {"xlstm-smoke": ("mlstm", "C"), "zamba2-smoke": ("mamba", "ssm")}
POISON_SLOT = 1


def make_config(configs, case: str, **kw):
    return configs.smoke_config(CASES[case], **kw)


def seq_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              (SLOTS, SEQ_T))


def case_batch(cfg) -> dict:
    rng = np.random.default_rng(S)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, ::7] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), "labels": labels}


def block_input(block: str) -> np.ndarray:
    seed, s = BLOCK_INPUTS[block]
    return np.random.default_rng(seed).standard_normal(
        (2, s, 64)).astype(np.float32)


def cell_inputs():
    """tests/test_recurrent.py's chunkwise-cell inputs (rng seed 1)."""
    b, s, h, p = CELL
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, p)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, p)).astype(np.float32)
         * np.float32(p ** -0.5))
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    logi = rng.standard_normal((b, s, h)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(
        -rng.standard_normal((b, s, h)) - 2))).astype(np.float32)
    return q, k, v, logi, logf


# ---------------------------------------------------------------------------
# The reference, run in a child process (test_torch_serve.py's docstring)
# ---------------------------------------------------------------------------

def _raises(fn):
    try:
        fn()
    except Exception as e:             # noqa: BLE001 -- recorded
        return (type(e).__name__, str(e))
    return None


def _reference_case(configs, case: str, root: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models.model import (decode_step, forward, init_caches,
                                    init_params, prefill_chunk)
    from repro.obs.quant_health import weight_tree_health
    from repro.serve import ServeEngine, prequantize_params
    from repro.serve.engine import _reset_slot
    from repro.serve.guard import SentinelMailbox, probe_kv
    from repro.serve.prequant import save_packed_checkpoint
    from repro.testing.faults import poison_kv_nan

    base = make_config(configs, case, remat=False)
    params = init_params(jax.random.PRNGKey(0), base)
    out = {"dense": _flatten(params), "packed": {}, "tokens": {},
           "margins": {}}
    for fmt in FORMATS:
        cfg = dataclasses.replace(base, quant="serve", quant_format=fmt)
        packed = prequantize_params(params, cfg)
        out["packed"][fmt] = _flatten(packed)
        if fmt == "m2xfp":
            save_packed_checkpoint(os.path.join(root, case), packed, cfg)
            out["health"] = weight_tree_health(packed, drift=False)
        eng = ServeEngine(packed, cfg, guard=False, n_slots=SLOTS,
                          max_len=PAGE, prefill_chunk=4)
        margins = out["margins"][fmt] = {}
        eng.sample_fn = _margin_recorder(eng, margins)
        out["tokens"][fmt] = eng.generate(PROMPTS, N_NEW)
        out["chunk"] = eng.chunk
        if fmt != "m2xfp":
            continue
        # (b) per-position logits and the caches, through the engine's
        # jitted decode launch
        seq = seq_tokens(cfg)
        caches = init_caches(cfg, SLOTS, PAGE, per_slot=True)
        logits = []
        for t in range(SEQ_T):
            lg, caches = eng._step(
                packed, {"tokens": jnp.asarray(seq[:, t:t + 1], jnp.int32)},
                caches, jnp.full((SLOTS,), t, jnp.int32))
            logits.append(np.asarray(lg[:, 0]))
        out["decode_logits"] = np.stack(logits, axis=1)
        out["decode_caches"] = _flatten(caches)
        # (f) probe_kv with a NaN in a recurrent leaf, then the scrub
        group, leaf = POISON[case]
        t = caches[group][leaf]
        at = (0, POISON_SLOT) + (0,) * (t.ndim - 2)
        caches = dict(caches, **{group: dict(caches[group], **{
            leaf: t.at[at].set(jnp.nan)})})
        mailbox = SentinelMailbox()
        jax.jit(lambda c: probe_kv(mailbox, c, SLOTS))(caches)
        jax.effects_barrier()
        out["probe_kv"] = np.asarray(mailbox.drain()["kv"])
        scrubbed = _reset_slot(caches, jnp.int32(POISON_SLOT), scrub=True)
        out["scrubbed"] = _flatten(scrubbed)
        out["reset"] = _flatten(_reset_slot(scrubbed, jnp.int32(0)))
        out["poison_nan"] = _raises(lambda: poison_kv_nan(caches, 0)[1])
        if out["poison_nan"] is None:
            out["poison_nan_path"] = poison_kv_nan(caches, 0)[1]
        out["prefill_error"] = _raises(lambda: prefill_chunk(
            packed, cfg, {"tokens": jnp.zeros((SLOTS, 4), jnp.int32)},
            init_caches(cfg, SLOTS, PAGE, per_slot=True),
            jnp.zeros((SLOTS,), jnp.int32), jnp.ones((SLOTS,), jnp.int32)))
        # an m2xfp KV cache: built, then its first write encodes K rows
        # of head_dim elements in groups of 32
        kv_cfg = dataclasses.replace(cfg, kv_quant="m2xfp")
        kv_caches = init_caches(kv_cfg, SLOTS, PAGE, per_slot=True)
        out["kv_quant_error"] = _raises(lambda: jax.jit(
            lambda p, b, c, i: decode_step(p, kv_cfg, b, c, i))(
            packed, {"tokens": jnp.zeros((SLOTS, 1), jnp.int32)}, kv_caches,
            jnp.zeros((SLOTS,), jnp.int32)))
    # (c) forward, loss and gradients under none and qat
    batch = {k: jnp.asarray(v) for k, v in case_batch(base).items()}
    out["modes"] = {}
    for quant in ("none", "qat"):
        cfg = dataclasses.replace(base, quant=quant)

        def f(p):                 # loss_fn, keeping forward's logits
            logits = forward(p, cfg, batch)
            return reference_loss(logits, batch["labels"]), logits
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(params)
        out["modes"][quant] = {"logits": np.asarray(logits),
                               "loss": float(loss),
                               "grads": _flatten(grads)}
    # (h) the C2 check from f32 masters with off-grid vectors
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), out["dense"])
    c2_params = offgrid_vectors(f32)
    out["c2"] = {"params": c2_params, **reference_train_step(
        base, c2_params, batch)}
    return out


def _reference_blocks() -> dict:
    """(g): the blocks at tests/test_recurrent.py's sizes, jitted as there,
    with PRNGKey(0) parameters; the chunkwise cell on its inputs."""
    import jax
    import jax.numpy as jnp
    from repro.models import mamba2 as mb
    from repro.models import xlstm as xl
    from repro.models.config import ModelConfig
    key = jax.random.PRNGKey(0)
    out = {}
    for block, (init, fwd) in {
            "mamba": (mb.init_mamba2, mb.mamba2_forward),
            "mlstm": (xl.init_mlstm, xl.mlstm_forward),
            "slstm": (xl.init_slstm, xl.slstm_forward)}.items():
        cfg = ModelConfig(**dict(REC, n_heads=BLOCK_HEADS[block]))
        p = init(key, cfg)
        x = jnp.asarray(block_input(block)).astype(jnp.bfloat16)
        y, state = jax.jit(lambda p, x: fwd(p, x, cfg))(p, x)
        out[block] = {"params": _flatten(p), "y": np.asarray(y),
                      "state": _flatten(state)}
    h, st = jax.jit(xl._mlstm_cell_chunkwise)(
        *[jnp.asarray(a) for a in cell_inputs()])
    out["cell"] = {"h": np.asarray(h), "state": _flatten(st)}
    return out


def _reference_main(out_path: str) -> None:
    import pickle

    from repro import configs

    root = os.path.dirname(out_path)
    out = {"root": root, "blocks": _reference_blocks()}
    for case in CASES:
        out[case] = _reference_case(configs, case, root)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops: one intra-op thread (test_torch_moe.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Tolerances (each measured on these inputs; the margin is stated)
# ---------------------------------------------------------------------------

# (b) logits of |l| < 1 agree to 2e-5 absolute (test_torch_serve.py's
# LOGIT_TOL): measured within 1.0e-7 at every position of both models
LOGIT_TOL = 2e-5
# (b), (f), (g) f32 recurrent states (mLSTM C, n, m; sLSTM c, n, h, m; the
# Mamba2 SSM state): the same f32 formulas, evaluated in another order
# (torch's einsums and cumsum against XLA's), so within a few ulps of the
# leaf's largest magnitude: measured at most 1.8e-7 of it (2^-22). Held to
# STATE_TOL of the leaf's largest magnitude. The conv windows hold the
# bf16 projections as f32 and must be equal, as must bf16 pages and
# position tracks.
STATE_TOL = 2.0 ** -16
# (g) block outputs are bf16: an f32 value within an ulp of a rounding
# edge rounds the other way, so an element may be one bf16 ulp off (at
# most 2^-7 of its magnitude); elements near zero are held to 2^-10 of the
# largest output. Measured: 66 of 32,768 Mamba2 outputs, 3 of 8,192
# mLSTM and 17 of 6,144 sLSTM outputs one ulp apart, the rest equal
BLOCK_REL, BLOCK_ABS = 2.0 ** -7, 2.0 ** -10
# (g) the chunkwise cell's h (f32): measured within 4.2e-5 of outputs of
# |h| up to 1.3e3 (its denominators can be small); held within CELL_TOL of
# the largest |h|
CELL_TOL = 2.0 ** -16


def port_cfg(case: str, **kw):
    from repro_torch import configs
    return make_config(configs, case, **kw)


def _serve_cfg(case, fmt="m2xfp", **kw):
    return port_cfg(case, quant="serve", quant_format=fmt, **kw)


def _port_packed(reference, case, fmt="m2xfp"):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference[case]["packed"][fmt],
                         _serve_cfg(case, fmt), "cpu")


def _port_dense(reference, case):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference[case]["dense"], port_cfg(case), "cpu")


def _np(t) -> np.ndarray:
    """A tensor as numpy (bf16 as f32, exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.numpy()
    return np.asarray(t, dtype=np.float32) if t.dtype.name == "bfloat16" \
        else np.asarray(t)


def assert_state_close(got, want, label: str) -> None:
    """An f32 recurrent-state leaf within STATE_TOL of the leaf's largest
    magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, label
    bound = STATE_TOL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (label, err, bound)


def assert_caches_match(port: dict, ref: dict) -> None:
    """Every cache leaf of the port's caches (lists of per-layer dicts)
    against the reference's (layer-stacked): recurrent f32 states within
    STATE_TOL, everything else (conv windows, bf16 pages, position
    tracks) equal."""
    assert sorted(port) == sorted(ref)
    for group, blocks in port.items():
        for i, block in enumerate(blocks):
            assert sorted(block) == sorted(ref[group]), group
            for name, t in block.items():
                want = ref[group][name][i]
                label = f"{group}[{i}]/{name}"
                if group in ("mlstm", "slstm") or name == "ssm":
                    assert_state_close(t, want, label)
                else:
                    assert t.shape == want.shape, label
                    np.testing.assert_array_equal(_np(t), _np(want),
                                                  err_msg=label)


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_configs_are_the_references(arch):
    from repro import configs as ref_configs
    from repro_torch import configs
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(ref_configs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want
    assert arch in configs.ARCHS


def test_port_serves_every_reference_config():
    """``repro_torch.configs`` holds all of the reference's configs, and
    ``check_supported`` accepts each, recurrent families included."""
    from repro import configs as ref_configs
    from repro_torch import configs
    from repro_torch.models.model import check_supported
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    assert len(configs.ARCHS) == 11
    for arch in configs.ARCHS:
        for cfg in (configs.get_config(arch, quant="serve"),
                    configs.smoke_config(arch, quant="serve")):
            check_supported(cfg)


def test_hybrid_segments_match_reference():
    """zamba2-7b: 13 applications of the shared block after 5 Mamba layers
    each, then 3 trailing Mamba layers (68 in all); the smoke config 1
    application and 1 trailing layer; a 14-block cut 2 and 2."""
    from repro import configs as ref_configs
    from repro.models.model import _hybrid_segments
    from repro_torch import configs
    from repro_torch.models.model import hybrid_segments
    for cfg, want in ((configs.get_config("zamba2-7b"), (13, 5, 3)),
                      (configs.smoke_config("zamba2-7b"), (1, 5, 1)),
                      (configs.get_config("zamba2-7b", n_layers=14),
                       (2, 5, 2))):
        assert hybrid_segments(cfg) == want
        ref_cfg = ref_configs.get_config("zamba2-7b",
                                         n_layers=cfg.n_layers)
        assert _hybrid_segments(ref_cfg) == want


# ---------------------------------------------------------------------------
# (a) weights, templates and the weight sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_from_jax_tree_packed_equals_port_prequant(reference, case, fmt):
    """The reference's packed tree carried across equals the port's own
    packing of the carried dense tree, byte for byte: every GEMM weight
    packed, the mLSTM's per-head wq/wk/wv bf16, w_if f32, the recurrence
    parameters as they are, the shared block once."""
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.serve.prequant import prequantize_params
    cfg = _serve_cfg(case, fmt)
    packed = _port_packed(reference, case, fmt)
    _assert_same_tree(packed, prequantize_params(
        _port_dense(reference, case), cfg))
    if cfg.family == "ssm":
        m = packed["mlstm"][0]
        assert all(isinstance(m[k], PackedTensor)
                   for k in ("up", "w_o", "down"))
        assert m["wq"].dtype == torch.bfloat16 and m["wq"].dim() == 3
        assert m["w_if"].dtype == torch.float32
        sl = packed["slstm"][0]
        assert all(isinstance(sl[k], PackedTensor)
                   for k in ("w", "ff_up", "ff_down"))
        assert sl["r"].dtype == torch.float32
        assert len(packed["mlstm"]) == cfg.n_layers // 2
    else:
        mb = packed["mamba"][0]
        assert isinstance(mb["in_proj"], PackedTensor)
        assert isinstance(mb["out_proj"], PackedTensor)
        assert isinstance(packed["shared_attn"], dict)
        assert isinstance(packed["shared_attn"]["attn"]["wq"], PackedTensor)
        assert len(packed["mamba"]) == len(packed["mamba_norm"]) == 6


@pytest.mark.parametrize("case", CASES)
def test_dense_tree_carried_across(reference, case):
    """``from_jax_tree`` of the dense tree gives per-block lists (the
    stacked groups) and one ``shared_attn`` dict; ``stack_layers`` gives the
    reference's tree back, every leaf's bytes equal."""
    from repro_torch.convert import STACKED, flat_leaves, stack_layers
    dense = _port_dense(reference, case)
    want = reference[case]["dense"]
    for k, v in want.items():
        assert isinstance(dense[k], list) == (k in STACKED), k
    got = flat_leaves(stack_layers(dense))
    ref = flat_leaves(want)
    assert list(got) == list(ref)
    for k, t in got.items():
        assert t.shape == ref[k].shape, k
        np.testing.assert_array_equal(
            t.contiguous().view(torch.uint8).numpy(),
            np.ascontiguousarray(ref[k]).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_init_packed_params_equals_prequantized_init(case):
    """Packing block by block at init gives the bytes of init-then-pack."""
    from repro_torch.models.model import init_params
    from repro_torch.serve.prequant import init_packed_params, \
        prequantize_params
    cfg = _serve_cfg(case)
    want = prequantize_params(
        init_params(torch.Generator().manual_seed(3), cfg, "cpu"), cfg)
    got = init_packed_params(torch.Generator().manual_seed(3), cfg, "cpu")
    _assert_same_tree(got, want)


@pytest.mark.parametrize("case", CASES)
def test_packed_template_has_reference_leaves(reference, case):
    """The "meta" template's checkpoint leaves (paths in order, shapes,
    dtypes) are those of the reference's manifest."""
    import json
    from repro_torch.convert import flat_leaves
    from repro_torch.serve.prequant import packed_template
    path = os.path.join(reference["root"], case, "step_0000000000",
                        "manifest.json")
    with open(path) as f:
        want = [(k, v["shape"], v["dtype"])
                for k, v in json.load(f)["leaves"].items()]
    got = [(k, list(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in flat_leaves(packed_template(_serve_cfg(case))).items()]
    assert got == want


@pytest.mark.parametrize("case", CASES)
def test_weight_health_names_leaves_as_reference(reference, case):
    """``weight_tree_health`` (and so ``packed_leaves``) names each packed
    weight as the reference does -- ``mamba/in_proj[i]`` for block i of a
    stacked group, ``shared_attn/attn/wq`` once -- and measures the same
    clip rates, saturation and meta histograms."""
    from repro_torch.obs.quant_health import weight_tree_health
    want = reference[case]["health"]
    got = weight_tree_health(_port_packed(reference, case), drift=False)
    assert list(got) == list(want)
    for name, st in want.items():
        assert got[name] == st, name
    if case == "zamba2-smoke":
        assert "shared_attn/attn/wq" in got and "mamba/in_proj[5]" in got


# ---------------------------------------------------------------------------
# (b) decode logits and caches
# ---------------------------------------------------------------------------

def _decode_seq(params, cfg):
    from repro_torch.models.model import decode_step, init_caches
    caches = init_caches(cfg, SLOTS, PAGE, "cpu")
    seq = torch.from_numpy(seq_tokens(cfg))
    out = [decode_step(params, cfg, {"tokens": seq[:, t:t + 1]}, caches,
                       torch.full((SLOTS,), t))[:, 0]
           for t in range(SEQ_T)]
    return torch.stack(out, 1).numpy(), caches


@pytest.mark.parametrize("case", CASES)
def test_decode_logits_and_caches_match_reference(reference, case):
    logits, caches = _decode_seq(_port_packed(reference, case),
                                 _serve_cfg(case))
    want = reference[case]["decode_logits"]
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits, want, rtol=0, atol=LOGIT_TOL)
    assert_caches_match(caches, reference[case]["decode_caches"])


# ---------------------------------------------------------------------------
# (c) forward, loss and gradients
# ---------------------------------------------------------------------------

def _with_grad(tree):
    """The tree with every floating leaf a leaf tensor requiring grad."""
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_grad(v) for v in tree]
    return tree.requires_grad_(True) if tree.is_floating_point() else tree


def _grads(tree):
    """Each leaf's gradient (zeros where the loss does not reach it, as
    JAX gives)."""
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def _loss_and_grads(reference, case, cfg):
    from repro_torch.convert import flat_leaves, stack_layers
    from repro_torch.models.model import forward, loss_fn
    params = _with_grad(_port_dense(reference, case))
    batch = {k: torch.from_numpy(v).long()
             for k, v in case_batch(cfg).items()}
    with torch.no_grad():
        logits = forward(params, cfg, batch).numpy()
    loss = loss_fn(params, cfg, batch)
    loss.backward()
    return logits, loss.detach(), flat_leaves(stack_layers(_grads(params)))


@pytest.mark.parametrize("quant", ["none", "qat"])
@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_grads_match_reference(reference, case, quant):
    """``forward``'s logits, ``loss_fn`` and its gradients (autograd
    against ``jax.grad``, the parameters in init's dtypes) within
    tests/test_torch_train.py's bounds: logits under qat within
    QAT_LOGIT_TOL but QAT_FLIP_ROWS rows within FLIP_TOL, under none
    within NONE_LOGIT_TOL (measured: qat within 1.2e-7 for both models;
    none within 9e-8 for xlstm-smoke and 4.7e-3 at 2 of zamba2-smoke's 64
    rows, a bf16 flip), the loss within LOSS_TOL (measured 7.6e-5), every
    gradient within GRAD_TOL / GRAD_L2 (worst ratios 0.34 / 0.27,
    zamba2-smoke under none). With remat the gradients are the same
    bits."""
    from test_torch_train import (FLIP_TOL, LOSS_TOL, NONE_LOGIT_TOL,
                                  QAT_FLIP_ROWS, QAT_LOGIT_TOL)
    want = reference[case]["modes"][quant]
    cfg = port_cfg(case, quant=quant, remat=False)
    logits, loss, grads = _loss_and_grads(reference, case, cfg)
    d = np.abs(logits - want["logits"]).max(axis=-1)
    if quant == "qat":
        assert (d <= FLIP_TOL).all(), d.max()
        assert (d > QAT_LOGIT_TOL).sum() <= QAT_FLIP_ROWS, np.sort(d)[-5:]
    else:
        assert (d <= NONE_LOGIT_TOL).all(), d.max()
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL
    from repro_torch.convert import flat_leaves
    ref = flat_leaves(want["grads"])
    assert list(grads) == list(ref)
    for k, g in grads.items():
        assert tuple(g.shape) == ref[k].shape, k
        assert str(g.dtype).removeprefix("torch.") == ref[k].dtype.name, k
        assert bool(torch.isfinite(g).all()), k
    worst = grad_agreement(
        {k: g.float() for k, g in grads.items()},
        {k: torch.from_numpy(_np(a)) for k, a in ref.items()})
    assert worst["elem_ratio"] <= 1 and worst["l2_ratio"] <= 1, worst
    _, loss_r, grads_r = _loss_and_grads(
        reference, case, dataclasses.replace(cfg, remat=True))
    assert torch.equal(loss, loss_r)
    for k, g in grads_r.items():
        assert torch.equal(g, grads[k]), k


@pytest.mark.parametrize("case", CASES)
def test_compute_cast_matches_reference(reference, case):
    """ROADMAP C2: the compute cast of f32 masters with off-grid vectors
    gives the reference's dtypes and bits leaf by leaf: the stacked groups'
    vectors (norms, b_if, A_log, D, dt_bias, conv_b) bf16, the final norm
    and zamba2's shared block's norms f32."""
    from repro_torch.convert import from_jax_tree
    want = reference[case]["c2"]
    assert_cast_matches_reference(
        from_jax_tree(want["params"], port_cfg(case), "cpu"), want["cast"])


@pytest.mark.parametrize("case", CASES)
def test_train_step_from_offgrid_vectors_matches_reference(reference,
                                                           case):
    """One train step of the recurrent families from that state against
    the reference's (test_torch_train.py's assert_step_matches_reference:
    loss, grad_norm and every gradient within its bounds)."""
    from repro_torch.convert import from_jax_tree
    want = reference[case]["c2"]
    cfg = port_cfg(case, remat=False)
    batch = {k: torch.from_numpy(v).long()
             for k, v in case_batch(cfg).items()}
    assert_step_matches_reference(
        cfg, from_jax_tree(want["params"], cfg, "cpu"), batch, want, case)


def test_forward_takes_the_references_sequence_lengths():
    """Up to one chunk of 128, or whole chunks; 130 raises ValueError for
    both families (the reference's reshape fails there)."""
    from repro_torch.models.model import forward, init_params
    for case in CASES:
        cfg = port_cfg(case, remat=False)
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        with torch.no_grad():
            for s in (1, 100, 256):
                tokens = torch.zeros((1, s), dtype=torch.long)
                assert forward(params, cfg, {"tokens": tokens}).shape == \
                    (1, s, cfg.vocab_size)
            with pytest.raises(ValueError, match="multiple of 128"):
                forward(params, cfg,
                        {"tokens": torch.zeros((1, 130), dtype=torch.long)})


# ---------------------------------------------------------------------------
# (d) engine tokens
# ---------------------------------------------------------------------------

def assert_tokens_match(got: list, want: list, margins: dict) -> int:
    """Equal tokens up to each request's first position whose reference
    top-2 margin is at most LOGIT_TOL (a near-tie either package may break
    either way). Returns the number of requests cut at a near-tie."""
    cut = 0
    for rid, (out, ref) in enumerate(zip(got, want)):
        assert len(out) == len(ref), rid
        for n, (a, b) in enumerate(zip(out, ref)):
            if margins[(rid, n)] <= LOGIT_TOL:
                cut += 1
                break
            assert a == b, (rid, n)
    return cut


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_engine_tokens_match_reference(reference, case, fmt):
    """3 requests through 2 slots (the third reuses a slot, whose recurrent
    state admission resets) give the reference engine's tokens; both
    engines run chunks of 1 whatever is asked. The smallest top-2 margin
    of the reference's steps is 4.8e-4 (zamba2-smoke, m2xfp), 24 times
    LOGIT_TOL: no near-tie."""
    from repro_torch.serve.engine import ServeEngine
    ref = reference[case]
    eng = ServeEngine(_port_packed(reference, case, fmt),
                      _serve_cfg(case, fmt), n_slots=SLOTS, max_len=PAGE,
                      prefill_chunk=4, device="cpu")
    assert eng.chunk == ref["chunk"] == 1
    got = eng.generate(PROMPTS, N_NEW)
    eng.scheduler.check()
    assert eng.stats.generated_tokens == N_NEW * len(PROMPTS)
    assert eng.stats.prefill_steps == 0 and eng.health == "healthy"
    assert assert_tokens_match(got, ref["tokens"][fmt],
                               ref["margins"][fmt]) == 0


def test_near_tie_rule_catches_a_flip_and_forgives_a_near_tie(reference):
    ref = reference["xlstm-smoke"]
    want, margins = ref["tokens"]["m2xfp"], ref["margins"]["m2xfp"]
    flipped = [list(o) for o in want]
    flipped[0][2] += 1
    with pytest.raises(AssertionError):
        assert_tokens_match(flipped, want, margins)
    assert assert_tokens_match(flipped, want,
                               {**margins, (0, 2): 0.0}) == 1


@pytest.mark.parametrize("case", CASES)
def test_slot_reuse_matches_requests_served_alone(reference, case):
    """Five ragged requests through two slots give each request's tokens
    served alone in a fresh one-slot engine; without the admit-time reset
    of the recurrent state a reused slot would carry the last request's
    state (the planted fault below changes a token)."""
    from repro_torch.serve import engine as E
    params, cfg = _port_packed(reference, case), _serve_cfg(case)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (5, 3, 9, 2, 6)]

    def serve(slots, batch):
        eng = E.ServeEngine(params, cfg, n_slots=slots, max_len=24,
                            device="cpu")
        out = eng.generate(batch, 4)
        eng.scheduler.check()
        return out
    outs = serve(2, prompts)
    for prompt, got in zip(prompts, outs):
        assert serve(1, [prompt]) == [got]
    reset = E._reset_slot

    def keep_recurrent(caches, slot, scrub=False):
        reset({k: v for k, v in caches.items() if k not in E.RECURRENT},
              slot, scrub)
    E._reset_slot = keep_recurrent
    try:
        assert serve(2, prompts) != outs
    finally:
        E._reset_slot = reset


# ---------------------------------------------------------------------------
# (e) what the reference refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_prefill_chunk_refuses_with_reference_message(reference, case):
    from repro_torch.models.model import init_caches, prefill_chunk
    cfg = _serve_cfg(case)
    kind, message = reference[case]["prefill_error"]
    assert kind == "NotImplementedError"
    with pytest.raises(NotImplementedError) as err:
        prefill_chunk(_port_packed(reference, case), cfg,
                      {"tokens": torch.zeros((SLOTS, 4), dtype=torch.long)},
                      init_caches(cfg, SLOTS, PAGE, "cpu"),
                      torch.zeros(SLOTS, dtype=torch.long),
                      torch.ones(SLOTS, dtype=torch.long))
    assert str(err.value) == message


@pytest.mark.parametrize("case", CASES)
def test_packed_kv_cache_raises_as_reference(reference, case):
    """An m2xfp KV cache: zamba2-smoke's head_dim of 16 is no multiple of
    the 32-element group, so both packages build the caches and raise the
    same ValueError at the first decode_step (zamba2-7b's 112 likewise);
    xlstm has no attention and decodes."""
    from repro_torch.models.model import decode_step, init_caches
    cfg = _serve_cfg(case, kv_quant="m2xfp")
    caches = init_caches(cfg, SLOTS, PAGE, "cpu")
    want = reference[case]["kv_quant_error"]

    def step():
        decode_step(_port_packed(reference, case), cfg,
                    {"tokens": torch.zeros((SLOTS, 1), dtype=torch.long)},
                    caches, torch.zeros(SLOTS, dtype=torch.long))
    if want is None:
        step()
        return
    assert want[0] == "ValueError"
    with pytest.raises(ValueError) as err:
        step()
    assert str(err.value) == want[1]


# ---------------------------------------------------------------------------
# (f) the guard's probe and scrub over recurrent leaves
# ---------------------------------------------------------------------------

def _port_caches(ref_caches: dict) -> dict:
    """The reference's layer-stacked caches as the port's lists."""
    from repro_torch.convert import to_tensor
    return {g: [{name: to_tensor(a[i], "cpu") for name, a in leaves.items()}
                for i in range(next(iter(leaves.values())).shape[0])]
            for g, leaves in ref_caches.items()}


@pytest.mark.parametrize("case", CASES)
def test_probe_kv_and_scrub_match_reference(reference, case):
    """A NaN in a recurrent leaf of slot 1 (mLSTM C, Mamba2 SSM state):
    ``probe_kv`` counts it for that slot as the reference does (the empty
    mLSTM/sLSTM log-max of -1e30 is finite, so slot 0 counts 0); the
    quarantine scrub puts the slot's recurrent state back to its init
    (m -1e30, the rest 0) and the admit reset the other slot's, each
    equal to the reference's."""
    from repro_torch.serve.engine import _reset_slot
    from repro_torch.serve.guard import probe_kv
    ref = reference[case]
    caches = _port_caches(ref["decode_caches"])
    group, leaf = POISON[case]
    t = caches[group][0][leaf]
    t[(POISON_SLOT,) + (0,) * (t.dim() - 1)] = float("nan")
    counts = probe_kv(caches, SLOTS)
    np.testing.assert_array_equal(counts.numpy(), ref["probe_kv"])
    assert counts.tolist() == [0, 1]
    _reset_slot(caches, POISON_SLOT, scrub=True)
    _assert_same_tree(caches, _port_caches(ref["scrubbed"]))
    assert probe_kv(caches, SLOTS).tolist() == [0, 0]
    _reset_slot(caches, 0)
    _assert_same_tree(caches, _port_caches(ref["reset"]))


@pytest.mark.parametrize("case", CASES)
def test_poison_kv_nan_skips_recurrent_state(reference, case):
    """The reference's poison_kv_nan finds no page on xlstm (ValueError)
    and poisons ``attn/k`` on zamba2; so does the port's."""
    from repro_torch.models.model import init_caches
    from repro_torch.testing.faults import poison_kv_nan
    ref = reference[case]
    caches = init_caches(_serve_cfg(case), SLOTS, PAGE, "cpu")
    if ref["poison_nan"] is not None:
        with pytest.raises(ValueError) as err:
            poison_kv_nan(caches, 0)
        assert (type(err.value).__name__, str(err.value)) == \
            ref["poison_nan"]
    else:
        assert poison_kv_nan(caches, 0) == ref["poison_nan_path"]
        assert bool(torch.isnan(caches["attn"][0]["k"][0]).any())


def test_guard_quarantines_a_poisoned_recurrent_state():
    """The engine's guard on xlstm-smoke: a NaN written into one slot's
    mLSTM state is counted by the KV sentinel at the next launch, the
    request is quarantined, its slot scrubbed, and the other request
    finishes with its tokens of a clean run."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import init_packed_params
    cfg = _serve_cfg("xlstm-smoke")
    params = init_packed_params(torch.Generator().manual_seed(0), cfg,
                                "cpu")
    prompts = [[1, 2, 3, 4], [5, 6, 7]]
    clean = ServeEngine(params, cfg, n_slots=2, max_len=16,
                        device="cpu").generate(prompts, 4)
    eng = ServeEngine(params, cfg, n_slots=2, max_len=16, device="cpu")
    reqs = [eng.submit(p, 4) for p in prompts]
    eng.step()
    eng.caches["mlstm"][0]["C"][1, 0, 0, 0] = float("nan")
    eng.run()
    assert reqs[0].output == clean[0]
    assert reqs[1].state == "quarantined" and eng.stats.quarantined == 1
    assert eng.guard_summary()["quarantines"] == 1
    c = eng.caches["mlstm"][0]
    assert not torch.isnan(c["C"]).any()


# ---------------------------------------------------------------------------
# (g) the blocks at tests/test_recurrent.py's sizes, and its properties
# ---------------------------------------------------------------------------

def _rec_cfg(block):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**dict(REC, n_heads=BLOCK_HEADS[block]))


@pytest.mark.parametrize("block", list(BLOCK_INPUTS))
def test_block_forward_matches_reference(reference, block):
    """Each block's forward on the reference's parameters and input: the
    bf16 output within BLOCK_REL / BLOCK_ABS, the final state within
    STATE_TOL (conv windows equal)."""
    from repro_torch.convert import to_tensor
    want = reference["blocks"][block]
    p = {k: to_tensor(v, "cpu") for k, v in want["params"].items()}
    x = torch.from_numpy(block_input(block)).to(torch.bfloat16)
    y, state = BLOCKS[block][1](p, x, _rec_cfg(block))
    got, ref = _np(y), _np(want["y"])
    bound = BLOCK_REL * np.maximum(np.abs(got), np.abs(ref)) \
        + BLOCK_ABS * np.abs(ref).max()
    assert (np.abs(got - ref) <= bound).all()
    assert sorted(state) == sorted(want["state"])
    for k, t in state.items():
        if k == "conv":
            np.testing.assert_array_equal(_np(t), _np(want["state"][k]))
        else:
            assert_state_close(t, want["state"][k], f"{block}/{k}")


def test_chunkwise_cell_matches_reference(reference):
    from repro_torch.models import xlstm as xl
    want = reference["blocks"]["cell"]
    h, st = xl._mlstm_cell_chunkwise(
        *[torch.from_numpy(a) for a in cell_inputs()])
    err = float(np.abs(h.numpy() - want["h"]).max())
    assert err <= CELL_TOL * float(np.abs(want["h"]).max()), err
    for k, t in st.items():
        assert_state_close(t, want["state"][k], f"cell/{k}")


def _forward_vs_decode(block, x):
    """The block's forward on ``x`` and its decode fed one position at a
    time, with port-drawn parameters: (forward out, decode outs, forward
    state, decode cache)."""
    init, fwd, init_cache, dec = BLOCKS[block]
    cfg = _rec_cfg(block)
    p = init(torch.Generator().manual_seed(0), cfg, "cpu")
    y, state = fwd(p, x, cfg)
    cache = init_cache(cfg, x.shape[0], "cpu")
    ys = []
    for t in range(x.shape[1]):
        yt, cache = dec(p, x[:, t:t + 1], cfg, cache)
        ys.append(yt)
    return y, torch.cat(ys, 1), state, cache


def test_mamba2_forward_equals_decode():
    """tests/test_recurrent.py's property on the port: 0.05 on the output,
    1e-3 on the SSM state, 1e-5 on the conv window."""
    x = torch.from_numpy(block_input("mamba")).to(torch.bfloat16)
    y, yseq, state, cache = _forward_vs_decode("mamba", x)
    assert float((y.float() - yseq.float()).abs().max()) < 0.05
    assert float((state["ssm"] - cache["ssm"]).abs().max()) < 1e-3
    np.testing.assert_allclose(state["conv"].numpy(), cache["conv"].numpy(),
                               atol=1e-5)


def test_mlstm_chunkwise_equals_sequential():
    """tests/test_recurrent.py's property on the port: the chunkwise cell
    against the naive recurrence, 1e-3 on h and 1e-4 on C and m."""
    from repro_torch.models import xlstm as xl
    q, k, v, logi, logf = [torch.from_numpy(a) for a in cell_inputs()]
    b, s, h, p = q.shape
    c = torch.zeros(b, h, p, p)
    n = torch.zeros(b, h, p)
    m = torch.full((b, h), -1e30)
    hs = []
    for t in range(s):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        wf = torch.exp(logf[:, t] + m - m_new)
        wi = torch.exp(logi[:, t] - m_new)
        c = c * wf[..., None, None] + wi[..., None, None] * torch.einsum(
            "bhp,bhq->bhpq", k[:, t], v[:, t])
        n = n * wf[..., None] + wi[..., None] * k[:, t]
        m = m_new
        num = torch.einsum("bhp,bhpq->bhq", q[:, t], c)
        den = torch.maximum(torch.einsum("bhp,bhp->bh", q[:, t], n).abs(),
                            torch.exp(-m))
        hs.append(num / den[..., None])
    h_ck, st = xl._mlstm_cell_chunkwise(q, k, v, logi, logf)
    assert float((h_ck - torch.stack(hs, 1)).abs().max()) < 1e-3
    assert float((st["C"] - c).abs().max()) < 1e-4
    assert float((st["m"] - m).abs().max()) < 1e-4


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_forward_equals_decode(block):
    """tests/test_recurrent.py's property on the port: 0.08 on the
    output."""
    x = torch.from_numpy(block_input(block)).to(torch.bfloat16)
    y, yseq, _, _ = _forward_vs_decode(block, x)
    assert float((y.float() - yseq.float()).abs().max()) < 0.08


@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_masked_exponent_keeps_the_backward_finite(block):
    """Both chunked forms mask inside the exponent: at a full chunk of 128
    every gradient of the block's parameters and input is finite (a mask
    applied after exp would give inf * 0 = NaN)."""
    init, fwd, _, _ = BLOCKS[block]
    cfg = _rec_cfg(block)
    p = _with_grad(init(torch.Generator().manual_seed(1), cfg, "cpu"))
    x = torch.randn(1, 128, 64, generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16).requires_grad_(True)
    y, _ = fwd(p, x, cfg)
    y.float().square().sum().backward()
    assert bool(torch.isfinite(x.grad.float()).all())
    for k, g in _grads(p).items():
        assert bool(torch.isfinite(g.float()).all()), k


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_reference_checkpoint_loads_and_serves(reference, case, tmp_path):
    """The port restores the checkpoint the reference packed to the same
    tree and serves it with the reference engine's tokens."""
    import shutil
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import load_packed_checkpoint
    cfg = _serve_cfg(case)
    src = str(tmp_path / case)
    shutil.copytree(os.path.join(reference["root"], case), src)
    params, extra = load_packed_checkpoint(src, cfg, device="cpu",
                                           validate_streams=True)
    assert extra["model"] == cfg.name
    _assert_same_tree(params, _port_packed(reference, case))
    eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=PAGE,
                      device="cpu")
    assert eng.generate(PROMPTS, N_NEW) == reference[case]["tokens"]["m2xfp"]


@pytest.mark.parametrize("case", CASES)
def test_port_save_writes_reference_checkpoint(reference, case, tmp_path):
    from repro_torch.serve.prequant import save_packed_checkpoint
    save_packed_checkpoint(str(tmp_path / case),
                           _port_packed(reference, case), _serve_cfg(case))
    _assert_same_checkpoint(str(tmp_path / case),
                            os.path.join(reference["root"], case))


if __name__ == "__main__":
    _reference_main(sys.argv[1])
