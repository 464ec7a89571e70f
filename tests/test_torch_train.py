"""The port's training (ROADMAP A8) against the reference.

One child (the reference, run as in test_torch_serve.py with XLA's excess
precision off) computes, at the tiny configs of tests/test_system.py and
the smoke configs:

(a) ``_chunked_attention`` with small KV chunks and q tiles (several
    chunks, a padded last chunk, q tiles, GQA, a window, a soft-cap);
(b) for each case of CASES and each mode of MODES: ``forward``'s logits,
    ``loss_fn`` and its gradients through the trainer's
    ``_grads_and_loss`` (f32 master parameters cast for compute); the dense
    model also at S = 1100, where ``forward`` pads the third KV chunk of
    512;
(c) ``adamw_update`` over four steps and ``warmup_cosine`` (jitted and op
    by op), ``compress_decompress`` with top-k and int8;
(d) microbatch accumulation (4 microbatches);
(e) 20 steps of ``make_train_step`` from one state, with a
    ``CheckpointManager`` checkpoint at step 10, and the test_system.py
    layout (``(params, opt)``) saved with ``save_state``;
(f) the deployment story: test_system.py's training, then the trained
    parameters packed m2xfp, ``loss_fn`` under ``serve``, under ``none``
    and under ``qat``/mxfp4 on a held-out batch, and the engine's greedy
    tokens.

The port side runs on one torch thread (test_torch_moe.py says why) and
holds each result to the tolerance stated beside it. Data batches
(``repro.data.pipeline`` is numpy only) and checkpoints the port writes
are checked against the reference in this process.
"""
import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.testing.train import GRAD_L2, GRAD_TOL, grad_agreement
from test_torch_serve import _flatten, run_reference_child

BASE = dict(name="sys", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16, remat=False)
# case -> (registry name or None for BASE, overrides)
CASES = {
    "dense": (None, {}),
    "qwen2-smoke": ("qwen2-0.5b", {}),
    "qwen3-smoke": ("qwen3-8b", {}),
    "gemma2-smoke": ("gemma2-9b", {}),
    "olmoe-smoke": ("olmoe-1b-7b", {}),
    "mixtral-smoke": ("mixtral-8x22b", {}),
    "musicgen-smoke": ("musicgen-large", {}),
}
MODES = [("none", "m2xfp"), ("qat", "m2xfp"), ("qat", "mxfp4")]
# qwen2-smoke's d_model of 56 is no multiple of the 32-element group, so the
# reference's fake-quant raises (group_reshape); it runs ``none`` only
NONE_ONLY = {"qwen2-smoke"}
# (b): B x S = 128 tokens, two MoE routing groups of 64; S = 64 exceeds the
# windows of 32 (gemma2's local layers, mixtral)
B, S = 2, 64
LONG_S = 1100
# (a): (name, S, nh, nkv, window, softcap, chunk, q_tile)
ATTN_CASES = [("gqa-chunks", 40, 4, 2, 2 ** 30, None, 16, 32),
              ("window", 64, 4, 1, 12, None, 16, 32),
              ("softcap", 48, 4, 4, 2 ** 30, 5.0, 16, 16),
              ("one-tile", 24, 2, 2, 7, 3.0, 8, 32)]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
           clip_norm=0.5)
SCHEDULES = [dict(lr=3e-4, warmup_steps=100, total_steps=10000),
             dict(lr=1e-3, warmup_steps=3, total_steps=7),
             dict(lr=5e-3, warmup_steps=5, total_steps=120)]
TRAIN_STEPS, CKPT_STEP = 20, 10
TRAIN_OPT = dict(lr=3e-3, warmup_steps=4, total_steps=TRAIN_STEPS)
TRAIN_DATA = dict(batch=8, seq=32, seed=2, motif_len=6, noise=0.02)
# (f): test_system.py's _train, at fewer steps
SYS_STEPS = 40
SYS_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=SYS_STEPS,
               weight_decay=0.0)
EVAL_DATA = dict(batch=8, seq=32, seed=99, motif_len=6, noise=0.02)
PROMPTS = [[5, 17, 5, 17, 9], [3, 3, 100, 42, 7, 7, 1, 0, 64], [77, 1, 2]]
ENGINE = dict(n_slots=2, max_len=32, prefill_chunk=4)
N_NEW = 6


def make_config(configs, case: str, **kw):
    """``case``'s config from ``configs`` (``repro.configs`` or
    ``repro_torch.configs``)."""
    arch, overrides = CASES[case]
    if arch is None:
        package = configs.__name__.split(".")[0]
        model_config = importlib.import_module(
            f"{package}.models.config").ModelConfig
        return model_config(**{**BASE, **overrides, **kw})
    return configs.smoke_config(arch, **overrides, **kw)


def case_modes(case: str) -> list:
    return MODES[:1] if case in NONE_ONLY else MODES


def case_batch(cfg, s: int = S) -> dict:
    """(b)'s numpy batch: tokens (or bf16-exact f32 embeddings of std 1)
    and labels, every seventh label -1 (ignored)."""
    rng = np.random.default_rng(s)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[:, ::7] = -1
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
        return {"embeds": x, "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32), "labels": labels}


def attn_inputs(s, nh, nkv, hd=16):
    rng = np.random.default_rng(s * 10 + nh)
    q = rng.standard_normal((B, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, s, nkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    pos[1, -5:] = -1                    # invalid keys in row 1
    return q, k, v, pos


def compression_grads() -> list:
    """Three (64, 16) gradients; the first on a grid of 1/8, so that many
    magnitudes tie, also at the top-k thresholds."""
    rng = np.random.default_rng(7)
    out = [rng.standard_normal((64, 16)).astype(np.float32)
           for _ in range(3)]
    out[0] = np.round(out[0] * 8) / 8
    return out


# name -> (int8, topk_density). The reference runs op by op: jitted, XLA
# multiplies by the rounded reciprocal of 127 where _quant_int8 divides by
# it (ROADMAP C), and the scale moves by an ulp; the port divides.
COMPRESSIONS = {"topk-int8": (True, 0.25), "topk": (False, 0.1),
                "int8": (True, 1.0)}


def opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 24)).astype(np.float32),
            "b": rng.standard_normal((24,)).astype(np.float32),
            "layers": {"u": rng.standard_normal((3, 16, 8)).astype(
                np.float32)}}


# ---------------------------------------------------------------------------
# The reference, run in a child process (test_torch_serve.py's docstring)
# ---------------------------------------------------------------------------

def reference_loss(logits, labels):
    """The lines of repro.models.model.loss_fn after its ``forward``, so
    that one jitted forward gives both the logits and the loss (XLA does
    not merge a second forward; test_long_sequence_pads_a_kv_chunk holds
    ``loss_fn`` to this)."""
    import jax
    import jax.numpy as jnp
    valid = labels >= 0
    safe = jnp.maximum(labels, 0)
    lf = logits.astype(jnp.float32)
    lse = jax.nn.logsumexp(lf, axis=-1)
    vocab_iota = jnp.arange(logits.shape[-1], dtype=labels.dtype)
    picked = jnp.sum(
        jnp.where(safe[..., None] == vocab_iota, lf, 0.0), axis=-1)
    nll = lse - picked
    return jnp.sum(nll * valid) / jnp.maximum(jnp.sum(valid), 1)


def _reference_main(out_path: str) -> None:
    import pickle

    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.checkpoint import CheckpointManager, save_state
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import attention as ja
    from repro.models.model import (forward, init_params, loss_fn,
                                    pack_params_for_serving)
    from repro.serve import ServeEngine
    from repro.train.compression import (CompressionConfig,
                                         compress_decompress)
    from repro.train.optimizer import (AdamWConfig, adamw_init,
                                       adamw_update, warmup_cosine)
    from repro.train.trainer import (_grads_and_loss, cast_for_compute,
                                     make_train_state, make_train_step)
    out = {"attn": {}, "cases": {}}
    tmp = os.path.dirname(out_path)

    for name, s, nh, nkv, window, cap, chunk, q_tile in ATTN_CASES:
        cfg = dataclasses.replace(make_config(configs, "dense"),
                                  attn_softcap=cap)
        q, k, v, pos = attn_inputs(s, nh, nkv)
        fn = jax.jit(lambda q, k, v, p: ja._chunked_attention(
            q, k, v, p, p, cfg, jnp.int32(window), chunk, q_tile))
        out["attn"][name] = np.asarray(fn(q, k, v, pos))

    def jbatch(b):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if "embeds" in b:
            b["embeds"] = b["embeds"].astype(jnp.bfloat16)
        return b

    for case in CASES:
        # remat changes no value (it recomputes the same ops); without it
        # the fake-quant is traced once, not twice, so XLA compiles in half
        # the time
        base = make_config(configs, case, remat=False)
        params = jax.tree.map(lambda p: p.astype(jnp.float32),
                              init_params(jax.random.PRNGKey(0), base))
        res = {"params": _flatten(params), "modes": {}}
        for quant, fmt in case_modes(case):
            cfg = dataclasses.replace(base, quant=quant, quant_format=fmt)
            batch = jbatch(case_batch(cfg))

            def f(p):                   # loss_fn, keeping its logits
                logits = forward(cast_for_compute(p), cfg, batch)
                return reference_loss(logits, batch["labels"]), logits
            (loss, logits), grads = jax.jit(
                jax.value_and_grad(f, has_aux=True))(params)
            res["modes"][(quant, fmt)] = {
                "loss": float(loss), "logits": np.asarray(logits),
                "grads": _flatten(grads)}
        out["cases"][case] = res
    base = make_config(configs, "dense")
    params = init_params(jax.random.PRNGKey(0), base)
    batch = jbatch(case_batch(base, LONG_S))
    logits = jax.jit(lambda p: forward(p, base, batch))(params)
    out["long"] = {
        "params": _flatten(params), "logits": np.asarray(logits),
        "loss": float(jax.jit(lambda p: loss_fn(p, base, batch))(params)),
        "loss_of_logits": float(jax.jit(reference_loss)(
            logits, batch["labels"]))}

    # (c) optimizer, schedule, compression
    ocfg = AdamWConfig(**OPT)
    p, opt = opt_tree(0), adamw_init(opt_tree(0))
    upd = jax.jit(lambda p, g, o: adamw_update(p, g, o, ocfg))
    steps = []
    for i in range(4):
        p, opt, m = upd(p, opt_tree(10 + i), opt)
        steps.append({"params": _flatten(p), "opt": _flatten(opt),
                      "metrics": _flatten(m)})
    out["adamw"] = steps
    out["schedule"] = {}
    for j, kw in enumerate(SCHEDULES):
        sched = warmup_cosine(AdamWConfig(**kw))
        grid = np.arange(kw["total_steps"] + 3, dtype=np.int32)
        jitted = jax.jit(jax.vmap(sched))(grid)
        with jax.disable_jit():
            eager = np.stack([np.asarray(sched(jnp.int32(i))) for i in grid])
        out["schedule"][j] = {"jit": np.asarray(jitted), "eager": eager}
    comp = {}
    for name, (int8, density) in COMPRESSIONS.items():
        cc = CompressionConfig(True, int8, density)
        err, seq = jnp.zeros((64, 16)), []
        with jax.disable_jit():             # see COMPRESSION's comment
            for g in compression_grads():
                deq, err = compress_decompress(jnp.asarray(g), err, cc)
                seq.append((np.asarray(deq), np.asarray(err)))
        comp[name] = seq
    out["compression"] = comp

    # (d) microbatches, (e) train steps with a checkpoint
    cfg = make_config(configs, "dense")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab_size, **TRAIN_DATA))
    state = make_train_state(jax.random.PRNGKey(3), cfg)
    out["train_init"] = _flatten(state)
    mb_batch = jbatch(data.batch_at(100))
    loss4, g4 = jax.jit(lambda p, b: _grads_and_loss(p, cfg, b, 4))(
        state["params"], mb_batch)
    out["microbatch"] = {"loss": float(loss4), "grads": _flatten(g4)}
    step = jax.jit(make_train_step(cfg, AdamWConfig(**TRAIN_OPT)))
    mgr = CheckpointManager(os.path.join(tmp, "ref_train_ckpt"), every=10**9)
    traj = []
    for i in range(TRAIN_STEPS):
        state, m = step(state, jbatch(data.batch_at(i)))
        traj.append({k: float(v) for k, v in m.items()})
        if i + 1 == CKPT_STEP:
            mgr.maybe_save(CKPT_STEP, state, extra={"data_step": CKPT_STEP},
                           force=True)
            out["train_mid"] = _flatten(state)
    mgr.wait()
    out["train_traj"] = traj
    out["train_final"] = _flatten(state)
    out["ref_train_ckpt"] = mgr.dir

    # (f) test_system.py's deployment story
    scfg = dataclasses.replace(cfg, quant="serve")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab_size, batch=8, seq=32,
                                  seed=2, motif_len=6, noise=0.02))
    params = init_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    opt = adamw_init(params)
    socfg = AdamWConfig(**SYS_OPT)

    @jax.jit
    def sys_step(params, opt, batch):
        loss, g = jax.value_and_grad(lambda p: loss_fn(p, cfg, batch))(
            params)
        params, opt, _ = adamw_update(params, g, opt, socfg)
        return params, opt, loss

    for i in range(SYS_STEPS):
        params, opt, _ = sys_step(params, opt, jbatch(data.batch_at(i)))
    save_state(os.path.join(tmp, "ref_sys_ckpt"), 0, (params, opt),
               extra={"step": SYS_STEPS})
    out["ref_sys_ckpt"] = os.path.join(tmp, "ref_sys_ckpt")
    out["sys_params"] = _flatten(params)
    ev = jbatch(SyntheticLM(DataConfig(vocab=cfg.vocab_size,
                                       **EVAL_DATA)).batch_at(0))
    packed = pack_params_for_serving(params, scfg)
    qcfg = dataclasses.replace(cfg, quant="qat", quant_format="mxfp4")
    out["sys"] = {
        "packed": _flatten(packed),
        "loss_none": float(jax.jit(lambda p: loss_fn(p, cfg, ev))(params)),
        "loss_serve": float(jax.jit(lambda p: loss_fn(p, scfg, ev))(packed)),
        "loss_qat_mxfp4": float(jax.jit(lambda p: loss_fn(p, qcfg, ev))(
            params)),
        "tokens": ServeEngine(packed, scfg, guard=False, **ENGINE).generate(
            PROMPTS, N_NEW)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _reference_main(sys.argv[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's CPU ops are small (smoke models): when the other test
    workers hold every core, the intra-op thread pool costs far more than
    it saves, so they run on one thread (test_torch_moe.py). The previous
    setting comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

def port_cfg(case: str, **kw):
    from repro_torch import configs
    return make_config(configs, case, **kw)


def port_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(torch.bfloat16)
    return out


def port_tree(flat_tree: dict, cfg):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(flat_tree, cfg, "cpu")


def leaves_of(tree) -> dict:
    """{path: numpy} of a tree in the reference's layout (numpy leaves) or
    of the port's parameter-shaped tree (layers stacked first)."""
    from repro_torch.convert import flat_leaves, stack_layers
    if isinstance(tree, dict) and isinstance(tree.get("layers"), list):
        tree = stack_layers(tree)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in flat_leaves(tree).items()}


def assert_grads_close(port: dict, ref: dict, label: str) -> None:
    """Every gradient leaf within GRAD_TOL of the reference's, and within
    GRAD_L2 in L2 norm relative to the reference's (``grad_agreement``,
    the card-vs-CPU check's own)."""
    assert sorted(port) == sorted(ref), label
    for k, a in ref.items():
        assert port[k].shape == a.shape and port[k].dtype == a.dtype, \
            (label, k)
    as_t = lambda t: {k: torch.from_numpy(np.array(v))  # noqa: E731
                      for k, v in t.items()}
    worst = grad_agreement(as_t(port), as_t(ref))
    assert worst["elem_ratio"] <= 1 and worst["l2_ratio"] <= 1, \
        (label, worst)


# (a): f32 outputs of bf16 operands; the sums' order differs (float64 in
# the port on the CPU, XLA's f32 order in the reference): measured within
# 3.6e-7 of outputs of |o| < 3
ATTN_TOL = dict(rtol=0.0, atol=2e-6)
# (b) logits. Under qat every value that meets a product is fake-quantized
# first, and the port's products equal the reference's within f32 rounding:
# measured within 1.8e-7, except one position of musicgen-smoke (m2xfp)
# where an activation rounding flipped (0.020). Under none, products of
# bf16 values are rounded to bf16 after sums taken in another order
# (float64 here), so an element within an ulp of a rounding edge flips one
# bf16 ulp and moves later layers: measured up to 4.1e-3 (gemma2-smoke) on
# logits of |l| < 4. So: qat rows within QAT_LOGIT_TOL but at most
# QAT_FLIP_ROWS rows within FLIP_TOL; none within NONE_LOGIT_TOL.
QAT_LOGIT_TOL, QAT_FLIP_ROWS, FLIP_TOL = 2e-5, 2, 0.05
NONE_LOGIT_TOL = 1.6e-2
# (b) loss: measured within 5.1e-5 (olmoe-smoke, none)
LOSS_TOL = 2e-4
# (b) gradients: the backward rounds each gradient to bf16 where the
# forward cast (cast_for_compute, every bf16 product operand), and sums
# taken in another order flip such roundings by an ulp, which later
# products carry on. Measured: every element within 2.7 x 2^-7 of (its
# magnitude + the leaf's largest), the L2 error within 0.019 of the leaf's
# norm (qwen2-smoke, none). A gradient path missing or doubled moves a
# leaf by its whole size. GRAD_TOL = GRAD_L2 = 2^-5
# (repro_torch.testing.train, imported above).


def test_synthetic_and_byte_batches_equal_reference(tmp_path):
    """The port's copy of the data pipeline gives the reference's batches,
    bit for bit, host-sharded too (numpy only, so the reference runs in
    this process)."""
    from repro.data import pipeline as ref
    from repro_torch.data import pipeline as port
    for kw in (dict(batch=8, seq=32, vocab=128, seed=3),
               dict(batch=4, seq=17, vocab=32000, seed=0, motif_len=5,
                    noise=0.3, host_id=1, num_hosts=2)):
        a = port.SyntheticLM(port.DataConfig(**kw))
        b = ref.SyntheticLM(ref.DataConfig(**kw))
        for step in (0, 1, 7, 123456):
            x, y = a.batch_at(step), b.batch_at(step)
            for k in ("tokens", "labels"):
                assert x[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(np.random.default_rng(1).integers(
        0, 256, 5000, dtype=np.uint8)))
    kw = dict(batch=4, seq=64, vocab=200, seed=5)
    a = port.ByteCorpus(port.DataConfig(**kw), str(corpus))
    b = ref.ByteCorpus(ref.DataConfig(**kw), str(corpus))
    for step in (0, 3, 99):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch_at(step)[k],
                                          b.batch_at(step)[k])


def test_prefetcher_straggler_and_preemption():
    """The port's copies of the prefetcher, the straggler monitor and the
    preemption guard behave as the reference's tests hold them."""
    import signal

    from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
    from repro_torch.distributed import straggler as sg
    src = SyntheticLM(DataConfig(batch=2, seq=16, vocab=64, seed=0))
    pf = Prefetcher(src, start_step=3, depth=2)
    try:
        (s0, b0), (s1, _) = next(pf), next(pf)
        assert (s0, s1) == (3, 4)
        np.testing.assert_array_equal(b0["tokens"],
                                      src.batch_at(3)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()
    events = []
    mon = sg.StragglerMonitor(threshold=2.0, patience=2,
                              on_straggle=lambda s, dt: events.append(s))
    clock = iter(np.cumsum([0.0] + [t for t in [0.1] * 5 + [0.5, 0.5]
                                    + [0.1] * 3 for t in (t, 0.0)]))
    orig = sg.time.monotonic
    sg.time.monotonic = lambda: float(next(clock))
    try:
        flags = []
        for i in range(10):
            mon.step_start()
            flags.append(mon.step_end(i))
    finally:
        sg.time.monotonic = orig
    assert events == [6] and flags.count(True) == 1
    guard = sg.PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.preempted
    finally:
        guard.restore()


@pytest.mark.parametrize("case", [c[0] for c in ATTN_CASES])
def test_chunked_attention_matches_reference(reference, case):
    """Several KV chunks (the last padded), q tiles, GQA, windows, the
    soft-cap and invalid keys, with small ``chunk`` and ``q_tile``."""
    from repro_torch.models import attention
    _, s, nh, nkv, window, cap, chunk, q_tile = next(
        c for c in ATTN_CASES if c[0] == case)
    cfg = dataclasses.replace(port_cfg("dense"), attn_softcap=cap)
    q, k, v, pos = (torch.from_numpy(a) for a in attn_inputs(s, nh, nkv))
    out = attention._chunked_attention(q, k, v, pos, pos, cfg, window,
                                       chunk, q_tile)
    np.testing.assert_allclose(out.numpy(), reference["attn"][case],
                               **ATTN_TOL)


GRID = [(case, quant, fmt) for case in CASES
        for quant, fmt in case_modes(case)]


@pytest.mark.parametrize("case,quant,fmt", GRID,
                         ids=[f"{c}-{q}-{f}" for c, q, f in GRID])
def test_forward_loss_and_grads_match_reference(reference, case, quant,
                                                 fmt):
    """``forward``'s logits, ``loss_fn`` and the trainer's gradients (f32
    masters cast for compute) against the reference's, each within its
    tolerance above; with ``remat`` on and off the port's gradients are
    the same bits."""
    from repro_torch.models.model import forward
    from repro_torch.train.trainer import _grads_and_loss, cast_for_compute
    ref = reference["cases"][case]
    want = ref["modes"][(quant, fmt)]
    cfg = port_cfg(case, quant=quant, quant_format=fmt, remat=False)
    params = port_tree(ref["params"], cfg)
    batch = port_batch(case_batch(cfg))
    with torch.no_grad():
        logits = forward(cast_for_compute(params), cfg, batch).numpy()
    d = np.abs(logits - want["logits"]).max(axis=-1)          # per row
    if quant == "qat":
        assert (d <= FLIP_TOL).all(), d.max()
        assert (d > QAT_LOGIT_TOL).sum() <= QAT_FLIP_ROWS, np.sort(d)[-5:]
    else:
        assert (d <= NONE_LOGIT_TOL).all(), d.max()
    loss, grads = _grads_and_loss(params, cfg, batch, 1)
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL
    assert_grads_close(leaves_of(grads), leaves_of(want["grads"]), case)
    loss_r, grads_r = _grads_and_loss(
        params, dataclasses.replace(cfg, remat=True), batch, 1)
    assert torch.equal(loss, loss_r)
    for k, g in leaves_of(grads_r).items():
        np.testing.assert_array_equal(g, leaves_of(grads)[k], err_msg=k)


def test_long_sequence_pads_a_kv_chunk(reference):
    """S = 1100 at the default chunk of 512 and q tile of 1024 (1100 is no
    multiple of the tile, so all queries at once; the third KV chunk is
    padded with 436 masked keys): logits and ``loss_fn`` of bf16
    parameters, and ``collect_cache``'s per-layer K/V; and the reference's
    ``loss_fn`` equals its ``forward`` then ``reference_loss``, which the
    grid above relies on."""
    from repro_torch.models.model import forward, loss_fn
    want = reference["long"]
    assert want["loss"] == want["loss_of_logits"]
    cfg = port_cfg("dense")
    params = port_tree(want["params"], cfg)
    batch = port_batch(case_batch(cfg, LONG_S))
    with torch.no_grad():
        logits = forward(params, cfg, batch)
        loss = loss_fn(params, cfg, batch)
        again, kvs = forward(params, cfg, batch, collect_cache=True)
    assert torch.equal(again, logits) and len(kvs) == cfg.n_layers
    assert all(t.shape == (B, LONG_S, cfg.n_kv_heads, cfg.hd)
               for kv in kvs for t in kv)
    assert np.abs(logits.numpy() - want["logits"]).max() <= NONE_LOGIT_TOL
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_forward_refuses_recurrent_families(family):
    """``forward`` (and so ``loss_fn`` and training) refuses the recurrent
    families, as decode does (ROADMAP A9)."""
    from repro_torch.models.model import forward
    cfg = dataclasses.replace(port_cfg("dense"), family=family)
    with pytest.raises(NotImplementedError, match=family):
        forward({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


# (c): the port's scalar arithmetic is the reference's, except that the
# global norm sums the squares in float64 (XLA in f32, in its order) and
# the schedule's cosine is XLA's f32 cos in the reference, a correctly
# rounded one here (float64, rounded once, so that the card gives the
# CPU's bits). Measured: the norm 1 ulp off at three of four steps, so the
# clipped gradients are an ulp off and so, through m and v, the update:
# every parameter, moment and metric within 1.2e-7 absolute, at most 2^-21
# of its leaf's largest magnitude. Held within ADAMW_TOL of that.
ADAMW_TOL = 2.0 ** -19
# the schedule: within SCHEDULE_TOL x lr of the reference both op by op
# (XLA's cos 1-2 ulps from the correctly rounded one at 42 of 10,003 steps
# of the first schedule, and 0.5 * (1 + cos) near 0 magnifies them) and
# jitted (where XLA also multiplies by the rounded reciprocal of a
# constant divisor, ROADMAP C; it differs from op by op at 3,730 steps):
# measured within 2.0e-7 x lr
SCHEDULE_TOL = 2.0 ** -21


def test_adamw_update_matches_reference(reference):
    """Four AdamW steps (warmup then cosine, clipping active, weight decay
    on matrix leaves only) fed the reference's parameters and gradients."""
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update)
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict)  # noqa: E731
                      else torch.from_numpy(v) for k, v in t.items()}
    p = to_t(opt_tree(0))
    opt = adamw_init(p)
    cfg = AdamWConfig(**OPT)
    for i, want in enumerate(reference["adamw"]):
        p, opt, m = adamw_update(p, to_t(opt_tree(10 + i)), opt, cfg)
        got = {"params": p, "opt": opt, "metrics": m}
        for part in ("params", "opt", "metrics"):
            a, b = leaves_of(got[part]), leaves_of(want[part])
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, (i, part, k)
                tol = ADAMW_TOL * np.abs(b[k]).max()
                assert np.abs(a[k] - b[k]).max() <= tol, (i, part, k)
    assert int(opt["step"]) == 4


@pytest.mark.parametrize("j", range(len(SCHEDULES)))
def test_schedule_matches_reference(reference, j):
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
    kw = SCHEDULES[j]
    sched = warmup_cosine(AdamWConfig(**kw))
    grid = torch.arange(kw["total_steps"] + 3, dtype=torch.int32)
    got = np.stack([sched(s).numpy() for s in grid])
    want = reference["schedule"][j]
    for run in ("eager", "jit"):
        assert np.abs(got - want[run]).max() <= SCHEDULE_TOL * kw["lr"], run


@pytest.mark.parametrize("name", list(COMPRESSIONS))
def test_compress_decompress_matches_reference(reference, name):
    """Top-k (ties at the threshold kept) and int8 with error feedback over
    three steps: equal to the reference's."""
    from repro_torch.train.compression import (CompressionConfig,
                                               compress_decompress)
    int8, density = COMPRESSIONS[name]
    cc = CompressionConfig(True, int8, density)
    err = torch.zeros((64, 16))
    for g, (deq_r, err_r) in zip(compression_grads(),
                                 reference["compression"][name]):
        deq, err = compress_decompress(torch.from_numpy(g), err, cc)
        np.testing.assert_array_equal(deq.numpy(), deq_r)
        np.testing.assert_array_equal(err.numpy(), err_r)


def test_compressed_and_sharded_paths_raise():
    """What needs a multi-pod mesh raises, naming ROADMAP A11."""
    from repro_torch.train import CompressionConfig, make_train_step
    from repro_torch.train.compression import compressed_psum
    from repro_torch.train.optimizer import AdamWConfig
    with pytest.raises(NotImplementedError, match="A11"):
        make_train_step(port_cfg("dense"), AdamWConfig(),
                        CompressionConfig(enabled=True))
    with pytest.raises(NotImplementedError, match="A11"):
        compressed_psum({}, {}, CompressionConfig(True), "pod", 2)


def _train_data(cfg):
    from repro_torch.data import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab=cfg.vocab_size, **TRAIN_DATA))


def test_microbatch_grads_match_full_batch_and_reference(reference):
    """Four microbatches: against the port's full batch as
    tests/test_train_substrate.py holds the reference (loss within 5e-3,
    every leaf within 5% of its largest), and against the reference's four
    microbatches within the gradient tolerances above."""
    from repro_torch.convert import from_jax_train_state
    from repro_torch.train.trainer import _grads_and_loss
    cfg = port_cfg("dense")
    params = from_jax_train_state(reference["train_init"], cfg,
                                  "cpu")["params"]
    batch = port_batch(_train_data(cfg).batch_at(100))
    l1, g1 = _grads_and_loss(params, cfg, batch, 1)
    l4, g4 = _grads_and_loss(params, cfg, batch, 4)
    assert abs(float(l1) - float(l4)) < 5e-3
    a, b = leaves_of(g1), leaves_of(g4)
    assert max(np.abs(a[k] - b[k]).max() / (np.abs(a[k]).max() + 1e-9)
               for k in a) < 0.05
    want = reference["microbatch"]
    assert abs(float(l4) - want["loss"]) <= LOSS_TOL
    assert_grads_close(b, leaves_of(want["grads"]), "microbatch")


def run_port_training(reference, steps, start_state=None, start=0,
                      mgr=None):
    """The port's make_train_step from the reference's initial state (or
    ``start_state`` at step ``start``) over TRAIN_DATA; with ``mgr``, a
    forced checkpoint after CKPT_STEP steps. Returns (state, metrics per
    step as floats)."""
    from repro_torch.convert import from_jax_train_state
    from repro_torch.train import AdamWConfig, make_train_step
    cfg = port_cfg("dense")
    state = start_state or from_jax_train_state(reference["train_init"],
                                                cfg, "cpu")
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    data, traj = _train_data(cfg), []
    for i in range(start, steps):
        state, m = step_fn(state, port_batch(data.batch_at(i)))
        traj.append({k: float(v) for k, v in m.items()})
        if mgr is not None and i + 1 == CKPT_STEP:
            mgr.maybe_save(CKPT_STEP, state,
                           extra={"data_step": CKPT_STEP}, force=True)
    if mgr is not None:
        mgr.wait()
    return state, traj


# (e): 20 steps from the same state on the same batches. The gradients
# differ by (b)'s bf16 rounding flips from the first step (grad_norm 2e-4
# apart), and the parameters carry that on: measured, losses (about 4.8)
# within 1.4e-3 of the reference's and grad_norm within 1.1%; held within
# TRAJ_LOSS_TOL and TRAJ_GNORM_RTOL; lr within SCHEDULE_TOL x lr
TRAJ_LOSS_TOL = 5e-3
TRAJ_GNORM_RTOL = 0.03


def test_train_trajectory_matches_reference(reference):
    """20 steps of make_train_step: loss, grad_norm and lr per step against
    the reference's."""
    _, traj = run_port_training(reference, TRAIN_STEPS)
    want = reference["train_traj"]
    losses = np.array([t["loss"] for t in traj])
    want_losses = np.array([t["loss"] for t in want])
    assert np.abs(losses - want_losses).max() <= TRAJ_LOSS_TOL
    assert losses[-1] < losses[0]
    lrs = np.array([t["lr"] for t in traj])
    assert np.abs(lrs - [t["lr"] for t in want]).max() <= \
        SCHEDULE_TOL * TRAIN_OPT["lr"]
    gn = np.array([t["grad_norm"] for t in traj])
    np.testing.assert_allclose(gn, [t["grad_norm"] for t in want],
                               rtol=TRAJ_GNORM_RTOL)


def test_resume_is_bitexact(reference, tmp_path):
    """Crash and resume from a CheckpointManager checkpoint written after
    CKPT_STEP steps: the resumed run ends on the uninterrupted run's bits
    (the port on the CPU; the card's twin is in test_torch_gpu.py)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import train_state_leaves
    full, _ = run_port_training(reference, TRAIN_STEPS)
    mgr = CheckpointManager(str(tmp_path), every=10 ** 9)
    run_port_training(reference, CKPT_STEP, mgr=mgr)
    restored, extra, step = CheckpointManager(str(tmp_path)).resume(
        full, port_cfg("dense"), "cpu")
    assert (step, extra) == (CKPT_STEP, {"data_step": CKPT_STEP})
    assert int(restored["opt"]["step"]) == CKPT_STEP
    resumed, _ = run_port_training(reference, TRAIN_STEPS, restored,
                                   start=CKPT_STEP)
    a, b = train_state_leaves(full), train_state_leaves(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_port_restores_reference_train_checkpoints(reference):
    """The reference's CheckpointManager checkpoint (the trainer's dict
    layout) and test_system.py's ``(params, opt)`` tuple, restored by the
    port, equal the states the reference saved, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, restore_state
    from repro_torch.convert import (from_jax_train_state, flat_leaves,
                                     from_jax_tree, stack_layers,
                                     train_state_leaves)
    cfg = port_cfg("dense")
    template = from_jax_train_state(reference["train_init"], cfg, "cpu")
    state, extra, step = CheckpointManager(
        reference["ref_train_ckpt"]).resume(template, cfg, "cpu")
    assert (step, extra) == (CKPT_STEP, {"data_step": CKPT_STEP})
    want = train_state_leaves(from_jax_train_state(reference["train_mid"],
                                                   cfg, "cpu"))
    got = train_state_leaves(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    params = from_jax_tree(reference["sys_params"], cfg, "cpu")
    opt = {"m": params, "v": params,
           "step": torch.zeros((), dtype=torch.int32)}
    tmpl = flat_leaves({"0": stack_layers(params),
                        "1": {**opt, "m": stack_layers(opt["m"]),
                              "v": stack_layers(opt["v"])}})
    flat, extra = restore_state(reference["ref_sys_ckpt"], tmpl)
    assert extra == {"step": SYS_STEPS}
    assert int(flat["1/step"]) == SYS_STEPS
    for k, v in flat_leaves(reference["sys_params"], "0/").items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


def test_reference_restores_port_train_checkpoints(reference, tmp_path):
    """The port's CheckpointManager save of a train state, and its
    ``save_state`` of test_system.py's ``(params, opt)`` tuple, restored by
    the reference, equal what the port saved."""
    from repro.checkpoint import restore_state as ref_restore
    from repro_torch.checkpoint import CheckpointManager, save_state
    from repro_torch.convert import (from_jax_train_state, flat_leaves,
                                     stack_layers)
    cfg = port_cfg("dense")
    mid = reference["train_mid"]
    mgr = CheckpointManager(str(tmp_path / "train"))
    mgr.maybe_save(CKPT_STEP, from_jax_train_state(mid, cfg, "cpu"),
                   extra={"data_step": CKPT_STEP}, force=True)
    mgr.wait()
    got, extra = ref_restore(str(tmp_path / "train"), mid)
    assert extra == {"data_step": CKPT_STEP}
    want = flat_leaves(mid)
    for k, v in flat_leaves(_flatten(got)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    params = port_tree(reference["sys_params"], cfg)
    step = torch.tensor(SYS_STEPS, dtype=torch.int32)
    opt = {"m": stack_layers(params), "v": stack_layers(params),
           "step": step}
    save_state(str(tmp_path / "sys"), 0,
               flat_leaves({"0": stack_layers(params), "1": opt}),
               extra={"step": SYS_STEPS})
    sys_params = reference["sys_params"]
    (p, o), extra = ref_restore(
        str(tmp_path / "sys"),
        (sys_params, {"m": sys_params, "v": sys_params,
                      "step": np.zeros((), np.int32)}))
    assert extra == {"step": SYS_STEPS} and int(o["step"]) == SYS_STEPS
    for k, v in flat_leaves(_flatten(p)).items():
        np.testing.assert_array_equal(
            v, flat_leaves(reference["sys_params"])[k], err_msg=k)


# (f): the trained model's losses on the held-out batch. none: f32
# parameters, so the products' order alone (and the attention's bf16
# operands); serve and qat: the same fake-quantized operands, the products'
# order: measured within 2e-6
DEPLOY_LOSS_TOL = 1e-4


@pytest.fixture(scope="module")
def deployed(reference):
    """The reference's trained parameters in the port, packed m2xfp by the
    port, with the configs of the deployment story."""
    from repro_torch.models.model import pack_params_for_serving
    cfg = port_cfg("dense")
    params = port_tree(reference["sys_params"], cfg)
    scfg = dataclasses.replace(cfg, quant="serve")
    return cfg, params, scfg, pack_params_for_serving(params, scfg)


def test_trained_params_pack_to_reference_streams(reference, deployed):
    """The port's packing of the trained parameters is the reference's,
    byte for byte."""
    from test_torch_serve import _assert_same_tree
    cfg, _, _, packed = deployed
    _assert_same_tree(packed, port_tree(reference["sys"]["packed"], cfg))


def test_trained_losses_match_reference(reference, deployed):
    """``loss_fn`` of the trained model under none, serve (the packed
    m2xfp model) and qat/mxfp4 on test_system.py's held-out batch. Printed
    beside the reference's; test_system.py's inequality between them is
    not asserted (it fails in the reference, ROADMAP C)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model import loss_fn
    cfg, params, scfg, packed = deployed
    ev = port_batch(SyntheticLM(DataConfig(vocab=cfg.vocab_size,
                                           **EVAL_DATA)).batch_at(0))
    qcfg = dataclasses.replace(cfg, quant="qat", quant_format="mxfp4")
    with torch.no_grad():
        got = {"loss_none": float(loss_fn(params, cfg, ev)),
               "loss_serve": float(loss_fn(packed, scfg, ev)),
               "loss_qat_mxfp4": float(loss_fn(params, qcfg, ev))}
    print({k: (v, reference["sys"][k]) for k, v in got.items()})
    for k, v in got.items():
        assert abs(v - reference["sys"][k]) <= DEPLOY_LOSS_TOL, k


def test_trained_model_serves_reference_tokens(reference, deployed):
    """The port's engine on the packed trained model gives the reference
    engine's greedy tokens."""
    from repro_torch.serve.engine import ServeEngine
    _, _, scfg, packed = deployed
    eng = ServeEngine(packed, scfg, guard=False, device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == reference["sys"]["tokens"]


def test_cpu_weight_fake_quant_blocks_keep_values(monkeypatch):
    """The CPU's m2xfp weight fake-quant, taken in blocks of
    ``_CPU_ROWS`` rows (a last block short), gives the bits of the whole
    weight at once: each group's search sees only its own 32 values."""
    from repro_torch.core import m2xfp
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2 * m2xfp._CPU_ROWS + 37, 96)).astype(np.float32))
    w[3, :32] = 0.0
    w[5, 40] = -0.0
    blocked = m2xfp.quantize_weight_m2xfp(w)
    monkeypatch.setattr(m2xfp, "_CPU_ROWS", w.shape[0])
    assert torch.equal(blocked, m2xfp.quantize_weight_m2xfp(w))
