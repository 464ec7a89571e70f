"""The port's mixture-of-experts FFN (olmoe, mixtral) and embedding input
(the audio and vlm families: musicgen, pixtral) against the reference.

One child (the reference, as in test_torch_serve.py) builds each case's
dense and packed trees, saves each packed tree as a checkpoint, records
layer 0's ``moe_apply`` with its routing, per-position logits and caches,
and its engine's tokens. Cases: olmoe-smoke with 64 experts (its experts
are packed: the reference packs an expert weight only when E % 32 == 0),
olmoe-smoke as shipped (8 experts, dense), mixtral-smoke (4 experts, dense,
window 32), musicgen-smoke and pixtral-smoke (embedding input). For each:

(a) ``from_jax_tree`` of the reference's packed tree equals the port's
    ``prequantize_params`` of the converted dense tree, byte for byte, and
    the port's "meta" template has the reference's checkpoint leaves;
(b) ``moe_apply`` of layer 0 on 8 and on 64 tokens: the routing (top-k
    experts, queue positions, kept assignments) equal, the output within
    MOE_TOL;
(c) ``decode_step`` / ``prefill_chunk`` logits agree with the reference's
    per position (embedding models fed {"embeds"}; tolerances below), and
    the caches are equal;
(d) MoE engine tokens equal the reference engine's, with prefill chunks
    of 8 and of 1 (the two differ in the reference: a chunk's tokens route
    as one group, whose capacity drops other tokens than decode's);
(e) within the port, chunked prefill is bit-identical to decode where the
    reference has that property: dense FFNs, embedding input, and MoE at
    chunks of 1;
(f) a checkpoint the reference packed serves the reference's tokens, and
    the port's save of the same tree writes the reference's files;
(g) stream validation and repair on packed expert streams (layers, rows,
    E, N): reports, clamped bytes and ``load_packed_checkpoint``'s message
    equal the reference's.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_checkpoint import _assert_same_checkpoint
from test_torch_serve import (_assert_same_tree, _flatten,
                              check_prefill_chunk_bitexact_vs_decode,
                              run_reference_child)

# case -> (registry name, overrides of its smoke config)
CASES = {
    "olmoe-smoke-e64": ("olmoe-1b-7b", {"n_experts": 64}),
    "olmoe-smoke": ("olmoe-1b-7b", {}),
    "mixtral-smoke": ("mixtral-8x22b", {}),
    "musicgen-smoke": ("musicgen-large", {}),
    "pixtral-smoke": ("pixtral-12b", {}),
}
MOE_CASES = ["olmoe-smoke-e64", "olmoe-smoke", "mixtral-smoke"]
EMBED_CASES = ["musicgen-smoke", "pixtral-smoke"]
# (c): 12 positions in the engine's 8 slots and pages (the reference's
# jitted launches of (d) are reused), then one chunk of 8 with rows valid
# for LENGTHS positions
SEQ_T, LENGTHS = 12, np.array([8, 7, 5, 3, 8, 1, 0, 6])
# (b): layer 0's moe_apply on (8, 1, d) and (8, 8, d) tokens, the shapes of
# a decode step and of a prefill chunk of 8 over 8 slots
MOE_SHAPES = [(8, 1), (8, 8)]
# (d): 6 requests through 8 slots; a chunk of 8 routes 64 tokens per group
# (the smoke configs' moe_group_size), so capacities bind; mixtral-smoke's
# rings of 32 (its window) wrap for the longer requests
ENGINE = dict(n_slots=8, max_len=48, prefill_chunk=8)
PROMPT_LENS = (9, 23, 5, 17, 36, 12)
N_NEW = 6
# (c): logits of |l| < 1 agree to 2e-5 absolute -- f32 accumulation order
# (test_torch_serve.py's LOGIT_TOL)
LOGIT_TOL = dict(rtol=0.0, atol=2e-5)
# (c) with experts: each expert product's f32 sum (float64 in the port, f32
# in XLA's order in the reference) is rounded to bf16, three times a layer
# for every expert slot, so an output within an ulp of a bf16 rounding
# edge can flip and move a logit further. Every position is held to
# LOGIT_TOL, except at most FLIP_ROWS[(case, run)] positions (rows of
# logits), each within FLIP_TOL: measured, one row of the 96 in
# olmoe-smoke's decode off by 4.9e-4, every other row of every case and
# run within 1.2e-7. 2e-3 is the card-against-CPU tests' bound for such a
# flip (test_torch_gpu.py); a routing or masking fault moves logits by 0.1
# or more
FLIP_TOL = 2e-3
FLIP_ROWS = {("olmoe-smoke", "decode"): 1}
# (b): the port's expert products accumulate in float64 (on the CPU), the
# reference's in f32 in XLA's order, and each product's output is rounded
# to bf16 (gate, up, silu(gate) * up, down, the combined sum), so an output
# element may differ by a bf16 rounding flip of any of its inputs: within
# 2 bf16 ulps (2^-7 relative) of the larger magnitude, plus 2^-7 of the
# largest |output| for elements near zero
MOE_TOL_REL = 2.0 ** -7


def make_config(configs, case: str):
    arch, overrides = CASES[case]
    return configs.smoke_config(arch, quant="serve", **overrides)


def prompts(cfg) -> list:
    rng = np.random.default_rng(5)
    return [list(map(int, rng.integers(0, cfg.vocab_size, n)))
            for n in PROMPT_LENS]


def seq_inputs(cfg) -> np.ndarray:
    """(c)'s inputs: tokens (B, SEQ_T), or f32 embeddings (B, SEQ_T, d) of
    std 1 (taken to bf16 by both packages)."""
    rng = np.random.default_rng(11)
    b = ENGINE["n_slots"]
    if cfg.input_mode == "embeddings":
        return rng.standard_normal((b, SEQ_T, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, SEQ_T))


def wrapped_inputs(cfg):
    """A history of 40 tokens per slot (the ring of 32 wraps), then a chunk
    of 8 whose rows are valid for WRAPPED_LENGTHS positions."""
    rng = np.random.default_rng(12)
    b = ENGINE["n_slots"]
    return (rng.integers(0, cfg.vocab_size, (b, 40)),
            rng.integers(0, cfg.vocab_size, (b, 8)))


WRAPPED_LENGTHS = (8, 2, 5, 0, 8, 1, 3, 6)


def moe_input(cfg, shape) -> np.ndarray:
    """(b)'s input: f32 of std 1, (B, S, d) (taken to bf16 by both)."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    return rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# The reference, run in a child process (test_torch_serve.py's docstring)
# ---------------------------------------------------------------------------

def _reference_moe(p, x, cfg):
    """The reference's moe_apply on ``x`` with its routing (the first half
    of repro.models.moe.moe_apply, copied): [output, probs, top-k experts,
    queue positions, kept assignments], jitted as the model runs it."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import _capacity, moe_apply

    def run(p, x):
        b, s, d = x.shape
        e, topk = cfg.n_experts, cfg.experts_per_token
        g = min(cfg.moe_group_size, b * s)
        ng = (b * s) // g
        cap = _capacity(g, topk, e, cfg.moe_capacity_factor)
        xt = x.reshape(ng, g, d)
        logits = jnp.einsum("ngd,de->nge", xt.astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)
        _, top_i = jax.lax.top_k(probs, topk)
        onehot = jax.nn.one_hot(top_i, e, dtype=jnp.float32)
        flat = onehot.transpose(0, 2, 1, 3).reshape(ng, topk * g, e)
        pos_f = (jnp.cumsum(flat, axis=1) - flat) * flat
        pos = pos_f.reshape(ng, topk, g, e).transpose(0, 2, 1, 3)
        keep = (pos < cap).astype(jnp.float32) * onehot
        return moe_apply(p, x, cfg, cfg.quant), probs, top_i, pos, keep
    return [np.asarray(a) for a in jax.jit(run)(p, x)]


def _reference_case(cfg, root: str, case: str):
    """Returns (what the port's tests read, the packed tree)."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import init_caches, init_params
    from repro.serve import ServeEngine, prequantize_params
    from repro.serve.prequant import save_packed_checkpoint

    params = init_params(jax.random.PRNGKey(0), cfg)
    packed = prequantize_params(params, cfg)
    save_packed_checkpoint(os.path.join(root, case), packed, cfg)
    out = {"dense": _flatten(params), "packed": _flatten(packed)}
    embeds = cfg.input_mode == "embeddings"
    if cfg.is_moe:
        ffn0 = jax.tree.map(lambda a: a[0], packed["layers"]["ffn"])
        out["moe"] = {shape: _reference_moe(ffn0, jnp.asarray(
            moe_input(cfg, shape)).astype(jnp.bfloat16), cfg)
            for shape in MOE_SHAPES}
        out["tokens"] = {}
        for chunk in (1, 8):
            eng = ServeEngine(packed, cfg, guard=False,
                              **dict(ENGINE, prefill_chunk=chunk))
            out["tokens"][chunk] = eng.generate(prompts(cfg), N_NEW)
    else:
        # the reference's engine builds, and its first step fails
        eng = ServeEngine(packed, cfg, guard=False, **ENGINE)
        try:
            eng.generate(prompts(cfg), N_NEW)
            out["engine_error"] = None
        except Exception as e:             # noqa: BLE001 -- recorded
            out["engine_error"] = (type(e).__name__, str(e))
    # the engine's jitted decode_step and prefill_chunk (guard off), on
    # caches of its shapes: an MoE engine has compiled both for them
    step, prefill = eng._step, eng._prefill
    b, page = ENGINE["n_slots"], ENGINE["max_len"]
    seq = seq_inputs(cfg)

    def batch(a):
        return {"embeds": jnp.asarray(a).astype(jnp.bfloat16)} if embeds \
            else {"tokens": jnp.asarray(a, jnp.int32)}
    caches = init_caches(cfg, b, page, per_slot=True)
    logits = []
    for t in range(SEQ_T):
        lg, caches = step(packed, batch(seq[:, t:t + 1]), caches,
                          jnp.full((b,), t, jnp.int32))
        logits.append(np.asarray(lg[:, 0]))
    out["decode_logits"] = np.stack(logits, axis=1)
    out["decode_caches"] = _flatten(caches)
    lg, caches = prefill(packed, batch(seq[:, :ENGINE["prefill_chunk"]]),
                         init_caches(cfg, b, page, per_slot=True),
                         jnp.zeros((b,), jnp.int32),
                         jnp.asarray(LENGTHS, jnp.int32))
    out["prefill_logits"] = np.asarray(lg)
    out["prefill_caches"] = _flatten(caches)
    if cfg.sliding_window:
        hist, chunk = wrapped_inputs(cfg)
        caches = init_caches(cfg, b, page, per_slot=True)
        for t in range(hist.shape[1]):
            _, caches = step(packed, batch(hist[:, t:t + 1]), caches,
                             jnp.full((b,), t, jnp.int32))
        lg, _ = prefill(packed, batch(chunk), caches,
                        jnp.full((b,), hist.shape[1], jnp.int32),
                        jnp.asarray(WRAPPED_LENGTHS, jnp.int32))
        out["wrapped_prefill_logits"] = np.asarray(lg)
    return out, packed


def _reference_streams(root: str, packed, cfg) -> dict:
    """(g): a scale byte 255 planted in layer 1's packed gate experts; the
    reference's validation report, its clamp repair and its load message
    on a checkpoint of the damaged tree."""
    from repro.core.codecs import PackedTensor, validate_packed_tree
    from repro.serve.guard import verify_packed_tree
    from repro.serve.prequant import load_packed_checkpoint, \
        save_packed_checkpoint
    gate = packed["layers"]["ffn"]["gate"]
    scales = gate.streams["scales"].at[BAD_SCALE].set(255)
    damaged = dict(packed, layers=dict(
        packed["layers"], ffn=dict(packed["layers"]["ffn"], gate=PackedTensor(
            dict(gate.streams, scales=scales), gate.shape, gate.codec))))
    fixed, repairs = verify_packed_tree(damaged)
    path = os.path.join(root, "damaged")
    save_packed_checkpoint(path, damaged, cfg)
    try:
        load_packed_checkpoint(path, cfg, validate_streams=True)
        message = None
    except ValueError as e:
        message = str(e)
    return {"damaged": _flatten(damaged),
            "report": validate_packed_tree(damaged),
            "repairs": repairs, "fixed": _flatten(fixed),
            "load_message": message}


def _reference_packing_rule() -> dict:
    """Which expert counts the reference packs: {E: (packed?, gate leaf's
    logical shape)} on olmoe-smoke with E experts (shapes only)."""
    import jax
    from repro import configs
    from repro.core.codecs import PackedTensor
    from repro.models.model import init_params
    from repro.serve import prequantize_params
    out = {}
    for e in PACKING_RULE_EXPERTS:
        cfg = configs.smoke_config("olmoe-1b-7b", quant="serve", n_experts=e)
        gate = jax.eval_shape(lambda k: prequantize_params(
            init_params(k, cfg), cfg), jax.random.PRNGKey(0))[
            "layers"]["ffn"]["gate"]
        out[e] = (isinstance(gate, PackedTensor), tuple(gate.shape))
    return out


# (g): a flat index into the stacked (layers, K/32, E, N) scale stream
BAD_SCALE = (1, 0, 37, 5)
PACKING_RULE_EXPERTS = (16, 32, 96)     # the cases have 4, 8 and 64


def _reference_main(out_path: str) -> None:
    import pickle

    from repro import configs

    root = os.path.dirname(out_path)
    out = {"root": root, "packing_rule": _reference_packing_rule()}
    for case in CASES:
        cfg = make_config(configs, case)
        out[case], packed = _reference_case(cfg, root, case)
        if case == "olmoe-smoke-e64":
            out["streams"] = _reference_streams(root, packed, cfg)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's CPU ops are small (smoke models; 64 experts of 64 x 96
    at most): when the other test workers hold every core, the intra-op
    thread pool costs far more than it saves, so they run on one thread.
    The previous setting comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

def port_cfg(case: str):
    from repro_torch import configs
    return make_config(configs, case)


def _port_packed(reference, case):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference[case]["packed"], port_cfg(case), "cpu")


def _batch(cfg, a) -> dict:
    """Inputs as the port's model takes them: {"embeds": bf16} or
    {"tokens": int64}."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if cfg.input_mode == "embeddings":
        return {"embeds": t.to(torch.bfloat16)}
    return {"tokens": t.long()}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "musicgen-large", "pixtral-12b"])
def test_configs_are_the_references(arch):
    from repro import configs as ref_configs
    from repro_torch import configs
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(ref_configs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want
    assert arch in configs.ARCHS


def test_check_supported_rejects_only_the_recurrent_families():
    """Every family passes: the attention families, with experts and
    embedding input, and since the recurrent ones are ported (ROADMAP A9)
    ssm and hybrid too (tests/test_torch_recurrent.py serves them). What
    it still rejects is a configuration no package serves: a served codec
    without a packed path and a KV codec without a packed KV path, each
    raising ValueError naming the codecs that have one."""
    from repro_torch import configs
    from repro_torch.core.codecs import kv_codecs, list_codecs, \
        packed_codecs
    from repro_torch.models.model import check_supported
    for case in CASES:
        check_supported(port_cfg(case))
    for arch in ("xlstm-125m", "zamba2-7b"):
        check_supported(configs.smoke_config(arch, quant="serve"))
    base = port_cfg("olmoe-smoke")
    unpacked = next(c for c in list_codecs() if c not in packed_codecs())
    with pytest.raises(ValueError, match="packable codecs"):
        check_supported(dataclasses.replace(base, quant_format=unpacked))
    no_kv = next(c for c in list_codecs() if c not in kv_codecs())
    with pytest.raises(ValueError, match="KV-capable codecs"):
        check_supported(dataclasses.replace(base, kv_quant=no_kv))


def test_experts_packed_only_when_e_is_a_multiple_of_32(reference):
    """The reference's rule, pinned on both packages: after the expert
    weights are laid out contraction first, (K, E, N), the packer tests
    the second-to-last axis, which is E; so experts are packed, with
    (rows, E, N) streams, only when E % 32 == 0, and otherwise stay dense
    (E, K, N) bf16."""
    from repro_torch import configs
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.serve.prequant import init_packed_params
    want = reference["packing_rule"]
    for e, (packed, shape) in want.items():
        assert packed == (e % 32 == 0), e
        cfg = configs.smoke_config("olmoe-1b-7b", quant="serve", n_experts=e)
        gate = init_packed_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")["layers"][0]["ffn"]["gate"]
        assert isinstance(gate, PackedTensor) == packed, e
        assert tuple(gate.shape) == shape[-3:], e
        if packed:
            assert gate["codes"].shape == (cfg.d_model // 2, e, cfg.d_ff)
            assert gate["scales"].shape == (cfg.d_model // 32, e, cfg.d_ff)
        else:
            assert gate.dtype == torch.bfloat16


@pytest.mark.parametrize("case", EMBED_CASES)
def test_engine_refuses_embedding_input(reference, case):
    """The reference's engine builds for an embedding-input model and its
    first step fails (its launches pass token ids); the port's refuses at
    construction, naming the model-level entry points."""
    from repro_torch.serve.engine import ServeEngine
    assert reference[case]["engine_error"] == ("KeyError", "'embeds'")
    with pytest.raises(NotImplementedError, match="decode_step and "
                       "prefill_chunk take"):
        ServeEngine(_port_packed(reference, case), port_cfg(case),
                    device="cpu")


# ---------------------------------------------------------------------------
# (a) weights and templates carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_from_jax_tree_packed_equals_port_prequant(reference, case):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import prequantize_params
    cfg = port_cfg(case)
    dense = from_jax_tree(reference[case]["dense"], cfg, "cpu")
    packed = _port_packed(reference, case)
    _assert_same_tree(packed, prequantize_params(dense, cfg))
    ffn = packed["layers"][0]["ffn"]
    if cfg.is_moe:
        assert ffn["router"].dtype == torch.float32
        assert ffn["router"].shape == (cfg.d_model, cfg.n_experts)


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
           for k, t in flat_leaves(packed_template(port_cfg(case))).items()]
    assert got == want


# ---------------------------------------------------------------------------
# (b) moe_apply and its routing
# ---------------------------------------------------------------------------

def assert_moe_close(got: np.ndarray, want: np.ndarray) -> None:
    """MOE_TOL_REL (its comment above)."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    scale = np.maximum(np.abs(got), np.abs(want))
    bound = MOE_TOL_REL * (scale + np.abs(want).max())
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) / bound).max())


def top_k_gap(probs: np.ndarray, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    p = -np.sort(-probs, axis=-1)
    return float((p[..., k - 1] - p[..., k]).min())


@pytest.mark.parametrize("shape", MOE_SHAPES)
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_apply_matches_reference(reference, case, shape):
    """Layer 0's moe_apply: the top-k experts, queue positions and kept
    assignments equal the reference's (its XLA f32 router and softmax
    differ from the port's in the last ulps; the smallest gap between a
    token's k-th and (k+1)-th probability is far above that); the output
    within MOE_TOL_REL. At 64 tokens olmoe-smoke's capacity binds: one
    assignment is dropped."""
    from repro_torch.models.moe import _capacity, moe_apply, route
    cfg = port_cfg(case)
    ffn = _port_packed(reference, case)["layers"][0]["ffn"]
    x = torch.from_numpy(moe_input(cfg, shape)).to(torch.bfloat16)
    y, probs, top_i, pos, keep = reference[case]["moe"][shape]
    assert top_k_gap(probs, cfg.experts_per_token) > 1e-6
    g = min(cfg.moe_group_size, x.shape[0] * x.shape[1])
    cap = _capacity(g, cfg.experts_per_token, cfg.n_experts,
                    cfg.moe_capacity_factor)
    _, got_i, _, got_pos, got_keep = route(
        ffn["router"], x.reshape(-1, g, cfg.d_model), cfg.experts_per_token,
        cap)
    np.testing.assert_array_equal(got_i.numpy(), top_i)
    np.testing.assert_array_equal(got_pos.numpy(), pos)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    out = moe_apply(ffn, x, cfg, cfg.quant)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert_moe_close(out.float().numpy(), y.astype(np.float32))
    dropped = int(np.prod(keep.shape[:3]) - keep.sum())
    assert dropped == (1 if (case, shape) == ("olmoe-smoke", (8, 8)) else 0)


def test_moe_tolerance_sees_a_dropped_expert(reference):
    """MOE_TOL_REL is tight enough to see one expert's share: zeroing
    layer 0's expert 0 in the down projection moves the output out of it
    (olmoe-smoke, 64 tokens)."""
    from repro_torch.models.moe import moe_apply
    cfg = port_cfg("olmoe-smoke")
    ffn = dict(_port_packed(reference, "olmoe-smoke")["layers"][0]["ffn"])
    ffn["down"] = ffn["down"].clone()
    ffn["down"][0] = 0
    x = torch.from_numpy(moe_input(cfg, (8, 8))).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        assert_moe_close(moe_apply(ffn, x, cfg, cfg.quant).float().numpy(),
                         reference["olmoe-smoke"]["moe"][(8, 8)][0])


def test_dispatch_turns_negative_zero_positive():
    """Dispatch is the reference's one-hot contraction: a token's -0.0
    reaches its expert as +0.0, an empty capacity slot is +0.0, and a
    token's NaN reaches that column of every expert slot of its group
    (0 * NaN), so through the experts and the combine every token of the
    group, as in the reference."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.numerics import einsum_f32acc
    disp = torch.zeros(1, 2, 2, 3, dtype=torch.bfloat16)
    disp[0, 0, 1, 0] = 1
    disp[0, 1, 0, 2] = 1
    x = torch.tensor([[[-0.0, -1.0], [2.0, -0.0]]], dtype=torch.bfloat16)
    xe = einsum_f32acc("ngec,ngd->necd", disp, x)
    assert torch.equal(xe[0, 1, 0], torch.tensor([0.0, -1.0]))
    assert not torch.signbit(xe[0, 1, 0, 0])
    assert not torch.signbit(xe[0, 0, 2, 1])
    assert not torch.signbit(xe[xe == 0]).any()
    x[0, 1, 0] = float("nan")
    xe = einsum_f32acc("ngec,ngd->necd", disp, x)
    assert torch.isnan(xe[..., 0]).all() and not torch.isnan(xe[..., 1]).any()
    cfg = port_cfg("olmoe-smoke")
    from repro_torch.models.moe import init_moe
    p = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    h = torch.randn(1, 4, cfg.d_model).to(torch.bfloat16)
    h[0, 2, 5] = float("nan")
    out = moe_apply(p, h, dataclasses.replace(cfg, quant="none"))
    assert torch.isnan(out).any(dim=-1).all()


# ---------------------------------------------------------------------------
# (c) logits and caches against the reference
# ---------------------------------------------------------------------------

def _bits_np(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_caches_equal(port: dict, ref_caches: dict) -> None:
    want = ref_caches["layers"]
    for i, layer in enumerate(port["layers"]):
        for name, t in layer.items():
            w = want[name][i]
            assert tuple(t.shape) == w.shape, (i, name)
            np.testing.assert_array_equal(
                t.contiguous().view(torch.uint8).numpy(), _bits_np(w),
                err_msg=f"layer {i} {name}")


def _caches(cfg):
    from repro_torch.models.model import init_caches
    return init_caches(cfg, ENGINE["n_slots"], ENGINE["max_len"], "cpu")


def _decode_seq(params, cfg):
    from repro_torch.models.model import decode_step
    caches = _caches(cfg)
    seq = seq_inputs(cfg)
    out = [decode_step(params, cfg, _batch(cfg, seq[:, t:t + 1]), caches,
                       torch.full((seq.shape[0],), t))[:, 0]
           for t in range(SEQ_T)]
    return torch.stack(out, 1).numpy(), caches


def _assert_logits_agree(got: np.ndarray, want: np.ndarray,
                         flips: int) -> None:
    """Every row (position) of ``got`` within LOGIT_TOL of ``want``, except
    at most ``flips`` rows, which must be within FLIP_TOL."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=FLIP_TOL)
    err = np.abs(got - want).reshape(-1, got.shape[-1]).max(axis=-1)
    off = np.flatnonzero(err > LOGIT_TOL["atol"])
    assert len(off) <= flips, (
        f"{len(off)} rows beyond {LOGIT_TOL['atol']} (at most {flips} "
        f"allowed): rows {off.tolist()}, errors {err[off].tolist()}")


@pytest.mark.parametrize("case", CASES)
def test_decode_and_prefill_match_reference(reference, case):
    from repro_torch.models.model import prefill_chunk
    ref = reference[case]
    cfg = port_cfg(case)
    params = _port_packed(reference, case)
    logits, caches = _decode_seq(params, cfg)
    _assert_logits_agree(logits, ref["decode_logits"],
                         FLIP_ROWS.get((case, "decode"), 0))
    _assert_caches_equal(caches, ref["decode_caches"])
    caches = _caches(cfg)
    seq = seq_inputs(cfg)[:, :ENGINE["prefill_chunk"]]
    got = prefill_chunk(params, cfg, _batch(cfg, seq), caches,
                        torch.zeros(len(seq), dtype=torch.long),
                        torch.from_numpy(LENGTHS)).numpy()
    valid = np.arange(got.shape[1])[None] < LENGTHS[:, None]
    _assert_logits_agree(got[valid], ref["prefill_logits"][valid],
                         FLIP_ROWS.get((case, "prefill"), 0))
    _assert_caches_equal(caches, ref["prefill_caches"])


def test_padding_rows_match_reference_on_a_wrapped_ring(reference):
    """The rows of a prefill chunk past a slot's length are garbage to
    discard, but a MoE layer routes them with the valid rows, so their
    capacity use must be the reference's. mixtral-smoke, rings of 32 (its
    window) after 40 tokens in 8 slots, then a chunk of 8 whose rows are
    valid for 8, 2, 5, 0, ... positions: every position's logits, padding
    included, agree with the reference's. A
    padding row's position runs past the ring's newest entry, so without
    the window mask (a key at most ``window - 1`` back) it would attend to
    keys that the reference masks."""
    from repro_torch.models.model import decode_step, prefill_chunk
    cfg = port_cfg("mixtral-smoke")
    params = _port_packed(reference, "mixtral-smoke")
    hist, chunk = wrapped_inputs(cfg)
    b = len(hist)
    caches = _caches(cfg)
    assert caches["layers"][0]["pos"].shape[1] == cfg.sliding_window
    for t in range(hist.shape[1]):
        decode_step(params, cfg, _batch(cfg, hist[:, t:t + 1]), caches,
                    torch.full((b,), t))
    got = prefill_chunk(params, cfg, _batch(cfg, chunk), caches,
                        torch.full((b,), hist.shape[1]),
                        torch.tensor(WRAPPED_LENGTHS)).numpy()
    _assert_logits_agree(
        got, reference["mixtral-smoke"]["wrapped_prefill_logits"],
        FLIP_ROWS.get(("mixtral-smoke", "wrapped"), 0))


# ---------------------------------------------------------------------------
# (d) engine tokens against the reference engine
# ---------------------------------------------------------------------------

def _serve(params, cfg, chunk: int) -> list:
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, device="cpu",
                      **dict(ENGINE, prefill_chunk=chunk))
    out = eng.generate(prompts(cfg), N_NEW)
    eng.scheduler.check()
    assert eng.stats.generated_tokens == N_NEW * len(PROMPT_LENS)
    return out


@pytest.mark.parametrize("chunk", [8, 1])
@pytest.mark.parametrize("case", MOE_CASES)
def test_engine_tokens_match_reference(reference, case, chunk):
    assert _serve(_port_packed(reference, case), port_cfg(case), chunk) == \
        reference[case]["tokens"][chunk]


def test_reference_moe_chunks_differ_from_decode(reference):
    """The reference behaviour (d) allows for: with experts, a prefill
    chunk's tokens route as one group, so chunks of 8 and of 1 give
    different tokens for some request of the dense-expert smoke models."""
    for case in ("olmoe-smoke", "mixtral-smoke"):
        tokens = reference[case]["tokens"]
        assert tokens[8] != tokens[1], case


# ---------------------------------------------------------------------------
# (e) chunked prefill == sequential decode, within the port
# ---------------------------------------------------------------------------

BITEXACT_CASES = [(case, chunk, lengths)
                  for case in CASES
                  for chunk, lengths in ([(1, (1, 1, 1))] if case in MOE_CASES
                                         else [(3, (3, 3, 3)),
                                               (8, (8, 3, 0))])]


@pytest.mark.parametrize("case,chunk,lengths", BITEXACT_CASES)
def test_prefill_chunk_bitexact_vs_decode(case, chunk, lengths):
    """test_torch_serve.py's check where the reference has the property:
    a chunk of 1 for MoE, ragged chunks of 3 and 8 for embedding input."""
    check_prefill_chunk_bitexact_vs_decode(port_cfg(case), chunk, lengths)


# ---------------------------------------------------------------------------
# (f) checkpoints both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_reference_checkpoint_loads_and_serves(reference, case, tmp_path):
    """The port restores the checkpoint the reference packed to the same
    tree; an MoE model serves it with the reference engine's tokens."""
    import shutil
    from repro_torch.serve.prequant import load_packed_checkpoint
    cfg = port_cfg(case)
    src = str(tmp_path / case)
    shutil.copytree(os.path.join(reference["root"], case), src)
    params, extra = load_packed_checkpoint(src, cfg, device="cpu",
                                           validate_streams=True)
    assert extra["model"] == cfg.name
    _assert_same_tree(params, _port_packed(reference, case))
    if cfg.is_moe:
        assert _serve(params, cfg, 8) == reference[case]["tokens"][8]


@pytest.mark.parametrize("case", CASES)
def test_port_save_writes_reference_checkpoint(reference, case, tmp_path):
    from repro_torch.serve.prequant import save_packed_checkpoint
    save_packed_checkpoint(str(tmp_path / case),
                           _port_packed(reference, case), port_cfg(case))
    _assert_same_checkpoint(str(tmp_path / case),
                            os.path.join(reference["root"], case))


# ---------------------------------------------------------------------------
# (g) stream validation and repair on expert streams
# ---------------------------------------------------------------------------

def test_validate_and_verify_expert_streams(reference):
    """A scale byte 255 in layer 1's packed gate experts: the port's
    validate_packed_tree reports it as the reference does (the index runs
    over (layer, row, expert, column)), verify_packed_tree clamps it to
    the reference's bytes, and load_packed_checkpoint(validate_streams=True)
    refuses a checkpoint of it with the reference's message."""
    from repro_torch.convert import from_jax_tree
    from repro_torch.core.codecs import validate_packed_tree
    from repro_torch.serve.guard import verify_packed_tree
    from repro_torch.serve.prequant import load_packed_checkpoint
    cfg = port_cfg("olmoe-smoke-e64")
    want = reference["streams"]
    damaged = from_jax_tree(want["damaged"], cfg, "cpu")
    report = validate_packed_tree(damaged)
    assert report == want["report"]
    assert str(BAD_SCALE) in report["layers/ffn/gate"][0]
    fixed, repairs = verify_packed_tree(damaged)
    assert repairs == want["repairs"] == [("layers/ffn/gate", "clamp")]
    _assert_same_tree(fixed, from_jax_tree(want["fixed"], cfg, "cpu"))
    assert not validate_packed_tree(fixed)
    with pytest.raises(ValueError) as err:
        load_packed_checkpoint(os.path.join(reference["root"], "damaged"),
                               cfg, device="cpu", validate_streams=True)
    assert str(err.value) == want["load_message"]


if __name__ == "__main__":
    _reference_main(sys.argv[1])
