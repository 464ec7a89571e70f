"""The port's attention variants against the reference: QKV bias
(qwen2-0.5b, qwen2.5), qk-norm (qwen3), tied embeddings (qwen2-0.5b,
gemma2), local/global layers with sliding windows and both soft-caps
(gemma2), and sliding windows alone (the serve tests' model with a window
of 4, and of 6 with an m2xfp-packed KV cache).

One child (the reference, as in test_torch_serve.py) builds every case's
dense and packed trees, saves each packed tree as a checkpoint, runs its
engine and records per-position logits and caches. Its dense trees carry
seeded QKV biases and qk-norm weights (``repro_torch.testing.
attention_extras``), not the zeros and ones that initialisation draws, so
that each of them moves the logits. For each case:

(a) ``from_jax_tree`` of the reference's packed tree equals the port's
    ``prequantize_params`` of the converted dense tree, byte for byte, and
    the port's "meta" template has the reference's checkpoint leaves;
(b) ``decode_step`` / ``prefill_chunk`` logits agree with the reference's
    per position (tolerances below), with a window on pages the sequence
    wraps, and the caches are equal after mapping the reference's
    ``{"local", "global"}`` stacks to the port's list (layer 2i is local i,
    2i+1 is global i);
(c) the engine's greedy tokens equal the reference engine's: exactly for
    the configurations without soft-caps, and for gemma2 at every position
    whose top-2 logit margin in the reference exceeds the logit tolerance
    (a request is compared up to its first near-tie);
(d) within the port, chunked prefill is bit-identical to decode;
(e) a checkpoint the reference packed serves the reference's tokens, and
    the port's save of the same tree writes the reference's files.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_checkpoint import _assert_same_checkpoint
from test_torch_serve import (CHUNKS, N_NEW, PROMPTS, _assert_same_tree,
                              _flatten, check_prefill_chunk_bitexact_vs_decode,
                              run_reference_child)

# the serve tests' model (tests/test_serve.py::_cfg)
BASE = dict(name="serve-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=97, remat=False)
# case -> (registry name of the smoke config, or None for BASE; overrides)
CASES = {
    "qwen2-0.5b-smoke": ("qwen2-0.5b", {}),
    "qwen2.5-smoke": ("qwen2.5-14b", {}),
    "qwen3-smoke": ("qwen3-8b", {}),
    "gemma2-smoke": ("gemma2-9b", {}),
    "window4": (None, {"sliding_window": 4}),
    "window6-kvq": (None, {"sliding_window": 6, "kv_quant": "m2xfp"}),
}
# (b): 12 positions; row 1 of the chunk ends after LENGTHS[1] tokens
SEQ = np.random.default_rng(11).integers(0, 97, (2, 12))
LENGTHS = np.array([12, 7])
# (b), without soft-caps: logits of |l| < 1 agree to 2e-5 absolute -- f32
# accumulation order only (test_torch_serve.py's LOGIT_TOL)
LOGIT_TOL = dict(rtol=0.0, atol=2e-5)


def page(cfg) -> int:
    """Positions per page (``max_len``) in (b), (c) and (e). With a window,
    8: SEQ and the 9-token prompt plus 6 new tokens wrap every ring (the
    engine admits such a prompt: the reference's rule for sliding-window
    configurations); else 16, which holds them."""
    return 8 if cfg.sliding_window else 16


def engine_kw(cfg) -> dict:
    return dict(n_slots=2, max_len=page(cfg), prefill_chunk=4)


def make_config(configs, model_config, case: str):
    """The case's configuration from a package's ``configs`` module and
    its ``ModelConfig`` class (the reference's or the port's)."""
    arch, overrides = CASES[case]
    cfg = model_config(**BASE) if arch is None else \
        configs.smoke_config(arch)
    return dataclasses.replace(cfg, quant="serve", **overrides)


# ---------------------------------------------------------------------------
# The reference, run in a child process (test_torch_serve.py's docstring)
# ---------------------------------------------------------------------------

def _margin_recorder(eng, margins: dict):
    """A greedy ``sample_fn`` for the reference engine ``eng`` that records
    each row's top-2 logit margin under (request id, tokens it had output
    before this step): the last write under a key is the step that sampled
    that token."""
    def sample(logits):
        top2 = np.sort(logits, axis=-1)[:, -2:]
        for slot, req in eng.scheduler.active.items():
            margins[(req.rid, len(req.output))] = float(
                top2[slot, 1] - top2[slot, 0])
        return np.argmax(logits, axis=-1).astype(np.int32)
    return sample


def _reference_case(cfg, root: str, case: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models.model import init_caches, init_params, prefill_chunk
    from repro.serve import ServeEngine, prequantize_params
    from repro.serve.prequant import save_packed_checkpoint

    from repro_torch.testing import attention_extras
    params = init_params(jax.random.PRNGKey(0), cfg)
    attn = params["layers"]["attn"]                 # stacked over layers
    for name, values in attention_extras(cfg).items():
        attn[name] = jnp.asarray(values).astype(attn[name].dtype)
    packed = prequantize_params(params, cfg)
    save_packed_checkpoint(os.path.join(root, case), packed, cfg)
    out = {"dense": _flatten(params), "packed": _flatten(packed),
           "margins": {}}
    eng = ServeEngine(packed, cfg, guard=False, **engine_kw(cfg))
    eng.sample_fn = _margin_recorder(eng, out["margins"])
    out["tokens"] = eng.generate(PROMPTS, N_NEW)
    # the engine's jitted decode_step (guard off), on caches of its shapes
    caches = init_caches(cfg, 2, page(cfg), per_slot=True)
    seq = []
    for t in range(SEQ.shape[1]):
        lg, caches = eng._step(
            packed, {"tokens": jnp.asarray(SEQ[:, t:t + 1], jnp.int32)},
            caches, jnp.full((2,), t, jnp.int32))
        seq.append(np.asarray(lg[:, 0]))
    out["decode_logits"] = np.stack(seq, axis=1)             # (B, T, V)
    out["decode_caches"] = _flatten(caches)
    chunk = jax.jit(lambda p, b, c, i, n: prefill_chunk(p, cfg, b, c, i, n))
    lg, caches = chunk(packed, {"tokens": jnp.asarray(SEQ)},
                       init_caches(cfg, 2, page(cfg), per_slot=True),
                       jnp.zeros((2,), jnp.int32),
                       jnp.asarray(LENGTHS, jnp.int32))
    out["prefill_logits"] = np.asarray(lg)
    out["prefill_caches"] = _flatten(caches)
    return out


def _reference_softcap() -> dict:
    """The reference's ``softcap`` on ``softcap_input()``, jitted (as the
    model runs it) and op by op, for each cap."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import softcap
    x = jnp.asarray(softcap_input())
    out = {}
    for cap in (30.0, 50.0):
        out[f"jit_{cap}"] = np.asarray(jax.jit(
            lambda a, c=cap: softcap(a, c))(x))
        with jax.disable_jit():
            out[f"eager_{cap}"] = np.asarray(softcap(x, cap))
    return out


def _reference_main(out_path: str) -> None:
    import pickle

    from repro import configs
    from repro.models.config import ModelConfig

    root = os.path.dirname(out_path)
    out = {"root": root, "softcap": _reference_softcap()}
    for case in CASES:
        out[case] = _reference_case(make_config(configs, ModelConfig, case),
                                    root, case)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


def softcap_input() -> np.ndarray:
    """f32 scores and logits from -200 to 200, dense near 0 and near the
    caps, and a log-spaced sweep of small magnitudes."""
    rng = np.random.default_rng(7)
    parts = [rng.standard_normal(4096) * s for s in (0.1, 1.0, 10.0, 60.0)]
    parts.append(np.geomspace(1e-6, 200.0, 2048))
    x = np.concatenate(parts + [-parts[-1]])
    return x.astype(np.float32)


def port_cfg(case: str):
    from repro_torch import configs
    from repro_torch.models.config import ModelConfig
    return make_config(configs, ModelConfig, case)


def _port_packed(reference, case):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference[case]["packed"], port_cfg(case), "cpu")


def _ref_cache_layers(ref_caches: dict, n_layers: int) -> list:
    """The reference's caches as the port's list of per-layer dicts of
    numpy leaves: ``{"layers": stacked}``, or under local/global layer 2i
    from ``local`` i and 2i+1 from ``global`` i."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]
    if "local" in ref_caches:
        return [take(ref_caches["global" if i % 2 else "local"], i // 2)
                for i in range(n_layers)]
    return [take(ref_caches["layers"], i) for i in range(n_layers)]


def _bits_np(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_caches_equal(port: dict, ref_caches: dict) -> None:
    """Every page stream and position track byte for byte."""
    want = _ref_cache_layers(ref_caches, len(port["layers"]))
    for i, (layer, ref_layer) in enumerate(zip(port["layers"], want)):
        assert sorted(layer) == sorted(ref_layer), i
        for name, buf in layer.items():
            streams = buf if isinstance(buf, dict) else {"": buf}
            for s, t in streams.items():
                w = ref_layer[name][s] if s else ref_layer[name]
                assert tuple(t.shape) == w.shape, (i, name, s)
                np.testing.assert_array_equal(
                    t.contiguous().view(torch.uint8).numpy(), _bits_np(w),
                    err_msg=f"layer {i} {name} {s}")


# ---------------------------------------------------------------------------
# Soft-caps: the port divides and calls PyTorch's tanh
# ---------------------------------------------------------------------------

# XLA's CPU tanh is its own approximation, not libm's, and its jit rewrites
# ``x / cap`` into ``x * fl(1/cap)`` (ROADMAP C). The port's softcap differs
# from the reference's by at most SOFTCAP_ULPS units in the last place of
# the result: the two tanh errors (a few ulps for XLA's, one for
# PyTorch's), one ulp of the argument from the rewrite (the slope of
# cap * tanh(x / cap) is at most 1) and the product's rounding. Measured:
# at most 4 ulps at cap 30, 5 at cap 50.
SOFTCAP_ULPS = 8
# (b) and (c) with soft-caps: LOGIT_TOL for the summation order, plus
# SOFTCAP_ULPS ulps of the largest capped value, |cap * tanh| < cap (the
# attention cap's difference moves a probability by less, and passes
# through the same bf16 roundings on both sides)
SOFTCAP_LOGIT_ATOL = LOGIT_TOL["atol"] + SOFTCAP_ULPS * float(
    np.spacing(np.float32(30.0)))


def logit_atol(cfg) -> float:
    return SOFTCAP_LOGIT_ATOL if cfg.final_softcap or cfg.attn_softcap \
        else LOGIT_TOL["atol"]


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap_within_ulps_of_reference(reference, cap):
    """The op-level difference: the port's softcap against the reference's,
    jitted and op by op, within SOFTCAP_ULPS ulps of the result, and not
    bit-identical (else the tolerance would not be needed)."""
    from repro_torch.models.layers import softcap
    got = softcap(torch.from_numpy(softcap_input()), cap).numpy()
    for mode in ("jit", "eager"):
        want = reference["softcap"][f"{mode}_{cap}"]
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= SOFTCAP_ULPS, (mode, ulps.max())
        assert (got != want).any(), mode


def test_softcap_none_bf16_and_division():
    """cap None is the identity; a bf16 input comes back bf16, capped in
    f32; the argument is x / cap correctly rounded (not x * fl(1/cap))."""
    from repro_torch.models.layers import softcap
    x = torch.tensor([0.0, 1.0, -7.5, 300.0, -1e30])
    assert softcap(x, None) is x
    xb = x.to(torch.bfloat16)
    got = softcap(xb, 50.0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (50.0 * torch.tanh(
        xb.float() / torch.tensor(50.0))).to(torch.bfloat16))
    assert float(softcap(x, 50.0).abs().max()) <= 50.0
    # an argument where x * fl(1/30) and x / 30 round apart
    x = torch.arange(1, 20001, dtype=torch.float32) * 0.37
    div = x / torch.tensor(30.0)
    mul = x * torch.tensor(1 / 30, dtype=torch.float32)
    assert not torch.equal(div, mul)
    assert torch.equal(softcap(x, 30.0), 30.0 * torch.tanh(div))


# ---------------------------------------------------------------------------
# Configurations, windows and check_supported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2.5-14b", "qwen3-8b",
                                  "gemma2-9b"])
def test_configs_are_the_references(arch):
    from repro import configs as ref_configs
    from repro_torch import configs
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(ref_configs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want
    assert arch in configs.ARCHS


@pytest.mark.parametrize("arch,overrides", [
    ("gemma2-9b", {}), ("gemma2-9b", {"sliding_window": None}),
    ("qwen3-8b", {}), ("qwen3-8b", {"sliding_window": 512}),
    ("gemma2-9b", {"n_layers": 5}),
])
def test_layer_windows_match_reference(arch, overrides):
    """The port's per-layer windows are the reference's (0 = global), as
    plain ints."""
    from repro import configs as ref_configs
    from repro.models.model import layer_windows as ref_windows
    from repro_torch import configs
    from repro_torch.models.model import layer_windows
    want = np.asarray(ref_windows(ref_configs.get_config(arch, **overrides)))
    got = layer_windows(configs.get_config(arch, **overrides))
    assert all(type(w) is int for w in got)
    assert got == want.tolist()


def test_init_caches_ring_per_layer_window():
    """gemma2-9b's pages: local layers min(4096, max_len) positions, global
    layers max_len (on the "meta" device: shapes only)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    for kv_quant in ("none", "m2xfp"):
        cfg = get_config("gemma2-9b", kv_quant=kv_quant)
        for max_len, local in ((8192, 4096), (128, 128)):
            caches = init_caches(cfg, 8, max_len, "meta")
            widths = [layer["pos"].shape[1] for layer in caches["layers"]]
            assert widths == [local, max_len] * 21
            k = caches["layers"][0]["k"]
            k = k["codes"] if kv_quant != "none" else k
            assert k.shape[:3] == (8, local, 8)


def test_check_supported_accepts_the_variants():
    """All seven variant features at once are served; what the port still
    refuses (chunked prefill of the recurrent families, and embedding
    input in the engine) raises NotImplementedError (test_torch_serve.py's
    test_unsupported_config_raises has each)."""
    from repro_torch.models.model import check_supported
    cfg = dataclasses.replace(
        port_cfg("window4"), qkv_bias=True, qk_norm=True,
        tie_embeddings=True, local_global=True, attn_softcap=50.0,
        final_softcap=30.0)
    check_supported(cfg)
    from repro_torch.serve.prequant import init_packed_params
    params = init_packed_params(torch.Generator().manual_seed(1), cfg, "cpu")
    assert "lm_head" not in params
    assert sorted(params["layers"][0]["attn"]) == [
        "bk", "bq", "bv", "k_norm", "q_norm", "wk", "wo", "wq", "wv"]


# ---------------------------------------------------------------------------
# (a) weights and templates carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_from_jax_tree_packed_equals_port_prequant(reference, case):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import prequantize_params
    cfg = port_cfg(case)
    dense = from_jax_tree(reference[case]["dense"], cfg, "cpu")
    assert ("lm_head" in dense) == (not cfg.tie_embeddings)
    packed = _port_packed(reference, case)
    _assert_same_tree(packed, prequantize_params(dense, cfg))
    attn = packed["layers"][0]["attn"]
    if cfg.qkv_bias:                 # the seeded biases, not init's zeros
        assert attn["bq"].dtype == torch.bfloat16
        for name, std in (("bq", 0.5), ("bk", 1.0), ("bv", 0.25)):
            assert 0.5 * std < float(attn[name].float().std()) < 2 * std
    if cfg.qk_norm:                  # and the seeded norm weights, not ones
        assert attn["q_norm"].dtype == torch.float32
        assert float(attn["q_norm"].min()) >= 0.5
        assert float(attn["k_norm"].max()) <= 0.75


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
# (b) logits and caches against the reference
# ---------------------------------------------------------------------------

def _decode_seq(params, cfg):
    """The port's decode_step over SEQ on fresh caches: logits (B, T, V)
    and the caches after the last position."""
    from repro_torch.models.model import decode_step, init_caches
    caches = init_caches(cfg, 2, page(cfg), "cpu")
    tokens = torch.from_numpy(SEQ)
    seq = [decode_step(params, cfg, {"tokens": tokens[:, t:t + 1]}, caches,
                       torch.full((2,), t))[:, 0]
           for t in range(SEQ.shape[1])]
    return torch.stack(seq, 1).numpy(), caches


@pytest.mark.parametrize("case", CASES)
def test_decode_and_prefill_match_reference(reference, case):
    from repro_torch.models.model import init_caches, prefill_chunk
    ref = reference[case]
    cfg = port_cfg(case)
    tol = dict(rtol=0.0, atol=logit_atol(cfg))
    params = _port_packed(reference, case)
    logits, caches = _decode_seq(params, cfg)
    np.testing.assert_allclose(logits, ref["decode_logits"], **tol)
    _assert_caches_equal(caches, ref["decode_caches"])
    caches = init_caches(cfg, 2, page(cfg), "cpu")
    tokens = torch.from_numpy(SEQ)
    got = prefill_chunk(params, cfg, {"tokens": tokens}, caches,
                        torch.zeros(2, dtype=torch.long),
                        torch.from_numpy(LENGTHS)).numpy()
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n], ref["prefill_logits"][b, :n],
                                   **tol)
    _assert_caches_equal(caches, ref["prefill_caches"])


def _swap(attn: dict, a: str, b: str) -> None:
    attn[a], attn[b] = attn[b], attn[a]


# One seeded leaf dropped (init's constant back) or two of one shape
# swapped, in every layer
MUTATIONS = {
    "drop_bq": lambda attn: attn["bq"].zero_(),
    "drop_bv": lambda attn: attn["bv"].zero_(),
    "swap_bk_bv": lambda attn: _swap(attn, "bk", "bv"),
    "ones_q_norm": lambda attn: attn["q_norm"].fill_(1.0),
    "swap_q_k_norm": lambda attn: _swap(attn, "q_norm", "k_norm"),
}


@pytest.mark.parametrize("case,mutation", [
    ("qwen2-0.5b-smoke", "drop_bq"), ("qwen2-0.5b-smoke", "swap_bk_bv"),
    ("qwen2.5-smoke", "drop_bv"), ("qwen3-smoke", "ones_q_norm"),
    ("qwen3-smoke", "swap_q_k_norm"),
])
def test_decode_catches_a_wrong_bias_or_norm_weight(reference, case,
                                                    mutation):
    """(b) sees the seeded leaves: with one of them dropped or two swapped,
    the port's decode logits leave the tolerance of the reference's by
    more than 100x."""
    cfg = port_cfg(case)
    params = _port_packed(reference, case)
    for lp in params["layers"]:
        MUTATIONS[mutation](lp["attn"])
    logits, _ = _decode_seq(params, cfg)
    diff = np.abs(logits - reference[case]["decode_logits"]).max()
    assert diff > 100 * logit_atol(cfg), diff


# ---------------------------------------------------------------------------
# (c) engine tokens against the reference engine
# ---------------------------------------------------------------------------

def assert_tokens_match(got: list, ref: dict, cfg) -> int:
    """``got`` (the port's outputs, in submission order) against the
    reference engine's tokens: equal, or under a soft-cap equal up to each
    request's first position whose reference top-2 margin is at most the
    logit tolerance (a near-tie either package may break either way; the
    request diverges after it). Returns the number of requests cut at a
    near-tie."""
    if not (cfg.attn_softcap or cfg.final_softcap):
        assert got == ref["tokens"]
        return 0
    near_ties = 0
    for rid, (out, want) in enumerate(zip(got, ref["tokens"])):
        assert len(out) == len(want), rid
        for n, (a, b) in enumerate(zip(out, want)):
            if ref["margins"][(rid, n)] <= logit_atol(cfg):
                near_ties += 1
                break
            assert a == b, (rid, n)
    return near_ties


@pytest.mark.parametrize("case", CASES)
def test_engine_tokens_match_reference(reference, case):
    from repro_torch.serve.engine import ServeEngine
    cfg = port_cfg(case)
    eng = ServeEngine(_port_packed(reference, case), cfg, device="cpu",
                      **engine_kw(cfg))
    got = eng.generate(PROMPTS, N_NEW)
    eng.scheduler.check()
    assert eng.stats.generated_tokens == N_NEW * len(PROMPTS)
    # gemma2-smoke's smallest top-2 margin in the reference is 0.0045, over
    # 100x its tolerance: no near-tie (of the exact cases, qwen2.5-smoke's
    # is the smallest, 4.6e-5, against logit differences of at most 1.2e-7
    # in (b))
    assert assert_tokens_match(got, reference[case], cfg) == 0
    if cfg.sliding_window:                  # the 9-token prompt wrapped
        assert len(PROMPTS[1]) + N_NEW > eng.max_len


def test_margin_rule_catches_a_flip_and_forgives_a_near_tie(reference):
    """The soft-capped comparison fails on a changed token at a clear
    margin and stops at a near-tie."""
    cfg = port_cfg("gemma2-smoke")
    ref = reference["gemma2-smoke"]
    flipped = [list(o) for o in ref["tokens"]]
    flipped[0][2] += 1
    with pytest.raises(AssertionError):
        assert_tokens_match(flipped, ref, cfg)
    tied = dict(ref, margins={**ref["margins"], (0, 2): 0.0})
    assert assert_tokens_match(flipped, tied, cfg) == 1


# ---------------------------------------------------------------------------
# (d) chunked prefill == sequential decode, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,lengths", CHUNKS)
@pytest.mark.parametrize("case", CASES)
def test_prefill_chunk_bitexact_vs_decode(case, chunk, lengths):
    """test_torch_serve.py's check on each case, with the seeded biases and
    norm weights; with window 4 the ring is narrower than chunks of 8."""
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.testing import fill_attention_extras
    cfg = port_cfg(case)
    params = fill_attention_extras(init_packed_params(
        torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    check_prefill_chunk_bitexact_vs_decode(cfg, chunk, lengths, params)


# ---------------------------------------------------------------------------
# (e) checkpoints both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_reference_checkpoint_serves_reference_tokens(reference, case,
                                                      tmp_path):
    import shutil
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import load_packed_checkpoint
    cfg = port_cfg(case)
    src = str(tmp_path / case)
    shutil.copytree(os.path.join(reference["root"], case), src)
    params, extra = load_packed_checkpoint(src, cfg, device="cpu")
    assert extra["model"] == cfg.name
    _assert_same_tree(params, _port_packed(reference, case))
    eng = ServeEngine(params, cfg, device="cpu", **engine_kw(cfg))
    assert assert_tokens_match(eng.generate(PROMPTS, N_NEW),
                               reference[case], cfg) == 0


@pytest.mark.parametrize("case", CASES)
def test_port_save_writes_reference_checkpoint(reference, case, tmp_path):
    """The port's save of the reference's tree writes the reference's
    manifest leaves and arrays, so the reference restores it."""
    from repro_torch.serve.prequant import save_packed_checkpoint
    save_packed_checkpoint(str(tmp_path / case),
                           _port_packed(reference, case), port_cfg(case))
    _assert_same_checkpoint(str(tmp_path / case),
                            os.path.join(reference["root"], case))


# ---------------------------------------------------------------------------
# The guard's probe and scrub on pages of different widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "m2xfp"])
def test_probe_kv_and_scrub_on_mixed_width_pages(kv_quant):
    """The serve tests' model (hd 32) with gemma2's local/global layers
    (window 32) and 48 positions: local rings of 32, global of 48.
    probe_kv counts a NaN (bf16) or a 255 scale byte (packed) planted in
    either ring; ``_reset_slot(scrub=True)`` zeroes that slot in both
    widths and leaves every other slot's bytes; an admit-time reset writes
    only the position track."""
    from repro_torch.serve.engine import _reset_slot
    from repro_torch.serve.guard import probe_kv
    from repro_torch.models.model import init_caches
    cfg = dataclasses.replace(port_cfg("window4"), local_global=True,
                              sliding_window=32, kv_quant=kv_quant)
    caches = init_caches(cfg, 4, 48, "cpu")
    assert [c["pos"].shape[1] for c in caches["layers"]] == [32, 48]
    gen = torch.Generator().manual_seed(4)
    for layer in caches["layers"]:
        layer["pos"].copy_(torch.randint(0, 48, layer["pos"].shape,
                                         generator=gen))
        for name in ("k", "v"):
            page = layer[name]
            for s, t in (page.items() if isinstance(page, dict)
                         else [("", page)]):
                if t.dtype == torch.bfloat16:
                    t.copy_(torch.randn(t.shape, generator=gen))
                else:
                    t.copy_(torch.randint(0, 255 if s == "scales" else 256,
                                          t.shape, generator=gen,
                                          dtype=torch.uint8))
    assert probe_kv(caches, 4).tolist() == [0, 0, 0, 0]
    bad = float("nan") if kv_quant == "none" else 255
    for layer, slot, at in ((0, 1, 31), (1, 1, 47), (1, 3, 40)):
        page = caches["layers"][layer]["v"]
        t = page if kv_quant == "none" else page["scales"]
        t[slot, at, 0, 0] = bad
    assert probe_kv(caches, 4).tolist() == [0, 2, 0, 1]
    before = {(i, name, s): t.clone()
              for i, layer in enumerate(caches["layers"])
              for name, page in layer.items()
              for s, t in (page.items() if isinstance(page, dict)
                           else [("", page)])}
    _reset_slot(caches, 1, scrub=True)
    _reset_slot(caches, 2)
    assert probe_kv(caches, 4).tolist() == [0, 0, 0, 1]
    for (i, name, s), old in before.items():
        page = caches["layers"][i][name]
        t = page[s] if s else page
        if name == "pos":
            assert (t[1:3] == -1).all(), i
        else:
            assert not t[1].any(), (i, name, s)
            assert torch.equal(t[2].view(torch.uint8),
                               old[2].view(torch.uint8)), (i, name, s)
        for slot in (0, 3):                 # bit for bit (NaN included)
            assert torch.equal(t[slot].view(torch.uint8),
                               old[slot].view(torch.uint8)), (i, name, s)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
