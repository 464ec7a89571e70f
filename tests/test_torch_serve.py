"""The port's packed serve path against the reference, and its own
invariants.

(a) ``from_jax_tree`` of the reference's packed tree equals the port's own
    ``prequantize_params`` of the converted dense tree, byte for byte;
(b) ``decode_step`` / ``prefill_chunk`` logits agree with the reference per
    position (allclose, tolerance below);
(c) within the port, ``prefill_chunk`` is bit-identical to sequential
    ``decode_step`` (logits and caches), for T in {1, 3, 8} and ragged rows;
(d) the port's ``ServeEngine`` emits the reference engine's greedy tokens;
(e) slot reuse with more requests than slots; (f) ``submit`` validation.

The reference runs in a child process with XLA's
``--xla_allow_excess_precision=false``. By default XLA's CPU compiler may
keep values that the code casts to bf16 in f32 inside a fused jitted
computation, so the reference's jitted serve step differs from its own
op-by-op evaluation by more than bf16 rounding, and the near-tied logits
of this model (random weights, vocab 97) flip greedy tokens. With the flag
off, the jitted reference rounds where its code says it rounds, which is
what the port implements. The flag has to be set before JAX starts, so
the child keeps it away from every other test of the worker.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

BASE = dict(name="serve-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=97, remat=False,
            quant="serve")
FORMATS = ("m2xfp", "mxfp4")
PROMPTS = [[94, 94, 95, 36, 16], [89, 10, 25, 13, 30, 51, 11, 77, 23],
           [76, 30, 76]]
ENGINE = dict(n_slots=2, max_len=32, prefill_chunk=4)
N_NEW = 6
SEQ = np.random.default_rng(11).integers(0, 97, (2, 8))     # (B, T) tokens
LENGTHS = np.array([8, 5])
# (b): logits of |l| < 1 agree to 2e-5 absolute -- f32 accumulation order
# only (the port's GEMMs accumulate in float64, the reference's in f32)
LOGIT_TOL = dict(rtol=0.0, atol=2e-5)


# ---------------------------------------------------------------------------
# The reference, run in a child process (see module docstring)
# ---------------------------------------------------------------------------

def _flatten(tree):
    """Reference tree -> numpy leaves, PackedTensor -> plain dict."""
    from repro.core.codecs import PackedTensor
    if isinstance(tree, PackedTensor):
        return {"codec": tree.codec, "shape": tuple(tree.shape),
                "streams": {k: np.asarray(v) for k, v in tree.streams.items()}}
    if isinstance(tree, dict):
        return {k: _flatten(v) for k, v in tree.items()}
    return np.asarray(tree)


def reference_serve(packed, cfg, out: dict, key: str) -> None:
    """In the child: the reference engine's greedy tokens for PROMPTS, and
    the per-position logits of decode_step over SEQ and of one
    prefill_chunk with LENGTHS, with the caches after each, into ``out``'s
    "tokens", "logits" and "caches" under ``key``."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import decode_step, init_caches, prefill_chunk
    from repro.serve import ServeEngine

    out["tokens"][key] = ServeEngine(packed, cfg, guard=False, **ENGINE
                                     ).generate(PROMPTS, N_NEW)
    step = jax.jit(lambda p, b, c, i: decode_step(p, cfg, b, c, i))
    caches = init_caches(cfg, 2, 16, per_slot=True)
    seq = []
    for t in range(SEQ.shape[1]):
        lg, caches = step(packed, {"tokens": jnp.asarray(SEQ[:, t:t + 1])},
                          caches, jnp.full((2,), t, jnp.int32))
        seq.append(np.asarray(lg[:, 0]))
    out["logits"][f"decode_{key}"] = np.stack(seq, axis=1)   # (B, T, V)
    out["caches"][f"decode_{key}"] = _flatten(caches)
    chunk = jax.jit(lambda p, b, c, i, n: prefill_chunk(p, cfg, b, c, i, n))
    lg, caches = chunk(packed, {"tokens": jnp.asarray(SEQ)},
                       init_caches(cfg, 2, 16, per_slot=True),
                       jnp.zeros((2,), jnp.int32),
                       jnp.asarray(LENGTHS, jnp.int32))
    out["logits"][f"prefill_{key}"] = np.asarray(lg)
    out["caches"][f"prefill_{key}"] = _flatten(caches)


def _reference_main(out_path: str) -> None:
    """Child process: the reference's dense and packed trees (numpy
    leaves), its engine's greedy tokens and its per-position logits."""
    import jax
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import prequantize_params

    params = init_params(jax.random.PRNGKey(0), ModelConfig(**BASE))
    out = {"dense": _flatten(params), "packed": {}, "tokens": {},
           "logits": {}, "caches": {}}
    for fmt in FORMATS:
        cfg = ModelConfig(**BASE, quant_format=fmt)
        packed = prequantize_params(params, cfg)
        out["packed"][fmt] = _flatten(packed)
        reference_serve(packed, cfg, out, fmt)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def run_reference_child(script: str, tmp_path_factory):
    """Run ``script`` (a test file whose ``__main__`` pickles the
    reference's results to the path it is given) in a child with XLA's
    excess precision off (see module docstring); return what it wrote."""
    out = tmp_path_factory.mktemp("reference") / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    subprocess.run([sys.executable, script, str(out)], env=env,
                   check=True, timeout=900)
    with open(out, "rb") as f:      # written by the child just above
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """What ``_reference_main`` computed, in a child with XLA's excess
    precision off (see module docstring)."""
    return run_reference_child(__file__, tmp_path_factory)


def _port_cfg(fmt="m2xfp", **kw):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{**BASE, **kw}, quant_format=fmt)


def _port_packed(reference, fmt):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference["packed"][fmt], _port_cfg(fmt), "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _assert_same_tree(a, b, path=""):
    from repro_torch.core.codecs import PackedTensor
    if isinstance(a, PackedTensor):
        assert isinstance(b, PackedTensor), path
        assert (a.codec, a.shape, sorted(a.streams)) == \
            (b.codec, b.shape, sorted(b.streams)), path
        for s in a.streams:
            np.testing.assert_array_equal(_bits(a[s]), _bits(b[s]),
                                          err_msg=f"{path}.{s}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)


# ---------------------------------------------------------------------------
# (a) weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_from_jax_tree_packed_equals_port_prequant(reference, fmt):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import prequantize_params
    cfg = _port_cfg(fmt)
    dense = from_jax_tree(reference["dense"], cfg, "cpu")
    assert dense["embed"].dtype == torch.bfloat16
    assert dense["layers"][1]["attn"]["wq"].shape == (64, 64)
    _assert_same_tree(_port_packed(reference, fmt),
                      prequantize_params(dense, cfg))


def test_init_packed_params_equals_prequantized_init():
    """Packing layer by layer at init gives the bytes of init-then-pack,
    on paper-llama2-7b's smoke config."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.prequant import init_packed_params, \
        prequantize_params
    cfg = smoke_config("paper-llama2-7b", quant="serve")
    want = prequantize_params(
        init_params(torch.Generator().manual_seed(3), cfg, "cpu"), cfg)
    got = init_packed_params(torch.Generator().manual_seed(3), cfg, "cpu")
    _assert_same_tree(got, want)


# ---------------------------------------------------------------------------
# (b) logits against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_and_prefill_logits_match_reference(reference, fmt):
    from repro_torch.models.model import (
        decode_step, init_caches, prefill_chunk)
    logits = reference["logits"]
    cfg = _port_cfg(fmt)
    params = _port_packed(reference, fmt)
    caches = init_caches(cfg, 2, 16, "cpu")
    tokens = torch.from_numpy(SEQ)
    seq = [decode_step(params, cfg, {"tokens": tokens[:, t:t + 1]}, caches,
                       torch.full((2,), t))[:, 0]
           for t in range(SEQ.shape[1])]
    np.testing.assert_allclose(torch.stack(seq, 1).numpy(),
                               logits[f"decode_{fmt}"], **LOGIT_TOL)
    got = prefill_chunk(params, cfg, {"tokens": torch.from_numpy(SEQ)},
                        init_caches(cfg, 2, 16, "cpu"),
                        torch.zeros(2, dtype=torch.long),
                        torch.from_numpy(LENGTHS)).numpy()
    want = logits[f"prefill_{fmt}"]
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **LOGIT_TOL)


# ---------------------------------------------------------------------------
# (c) chunked prefill == sequential decode, within the port
# ---------------------------------------------------------------------------

CHUNKS = [(1, (1, 1, 1)), (3, (3, 3, 3)), (8, (8, 8, 8)), (8, (8, 3, 0))]


def _clone_caches(caches):
    """A copy of the per-layer caches (packed K/V pages are stream dicts)."""
    return {"layers": [
        {k: ({s: t.clone() for s, t in v.items()} if isinstance(v, dict)
             else v.clone()) for k, v in layer.items()}
        for layer in caches["layers"]]}


def check_prefill_chunk_bitexact_vs_decode(cfg, chunk, lengths,
                                           params=None):
    """After a shared two-token history, one prefill_chunk with ``lengths``
    valid tokens per row gives at every valid row and position the logits
    of decode_step fed the same tokens (rows advance only while valid), and
    leaves the same caches, bf16 or packed, byte for byte. The inputs are
    token ids, or embeddings under ``input_mode="embeddings"``. ``params``:
    the packed tree (default ``init_packed_params`` from seed 0)."""
    from repro_torch.models.model import (
        decode_step, init_caches, prefill_chunk)
    from repro_torch.serve.prequant import init_packed_params
    if params is None:
        params = init_packed_params(torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    b = len(lengths)
    rng = np.random.default_rng(chunk)

    def draw(t):                    # token ids, or embeddings of std 1
        if cfg.input_mode == "embeddings":
            return {"embeds": torch.from_numpy(rng.standard_normal(
                (b, t, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)}
        return {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, t)))}

    def cols(batch, t):
        return {k: v[:, t:t + 1] for k, v in batch.items()}
    warm, toks = draw(2), draw(chunk)
    lens = torch.tensor(lengths)
    seq_c = init_caches(cfg, b, 16, "cpu")
    for t in range(2):                     # a shared two-token history
        decode_step(params, cfg, cols(warm, t), seq_c, torch.full((b,), t))
    chunk_c = _clone_caches(seq_c)
    got = prefill_chunk(params, cfg, toks, chunk_c, torch.full((b,), 2), lens)
    for t in range(chunk):
        step_c = _clone_caches(seq_c)
        want = decode_step(params, cfg, cols(toks, t), step_c,
                           torch.full((b,), 2 + t))[:, 0]
        for row in np.nonzero((lens > t).numpy())[0]:   # rows still valid
            assert torch.equal(got[row, t], want[row]), (row, t)
            for layer, src in zip(seq_c["layers"], step_c["layers"]):
                for k, v in layer.items():
                    pairs = zip(v.values(), src[k].values()) \
                        if isinstance(v, dict) else [(v, src[k])]
                    for buf, new in pairs:
                        buf[row] = new[row]
    _assert_same_tree(chunk_c, seq_c)


@pytest.mark.parametrize("chunk,lengths", CHUNKS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_chunk_bitexact_vs_decode(fmt, chunk, lengths):
    from repro_torch.configs import smoke_config
    check_prefill_chunk_bitexact_vs_decode(
        smoke_config("paper-llama2-7b", quant="serve", quant_format=fmt),
        chunk, lengths)


# ---------------------------------------------------------------------------
# (d) greedy tokens of the engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_engine_tokens_match_reference(reference, fmt):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(_port_packed(reference, fmt), _port_cfg(fmt),
                      device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == reference["tokens"][fmt]
    eng.scheduler.check()
    assert eng.stats.generated_tokens == N_NEW * len(PROMPTS)


# ---------------------------------------------------------------------------
# (e) slot reuse, (f) submit validation
# ---------------------------------------------------------------------------

def check_slot_reuse(params, cfg):
    """Five ragged requests through two slots (slots are reused, prefill
    and decode mix) give each request's tokens served alone in one slot."""
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, 97, n))) for n in (5, 3, 9, 2, 6)]
    eng = ServeEngine(params, cfg, n_slots=2, max_len=24, prefill_chunk=3,
                      prefill_budget=4, device="cpu")
    outs = eng.generate(prompts, 4)
    eng.scheduler.check()
    assert len(eng.scheduler.finished) == 5 and not eng.scheduler.active
    assert eng.stats.prefill_steps and eng.stats.decode_steps
    for prompt, got in zip(prompts, outs):
        alone = ServeEngine(params, cfg, n_slots=1, max_len=24,
                            prefill_chunk=1, device="cpu")
        assert alone.generate([prompt], 4) == [got]


def test_slot_reuse_matches_requests_served_alone(reference):
    check_slot_reuse(_port_packed(reference, "m2xfp"), _port_cfg())


def test_submit_rejects_overlong_and_empty_requests(reference):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(_port_packed(reference, "m2xfp"), _port_cfg(), n_slots=1,
                      max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.submit([1] * 10, max_new_tokens=7)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], max_new_tokens=2)
    eng.submit([1] * 10, max_new_tokens=6)          # exactly fits


# the recurrent families' smoke configs (BASE has no Mamba state width and
# no shared-block period)
_RECURRENT_ARCH = {"ssm": "xlstm-125m", "hybrid": "zamba2-7b"}


@pytest.mark.parametrize("overrides,named", [
    pytest.param({"family": "ssm"}, "family 'ssm'",
                 id="overrides0-family='ssm'"),
    pytest.param({"family": "hybrid"}, "family 'hybrid'",
                 id="overrides1-family='hybrid'"),
    ({"input_mode": "embeddings"}, "input_mode='embeddings'"),
])
def test_unsupported_config_raises(overrides, named):
    """Every feature the port still refuses raises NotImplementedError,
    naming it: chunked prefill for the recurrent families (the reference's
    message; their engine builds and runs chunks of 1, as the reference's
    does), embedding input at the engine's construction (the model takes
    it: tests/test_torch_moe.py)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params, prefill_chunk
    from repro_torch.serve.engine import ServeEngine
    family = overrides.get("family")
    cfg = smoke_config(_RECURRENT_ARCH[family]) if family \
        else _port_cfg(**overrides)
    params = init_params(torch.Generator(), cfg, "cpu")
    if family is None:
        with pytest.raises(NotImplementedError, match=named):
            ServeEngine(params, cfg, device="cpu")
        return
    eng = ServeEngine(params, cfg, device="cpu")
    assert eng.chunk == 1
    with pytest.raises(NotImplementedError, match=named):
        prefill_chunk(params, cfg, {"tokens": torch.zeros(
            (eng.n_slots, 3), dtype=torch.long)}, eng.caches,
            torch.zeros(eng.n_slots, dtype=torch.long),
            torch.full((eng.n_slots,), 3))


if __name__ == "__main__":
    _reference_main(sys.argv[1])
