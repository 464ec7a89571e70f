"""The port's codec matrix against the reference (paper Tbl. 2/3/4/6).

In this process, on numpy inputs shared by both packages:

(a) the registry: the codec lists, every codec's attributes and
    ``format_ebw`` of every name equal the reference's;
(b) every codec's ``fake_quant_weight`` / ``fake_quant_act`` (through
    ``models.quant``), the five scale rules (also at the boundaries where a
    log2 is rounded), the m2xfp knobs (subgroup, top-k, the "ideal" FP6,
    Sg-EM's bits, the adaptive bias), ``PackedM2XFP``'s streams and
    decodes, the packers' ``rule``/``adaptive`` and ``pack_w_nvfp4``'s
    streams and decode are bit-identical to the reference's -- run op by op
    for nvfp4, fp4 and M2-NVFP4 (see tests/test_torch_core.py: XLA's jit
    multiplies by a rounded reciprocal where the code divides);
(c) the port's own invariants: decode(pack(w)) == fake_quant_weight(w) for
    every packed codec (nvfp4 too, which the reference's jit breaks), the
    "meta"-device template's shapes, ``dot_f32acc``'s f32 operands, and
    ``check_supported``'s errors.

In one reference child (excess precision off, as in test_torch_serve.py):

(d) the port's engine serves ``m2xfp_ideal6`` (bf16 and packed KV) with the
    reference engine's greedy tokens, and chunked prefill stays
    bit-identical to decode; nvfp4 logits agree with the reference's within
    LOGIT_TOL and its tokens equal the reference engine's -- both run op by
    op in the reference, since its jitted nvfp4 differs by the reciprocal
    rewrite (logits by up to 0.084 on this model, test below);
(e) nvfp4 packed checkpoints carry across in both directions;
(f) ``validate_packed_tree`` / ``verify_packed_tree`` on planted E4M3 NaN
    bytes and a NaN ``tscale`` give the reference's reports, repairs and
    bytes.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from test_torch_core import _inputs, _same_bits, _ties, reference_mode
from test_torch_faults import _assert_same_verify, _port_plant, \
    _port_verify
from test_torch_serve import (ENGINE, LOGIT_TOL, N_NEW, PROMPTS, SEQ,
                              _assert_same_tree, _flatten,
                              check_prefill_chunk_bitexact_vs_decode,
                              run_reference_child)

from repro.core import codecs as r_codecs
from repro.core.ebw import format_ebw as r_format_ebw
from repro.core import formats as r_formats
from repro.core import m2xfp as r_m2xfp
from repro.core import scaling as r_scaling
from repro.kernels import layout as r_layout
from repro.models import quant as r_quant
from repro_torch.core import codecs as p_codecs
from repro_torch.core.ebw import format_ebw as p_format_ebw
from repro_torch.core import formats as p_formats
from repro_torch.core import m2xfp as p_m2xfp
from repro_torch.core import scaling as p_scaling
from repro_torch.kernels import layout as p_layout
from repro_torch.models import quant as p_quant

BASE = dict(name="codecs-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=97, remat=False,
            quant="serve")
CODECS = ("fp4", "m2nvfp4", "m2xfp", "m2xfp_ideal6", "mxfp4", "nvfp4",
          "smx4")
PACKED = ("m2xfp", "m2xfp_ideal6", "mxfp4", "nvfp4")
# the formats whose scale is not a power of two: the reference runs op by
# op (module docstring)
EAGER = ("fp4", "m2nvfp4", "nvfp4")
# (quant_format, kv_quant) served by both engines
SERVED = (("m2xfp_ideal6", "none"), ("m2xfp_ideal6", "m2xfp_ideal6"),
          ("nvfp4", "none"))
# planted damage of the nvfp4 tree: (weight, stream, index, value)
NV_PLANTS = {
    "e4m3_nan_7f": [("layers/attn/wq", "scales", (1, 0, 5), 0x7F)],
    "e4m3_nan_ff": [("layers/ffn/down", "scales", (0, 2, 7), 0xFF),
                    ("layers/ffn/down", "scales", (1, 3, 1), 0x7F)],
    "tscale_nan": [("layers/ffn/up", "tscale", (1, 0, 0), float("nan"))],
}


def _weight(seed=0, k=256, n=96):
    return heavy_tailed(np.random.default_rng(seed), (k, n))


# ---------------------------------------------------------------------------
# The reference, in a child process
# ---------------------------------------------------------------------------

def _reference_logits(cfg, packed):
    """Per-position decode_step logits over SEQ (B, T, V)."""
    from repro.models.model import decode_step, init_caches
    step = jax.jit(lambda p, b, c, i: decode_step(p, cfg, b, c, i))
    caches, seq = init_caches(cfg, 2, 16, per_slot=True), []
    for t in range(SEQ.shape[1]):
        lg, caches = step(packed, {"tokens": jnp.asarray(SEQ[:, t:t + 1])},
                          caches, jnp.full((2,), t, jnp.int32))
        seq.append(np.asarray(lg[:, 0]))
    return np.stack(seq, axis=1)


def _reference_main(out_path: str) -> None:
    import pickle

    from repro.core.codecs import PackedTensor, validate_packed_tree
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import (ServeEngine, StreamIntegrityError,
                             prequantize_params, verify_packed_tree)
    from repro.serve.prequant import save_packed_checkpoint

    root = os.path.dirname(out_path)
    params = init_params(jax.random.PRNGKey(0), ModelConfig(**BASE))
    out = {"root": root, "dense": _flatten(params), "packed": {},
           "tokens": {}, "logits": {}, "plants": {}}
    packed = {}
    for fmt, kv in SERVED:
        cfg = ModelConfig(**BASE, quant_format=fmt, kv_quant=kv)
        if fmt not in packed:
            packed[fmt] = prequantize_params(params, cfg)
            out["packed"][fmt] = _flatten(packed[fmt])
        for eager in ((False, True) if fmt == "nvfp4" else (False,)):
            with reference_mode(eager):
                out["tokens"][(fmt, kv, eager)] = ServeEngine(
                    packed[fmt], cfg, guard=False, **ENGINE).generate(
                    PROMPTS, N_NEW)
                out["logits"][(fmt, kv, eager)] = _reference_logits(
                    cfg, packed[fmt])
    cfg = ModelConfig(**BASE, quant_format="nvfp4")
    save_packed_checkpoint(os.path.join(root, "nvfp4"), packed["nvfp4"], cfg)

    is_p = lambda x: isinstance(x, PackedTensor)  # noqa: E731

    def plant(tree, damage):
        def fix(path, leaf):
            if not is_p(leaf):
                return leaf
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            streams = dict(leaf.streams)
            for k, stream, idx, value in damage:
                if k == key:
                    a = np.array(streams[stream])
                    a[idx] = value
                    streams[stream] = jnp.asarray(a)
            return PackedTensor(streams, leaf.shape, leaf.codec)
        return jax.tree_util.tree_map_with_path(fix, tree, is_leaf=is_p)

    def verify(tree, **kw):
        try:
            fixed, repairs = verify_packed_tree(tree, **kw)
            return dict(repairs=repairs, tree=_flatten(fixed))
        except StreamIntegrityError as e:
            return dict(error=str(e), leaves=e.leaves)

    for name, damage in NV_PLANTS.items():
        bad = plant(packed["nvfp4"], damage)
        out["plants"][name] = dict(
            report=validate_packed_tree(bad),
            requantize=verify(bad, cfg=cfg, source_params=params),
            clamp=verify(bad), no_repair=verify(bad, repair=False))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


def _cfg(fmt="nvfp4", **kw):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**BASE, quant_format=fmt, **kw)


def _packed(reference, fmt):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference["packed"][fmt], _cfg(fmt), "cpu")


# ---------------------------------------------------------------------------
# (a) the registry
# ---------------------------------------------------------------------------

def test_codec_lists_equal_reference():
    assert p_codecs.list_codecs() == r_codecs.list_codecs() == CODECS
    assert p_codecs.packed_codecs() == r_codecs.packed_codecs() == PACKED
    assert p_codecs.kv_codecs() == r_codecs.kv_codecs()
    assert p_codecs.kernel_codecs() == r_codecs.kernel_codecs()


def _attributes(codec) -> dict:
    return dict(
        group=codec.group, ebw=codec.ebw, scale_kind=codec.scale_kind,
        scale_sat_bounds=codec.scale_sat_bounds, has_meta=codec.has_meta,
        act_batch_invariant=codec.act_batch_invariant, packed=codec.packed,
        kv_capable=codec.kv_capable, kernel=codec.kernel is not None,
        decode_dtype=str(codec.decode_dtype).split(".")[-1].split("'")[0])


@pytest.mark.parametrize("name", CODECS)
def test_codec_attributes_equal_reference(name):
    assert _attributes(p_codecs.get_codec(name)) == \
        _attributes(r_codecs.get_codec(name))


@pytest.mark.parametrize("name,kw", [
    ("mxfp4", {}), ("mxfp4", {"group": 16}), ("nvfp4", {}),
    ("nvfp4", {"group": 32}), ("smx4", {}), ("smx4", {"group": 32}),
    ("fp4_fp16scale", {}), ("m2xfp", {}), ("m2xfp", {"subgroup": 4}),
    ("m2xfp", {"group": 64, "meta_bits_per_subgroup": 1.0}),
    ("m2nvfp4", {}), ("m2nvfp4", {"subgroup": 8})])
def test_format_ebw_equal_reference(name, kw):
    assert p_format_ebw(name, **kw) == r_format_ebw(name, **kw)


def test_format_ebw_unknown_name_raises_like_reference():
    for fn in (p_format_ebw, r_format_ebw):
        with pytest.raises(ValueError, match="unknown format 'int4'"):
            fn("int4")


# ---------------------------------------------------------------------------
# (b) fake-quant, scale rules, knobs, packed streams: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", ["weight", "act"])
@pytest.mark.parametrize("name", CODECS)
def test_fake_quant_bit_identical(name, role):
    """``models.quant.fake_quant_weight`` (groups along the contraction
    axis, a (K, N) weight) and ``fake_quant_act`` (a (B, T, K) activation)
    of every codec."""
    x = _weight(3) if role == "weight" else \
        heavy_tailed(np.random.default_rng(4), (4, 3, 256))
    r_fn = getattr(r_quant, f"fake_quant_{role}")
    p_fn = getattr(p_quant, f"fake_quant_{role}")
    with reference_mode(name in EAGER):
        want = np.asarray(r_fn(jnp.asarray(x), name))
    _same_bits(want, p_fn(torch.from_numpy(x), name).numpy())


def _amax_set() -> np.ndarray:
    """Group maxima: heavy-tailed ones, zero, the ends of the E8M0 range,
    and M * 2^k, P * 2^k with their nextafter neighbours (M = 6, P = 4)."""
    rng = np.random.default_rng(5)
    ks = np.arange(-120, 121, dtype=np.float64)
    edges = np.concatenate([np.float32(6.0 * 2 ** ks),
                            np.float32(4.0 * 2 ** ks)])
    up = np.nextafter(edges, np.float32(np.inf))
    down = np.nextafter(edges, np.float32(0))
    return np.concatenate([
        np.abs(heavy_tailed(rng, (1, 1024))[0]),
        np.float32([0.0, 2.0 ** -120, 3e38, 3.9999998, 8.0]),
        edges, up, down]).astype(np.float32)


@pytest.mark.parametrize("rule", p_scaling.SCALE_RULES)
def test_scale_rule_exponents_bit_identical(rule):
    assert p_scaling.SCALE_RULES == r_scaling.SCALE_RULES
    amax = _amax_set()
    want = np.asarray(r_scaling.shared_scale_exponent(jnp.asarray(amax),
                                                      rule))
    got = p_scaling.shared_scale_exponent(torch.from_numpy(amax), rule)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _half_integer_edges(base: float) -> np.ndarray:
    """amax = base * sqrt(2) * 2^k and base * 2^k (k in -110..110) and 3
    nextafter neighbours on each side: log2(amax / base) lies at a half
    integer or an integer, where a rounding or a ceiling of it flips."""
    ks = np.arange(-110, 111, dtype=np.float64)
    c = np.concatenate([np.float32(base * np.sqrt(2.0) * 2 ** ks),
                        np.float32(base * 2 ** ks)])
    out, up, down = [c], c, c
    for _ in range(3):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(0))
        out += [up, down]
    return np.concatenate(out).astype(np.float32)


def _cr_log2(y: np.ndarray) -> np.ndarray:
    """log2 of f32 ``y`` correctly rounded to f32."""
    return np.log2(y.astype(np.float64)).astype(np.float32)


def _smx4_oracle(x: np.ndarray) -> np.ndarray:
    """SMX4 in numpy f32, with a correctly rounded log2 (the port's)."""
    xg = x.reshape(-1, 16)
    amax = np.abs(xg).max(axis=-1, keepdims=True)
    y = (np.maximum(amax, np.float32(1e-30)) / np.float32(3)).astype(
        np.float32)
    e = np.where(amax == 0, 0, np.ceil(_cr_log2(y))).astype(np.int32)
    s = np.ldexp(np.float32(1), e).astype(np.float32)[..., None]
    xp = xg.reshape(-1, 8, 2)
    pmax = np.abs(xp).max(axis=-1, keepdims=True)
    with np.errstate(over="ignore"):
        b = (pmax <= np.float32(3) * s / np.float32(2)).astype(np.int32)
    sp = (s * np.ldexp(np.float32(1), -b)).astype(np.float32)
    q = np.clip(np.round(xp / sp), -3, 3).astype(np.float32)
    with np.errstate(over="ignore"):
        return (q * sp).astype(np.float32).reshape(x.shape)


@pytest.mark.parametrize("rule,base", [("rtn1", 6.0), ("rtn2", 4.0),
                                       ("smx4", 3.0)])
def test_log2_rules_at_their_edges(rule, base):
    """rtn1/rtn2 round a log2, SMX4 takes its ceiling. The port's log2 is
    correctly rounded (the same on the card), so its exponents (and SMX4's
    values) are numpy's at every edge point. The reference's differ only
    where the log2 lies within 4 f32 ulps of the value where its rounding
    flips: XLA's f32 log2 is a few ulps off, and not exact at powers of two
    (ROADMAP, queue C)."""
    amax = _half_integer_edges(base)
    op = np.ceil if rule == "smx4" else np.round
    # a log2 within 4 f32 ulps of the integer (ceil) or half-integer
    # (round) where its rounding flips
    l2 = _cr_log2((np.maximum(amax, np.float32(1e-30))
                   / np.float32(base)).astype(np.float32))
    edge = np.round(l2) if rule == "smx4" else np.floor(l2) + 0.5
    explained = np.abs(l2 - edge) <= 4 * np.spacing(np.abs(l2))
    if rule == "smx4":
        # one group per edge point: its maximum, a zero beside it (one
        # pair), and a third of it in the next pair
        x = np.zeros((amax.size, 16), np.float32)
        x[:, 0], x[:, 2] = amax, amax / np.float32(3)
        got = p_formats.quantize_smx4(torch.from_numpy(x)).numpy()
        want = np.asarray(r_formats.quantize_smx4(jnp.asarray(x)))
        _same_bits(_smx4_oracle(x), got)
        differ = (got.view(np.uint32) != want.view(np.uint32)).any(axis=1)
    else:
        got = p_scaling.shared_scale_exponent(torch.from_numpy(amax),
                                              rule).numpy()
        want = np.asarray(r_scaling.shared_scale_exponent(
            jnp.asarray(amax), rule))
        np.testing.assert_array_equal(got, op(l2).astype(np.int32))
        differ = got != want
    assert not (differ & ~explained).any(), amax[differ & ~explained][:8]
    assert differ.sum() < 0.15 * amax.size


@pytest.mark.parametrize("fn", ["mxfp4", "act_m2xfp", "weight_m2xfp"])
@pytest.mark.parametrize("rule", p_scaling.SCALE_RULES)
def test_quantizers_by_rule_bit_identical(rule, fn):
    r_fn, p_fn = {
        "mxfp4": (r_formats.quantize_mxfp4, p_formats.quantize_mxfp4),
        "act_m2xfp": (r_m2xfp.quantize_act_m2xfp,
                      p_m2xfp.quantize_act_m2xfp),
        "weight_m2xfp": (r_m2xfp.quantize_weight_m2xfp,
                         p_m2xfp.quantize_weight_m2xfp)}[fn]
    x = _inputs("heavy")
    _same_bits(np.asarray(r_fn(jnp.asarray(x), rule=rule)),
               p_fn(torch.from_numpy(x), rule=rule).numpy())


def _knob_input() -> np.ndarray:
    """Heavy-tailed rows, the exact-tie rows and zero groups, 256 wide."""
    x = heavy_tailed(np.random.default_rng(6), (25, 256))
    x[3, :64] = 0.0
    return np.concatenate([x, np.tile(_ties(), (1, 8))]).astype(np.float32)


@pytest.mark.parametrize("encoding", ["clamped", "ideal"])
@pytest.mark.parametrize("n_top", [1, 2])
@pytest.mark.parametrize("subgroup", [4, 8])
def test_act_knobs_bit_identical(subgroup, n_top, encoding):
    x = _knob_input()
    kw = dict(subgroup=subgroup, n_top=n_top, encoding=encoding)
    _same_bits(np.asarray(r_m2xfp.quantize_act_m2xfp(jnp.asarray(x), **kw)),
               p_m2xfp.quantize_act_m2xfp(torch.from_numpy(x), **kw).numpy())


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("subgroup", [4, 8])
def test_weight_knobs_bit_identical(subgroup, bits, adaptive):
    x = _knob_input()
    kw = dict(subgroup=subgroup, bits=bits, adaptive=adaptive)
    _same_bits(
        np.asarray(r_m2xfp.quantize_weight_m2xfp(jnp.asarray(x), **kw)),
        p_m2xfp.quantize_weight_m2xfp(torch.from_numpy(x), **kw).numpy())


def test_sg_em_codes_with_return_codes_bit_identical():
    """The search's k and b per subgroup and group, at subgroup 4 and 3
    bits without the adaptive bias, and the M2-NVFP4 scales."""
    x = _knob_input().reshape(-1, 8, 32)
    s = np.float32(2.0) ** np.random.default_rng(7).integers(
        -3, 4, (x.shape[0], 8, 1)).astype(np.float32)
    for kw in (dict(bits=3, adaptive=False), dict(bits=2, adaptive=True)):
        dq_r, k_r, b_r = r_m2xfp.sg_em_dequant_with_scale(
            jnp.asarray(x), jnp.asarray(s), 4, return_codes=True, **kw)
        dq_p, k_p, b_p = p_m2xfp.sg_em_dequant_with_scale(
            torch.from_numpy(x), torch.from_numpy(s), 4, return_codes=True,
            **kw)
        np.testing.assert_array_equal(np.asarray(k_r), k_p.numpy())
        np.testing.assert_array_equal(np.asarray(b_r), b_p.numpy())
        _same_bits(np.asarray(dq_r), dq_p.numpy())


def _same_packed(want, got):
    """Reference PackedM2XFP == port PackedM2XFP (streams by bytes)."""
    for f in ("codes", "scale", "meta"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert (want.kind, want.group, want.subgroup, tuple(want.orig_shape)) \
        == (got.kind, got.group, got.subgroup, got.orig_shape)
    assert want.nbytes_per_elem == got.nbytes_per_elem == 4.5 / 8


@pytest.mark.parametrize("rule", ["floor", "rtn1"])
def test_packed_act_streams_and_decode(rule):
    x = _knob_input().reshape(2, -1, 256)         # any leading shape
    want = r_m2xfp.encode_act_m2xfp(jnp.asarray(x), rule=rule)
    got = p_m2xfp.encode_act_m2xfp(torch.from_numpy(x), rule=rule)
    _same_packed(want, got)
    dq = p_m2xfp.decode_act_m2xfp(got).numpy()
    _same_bits(np.asarray(r_m2xfp.decode_act_m2xfp(want)), dq)
    # the packed round trip is the fake-quant, but for -0.0 inputs, which
    # the sign-magnitude code 8 decodes to +0.0 (ROADMAP, queue C)
    fq = p_m2xfp.quantize_act_m2xfp(torch.from_numpy(x), rule=rule).numpy()
    np.testing.assert_array_equal(dq, fq)


@pytest.mark.parametrize("adaptive", [True, False])
def test_packed_weight_streams_and_decode(adaptive):
    w = _knob_input()
    want = r_m2xfp.encode_weight_m2xfp(jnp.asarray(w), adaptive=adaptive)
    got = p_m2xfp.encode_weight_m2xfp(torch.from_numpy(w), adaptive=adaptive)
    _same_packed(want, got)
    dq = p_m2xfp.decode_weight_m2xfp(got).numpy()
    _same_bits(np.asarray(r_m2xfp.decode_weight_m2xfp(want)), dq)
    # the round trip is the fake-quant, but for -0.0 (as for activations)
    np.testing.assert_array_equal(dq, p_m2xfp.quantize_weight_m2xfp(
        torch.from_numpy(w), adaptive=adaptive).numpy())


@pytest.mark.parametrize("packer,kw", [
    ("pack_w_sgem", dict(rule="rtn2")), ("pack_w_sgem", dict(adaptive=False)),
    ("pack_w_sgem", dict(rule="ceil", adaptive=False)),
    ("pack_w_mxfp4", dict(rule="rtn1")), ("pack_w_mxfp4", dict(rule="ceil")),
    ("pack_x_elem_em", dict(rule="rtne")),
    ("pack_x_elem_em", dict(rule="rtn2"))])
def test_packers_rule_and_adaptive_bytes_equal(packer, kw):
    w = _weight(8)
    want = getattr(r_layout, packer)(jnp.asarray(w), **kw)
    got = getattr(p_layout, packer)(torch.from_numpy(w), **kw)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)


def _nvfp4_weights():
    """A heavy-tailed (K, N) weight, one with zero and saturating groups,
    and an all-zero one (tensor scale 1)."""
    w = _weight(9)
    w2 = w.copy()
    w2[:16] = 0.0
    w2[32:48, 5] = 3e38
    return {"heavy": w, "extremes": w2,
            "zeros": np.zeros((64, 8), np.float32)}


@pytest.mark.parametrize("kind", ["heavy", "extremes", "zeros"])
def test_pack_w_nvfp4_streams_and_decode(kind):
    """Codes, E4M3 scale bytes and ``tscale`` bits equal the reference's
    packer (which computes the tensor scale op by op, outside any jit), and
    the decode equals the reference's decode of the same streams."""
    w = _nvfp4_weights()[kind]
    want = r_layout.pack_w_nvfp4(jnp.asarray(w))
    got = p_layout.pack_w_nvfp4(torch.from_numpy(w))
    assert sorted(got) == ["codes", "scales", "tscale"]
    assert got["scales"].shape == (w.shape[0] // 16, w.shape[1])
    assert got["tscale"].shape == (1, 1) and got["tscale"].dtype == \
        torch.float32
    for k in want:
        _same_bits(np.asarray(want[k]).view(np.uint8),
                   got[k].numpy().view(np.uint8))
    k, n = w.shape
    _same_bits(np.asarray(r_codecs._decode_nvfp4(want, k, n)),
               p_codecs._decode_nvfp4(got, k, n).numpy())


def test_decode_nvfp4_every_scale_byte():
    """Every non-NaN E4M3 byte (subnormals and zero included) and every
    code decode as in the reference."""
    rng = np.random.default_rng(10)
    scales = np.arange(256, dtype=np.uint8)
    scales = scales[(scales & 0x7F) != 0x7F].reshape(-1, 1)   # (254, 1)
    k = scales.shape[0] * 16
    streams = {"codes": rng.integers(0, 256, (k // 2, 1), dtype=np.uint8),
               "scales": scales,
               "tscale": np.float32([[3.7e-3]])}
    want = r_codecs._decode_nvfp4(
        {s: jnp.asarray(a) for s, a in streams.items()}, k, 1)
    got = p_codecs._decode_nvfp4(
        {s: torch.from_numpy(a) for s, a in streams.items()}, k, 1)
    _same_bits(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# (c) the port's own invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["heavy", "extremes"])
@pytest.mark.parametrize("fmt", PACKED)
def test_decode_of_pack_is_fake_quant_weight(fmt, kind):
    """decode(pack(w)) == fake_quant_weight(w), bit for bit in f32, for
    every packed codec -- nvfp4 too, where the reference's jitted
    fake-quant breaks it (tests/test_codecs.py::
    test_packed_roundtrip_matches_fake_quant[nvfp4])."""
    w = torch.from_numpy(_nvfp4_weights()[kind])
    p = p_quant.pack_serving_weight(w, fmt)
    dec = p_quant.decode_serving_weight(p, torch.float32)
    _same_bits(dec.numpy(), p_quant.fake_quant_weight(w, fmt).numpy())


@pytest.mark.parametrize("fmt", PACKED)
def test_meta_template_matches_pack_shapes(fmt):
    """A weight on the "meta" device packs to the real encode's stream
    shapes and dtypes: (rows, N) streams scale with K, nvfp4's per-tensor
    ``tscale`` stays (1, 1)."""
    for k, n in ((64, 24), (256, 96)):
        real = p_quant.pack_serving_weight(torch.zeros(k, n), fmt)
        meta = p_quant.pack_serving_weight(torch.empty(k, n, device="meta"),
                                           fmt)
        assert {s: (t.shape, t.dtype) for s, t in meta.streams.items()} == \
            {s: (t.shape, t.dtype) for s, t in real.streams.items()}
        assert all(t.is_meta for t in meta.streams.values())


def test_dot_f32acc_keeps_f32_operands_off_the_cpu(monkeypatch):
    """Off the CPU, an f32 weight (nvfp4's decode, exact in f32 only) goes
    to an f32 ``torch.mm`` unrounded and with TF32 off for the call; a bf16
    weight still gives bf16 operands with an f32 output. (Checked on the
    "meta" device, which runs the non-CPU branch without a card.)"""
    from repro_torch.models import numerics
    seen = []
    real_mm = torch.mm

    def spy(a, b, **kw):
        seen.append((a.dtype, b.dtype, kw.get("out_dtype"),
                     torch.backends.cuda.matmul.allow_tf32))
        return real_mm(a, b, **kw)

    monkeypatch.setattr(torch, "mm", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.empty(2, 3, 64, dtype=torch.bfloat16, device="meta")
    out = numerics.dot_f32acc(x.float(), torch.empty(64, 8, device="meta"))
    assert out.shape == (2, 3, 8) and out.dtype == torch.float32
    out = numerics.dot_f32acc(x, torch.empty(64, 8, dtype=torch.bfloat16,
                                             device="meta"))
    assert out.shape == (2, 3, 8) and out.dtype == torch.float32
    assert seen == [(torch.float32, torch.float32, None, False),
                    (torch.bfloat16, torch.bfloat16, torch.float32, True)]
    assert torch.backends.cuda.matmul.allow_tf32        # restored


def test_check_supported_quant_format_and_kv_quant():
    """quant_format takes any packed codec, kv_quant any KV codec (the
    ideal-FP6 ablation included); the others raise the reference's
    ValueErrors."""
    from repro_torch.models.model import check_supported
    for fmt in PACKED:
        check_supported(_cfg(fmt))
    check_supported(_cfg("m2xfp_ideal6", kv_quant="m2xfp_ideal6"))
    with pytest.raises(ValueError, match="cfg.quant_format='smx4' has no "
                       "packed serving path; packable codecs: m2xfp, "
                       "m2xfp_ideal6, mxfp4, nvfp4"):
        check_supported(_cfg("smx4"))
    with pytest.raises(ValueError, match="codec 'nvfp4' has no packed "
                       "KV-cache path .*KV-capable codecs: m2xfp, "
                       "m2xfp_ideal6, mxfp4"):
        check_supported(_cfg(kv_quant="nvfp4"))


# ---------------------------------------------------------------------------
# (d) serving against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["m2xfp_ideal6", "nvfp4"])
def test_from_jax_tree_equals_port_prequant(reference, fmt):
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import prequantize_params
    dense = from_jax_tree(reference["dense"], _cfg(fmt), "cpu")
    _assert_same_tree(_packed(reference, fmt),
                      prequantize_params(dense, _cfg(fmt)))


def test_ideal6_weights_are_m2xfp_bytes(reference):
    """The ablation changes the activations only: its packed weights are
    m2xfp's, byte for byte."""
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve.prequant import prequantize_params
    dense = from_jax_tree(reference["dense"], _cfg("m2xfp"), "cpu")
    got = prequantize_params(dense, _cfg("m2xfp_ideal6"))
    want = prequantize_params(dense, _cfg("m2xfp"))
    for lg, lw in zip(got["layers"], want["layers"]):
        for part in ("attn", "ffn"):
            for name, p in lg[part].items():
                assert p.codec == "m2xfp_ideal6"
                for s, t in p.streams.items():
                    assert torch.equal(t, lw[part][name].streams[s])


@pytest.mark.parametrize("fmt,kv", SERVED)
def test_engine_tokens_match_reference(reference, fmt, kv):
    """m2xfp_ideal6 against the jitted reference engine; nvfp4 against the
    reference engine run op by op (its jit multiplies the tensor scale's
    division by a rounded reciprocal)."""
    from repro_torch.serve.engine import ServeEngine
    cfg = _cfg(fmt, kv_quant=kv)
    eng = ServeEngine(_packed(reference, fmt), cfg, device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == \
        reference["tokens"][(fmt, kv, fmt == "nvfp4")]
    eng.scheduler.check()
    assert eng.guard_summary()["state"] == "healthy"


@pytest.mark.parametrize("fmt,kv", SERVED)
def test_decode_logits_match_reference(reference, fmt, kv):
    """Per-position decode_step logits within LOGIT_TOL (f32 accumulation
    order: the port's CPU products accumulate in float64). For nvfp4 the
    reference runs op by op; its jitted logits differ by far more (see
    test_nvfp4_jit_differs_from_op_by_op)."""
    from repro_torch.models.model import decode_step, init_caches
    cfg = _cfg(fmt, kv_quant=kv)
    params = _packed(reference, fmt)
    caches = init_caches(cfg, 2, 16, "cpu")
    tokens = torch.from_numpy(SEQ)
    got = torch.stack([decode_step(params, cfg,
                                   {"tokens": tokens[:, t:t + 1]}, caches,
                                   torch.full((2,), t))[:, 0]
                       for t in range(SEQ.shape[1])], 1).numpy()
    np.testing.assert_allclose(
        got, reference["logits"][(fmt, kv, fmt == "nvfp4")], **LOGIT_TOL)


def test_nvfp4_jit_differs_from_op_by_op(reference):
    """The reason nvfp4 is held against the op-by-op reference: its jitted
    serve step moves the logits of this model by more than 1e-2 (0.084
    when written) and changes greedy tokens. If this starts failing, the
    reference's jit no longer rewrites the division (ROADMAP, queue C)."""
    jit = reference["logits"][("nvfp4", "none", False)]
    eager = reference["logits"][("nvfp4", "none", True)]
    assert np.abs(jit - eager).max() > 1e-2


def _reciprocal_div(monkeypatch):
    """Make the port's ``div_const`` multiply by the f32-rounded reciprocal
    of its constant, as XLA's jit rewrites ``x / c``."""
    from repro_torch.core import formats
    monkeypatch.setattr(formats, "div_const", lambda x, c: x * (1.0 / c))


@pytest.mark.parametrize("fn", ["nvfp4", "fp4", "act_m2nvfp4",
                                "weight_m2nvfp4"])
def test_jit_is_the_reciprocal_rewrite(fn, monkeypatch):
    """The mechanism behind holding nvfp4, fp4 and M2-NVFP4 against the
    reference run op by op: the jitted reference equals, bit for bit, the
    port with each division by a constant (amax / 2688, amax / 6) made a
    product with the rounded reciprocal -- XLA's rewrite (its HLO holds
    ``multiply(x, 0.000372023816)`` where the code divides by 2688). On
    this (64, 4096) input the two differ in more than 5% of the outputs
    (whether they differ at all depends on the tensor's maximum)."""
    r_fn, p_fn = {
        "nvfp4": (r_formats.quantize_nvfp4, p_formats.quantize_nvfp4),
        "fp4": (r_formats.quantize_fp4_fp16scale,
                p_formats.quantize_fp4_fp16scale),
        "act_m2nvfp4": (r_m2xfp.quantize_act_m2nvfp4,
                        p_m2xfp.quantize_act_m2nvfp4),
        "weight_m2nvfp4": (r_m2xfp.quantize_weight_m2nvfp4,
                           p_m2xfp.quantize_weight_m2nvfp4)}[fn]
    x = heavy_tailed(np.random.default_rng(0), (64, 4096))
    want = np.asarray(r_fn(jnp.asarray(x)))
    exact = p_fn(torch.from_numpy(x)).numpy()
    assert (want.view(np.uint32) != exact.view(np.uint32)).mean() > 0.05
    _reciprocal_div(monkeypatch)
    _same_bits(want, p_fn(torch.from_numpy(x)).numpy())


def test_nvfp4_tensor_scale_ulp_moves_logits(reference, monkeypatch):
    """Why that rewrite moves nvfp4's serving so much: its per-tensor scale
    t = amax / 2688 puts many bf16 activations exactly on an FP4 rounding
    tie, so t one ulp off flips many elements at once. The port's decode
    logits over SEQ move by more than 1e-2 (0.084 when written) with t
    taken through the rounded reciprocal."""
    from repro_torch.models.model import decode_step, init_caches
    cfg, params = _cfg(), _packed(reference, "nvfp4")

    def logits():
        caches = init_caches(cfg, 2, 16, "cpu")
        tokens = torch.from_numpy(SEQ)
        return torch.stack([decode_step(params, cfg,
                                        {"tokens": tokens[:, t:t + 1]},
                                        caches, torch.full((2,), t))[:, 0]
                            for t in range(SEQ.shape[1])], 1).numpy()

    exact = logits()
    _reciprocal_div(monkeypatch)
    assert np.abs(logits() - exact).max() > 1e-2


@pytest.mark.parametrize("kv", ["none", "m2xfp_ideal6"])
def test_ideal6_chunked_prefill_bitexact_vs_decode(kv):
    check_prefill_chunk_bitexact_vs_decode(
        _cfg("m2xfp_ideal6", kv_quant=kv), 8, (8, 3, 0))


# ---------------------------------------------------------------------------
# (e) nvfp4 checkpoints across the packages
# ---------------------------------------------------------------------------

def test_nvfp4_checkpoint_from_reference(reference, tmp_path):
    """The port restores the reference's nvfp4 file to the bytes of its
    in-memory tree (``tscale`` leaves included) and serves it with the
    reference engine's tokens."""
    import shutil
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import load_packed_checkpoint
    ckpt = str(tmp_path / "nvfp4")
    shutil.copytree(os.path.join(reference["root"], "nvfp4"), ckpt)
    got, extra = load_packed_checkpoint(ckpt, _cfg(), validate_streams=True,
                                        device="cpu")
    assert extra["codec"] == "nvfp4"
    assert got["layers"][1]["attn"]["wq"].streams["tscale"].shape == (1, 1)
    _assert_same_tree(got, _packed(reference, "nvfp4"))
    eng = ServeEngine(got, _cfg(), device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == \
        reference["tokens"][("nvfp4", "none", True)]


def test_nvfp4_checkpoint_from_port(reference, tmp_path):
    """The port's save writes the reference's manifest leaves (paths,
    shapes, dtype names, CRC-32s) and arrays, so the reference restores
    it."""
    from test_torch_checkpoint import _assert_same_checkpoint
    from repro_torch.serve.prequant import save_packed_checkpoint
    save_packed_checkpoint(str(tmp_path / "nvfp4"),
                           _packed(reference, "nvfp4"), _cfg())
    with open(tmp_path / "nvfp4" / "step_0000000000" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["layers/attn/wq/.tscale"]["shape"] == [2, 1, 1]
    assert leaves["layers/attn/wq/.scales"]["shape"] == [2, 4, 64]
    _assert_same_checkpoint(str(tmp_path / "nvfp4"),
                            os.path.join(reference["root"], "nvfp4"))


# ---------------------------------------------------------------------------
# (f) validation and repair of E4M3 scales and the tensor scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NV_PLANTS))
def test_validate_packed_tree_nvfp4_matches_reference(reference, name):
    from repro_torch.core.codecs import validate_packed_tree
    params = _packed(reference, "nvfp4")
    assert validate_packed_tree(params) == {}
    got = validate_packed_tree(_port_plant(params, NV_PLANTS[name]))
    assert got == reference["plants"][name]["report"]


@pytest.mark.parametrize("mode", ["requantize", "clamp", "no_repair"])
@pytest.mark.parametrize("name", sorted(NV_PLANTS))
def test_verify_packed_tree_nvfp4_matches_reference(reference, name, mode):
    """E4M3 NaN bytes are lowered by one (0x7F -> 0x7E, 0xFF -> 0xFE) by
    clamp; a NaN tensor scale is beyond clamping and needs the source
    weights. Repairs, bytes and errors equal the reference's."""
    from repro_torch.convert import from_jax_tree
    bad = _port_plant(_packed(reference, "nvfp4"), NV_PLANTS[name])
    kw = {"no_repair": dict(repair=False), "clamp": {},
          "requantize": dict(cfg=_cfg(), source_params=from_jax_tree(
              reference["dense"], _cfg(), "cpu"))}[mode]
    _assert_same_verify(_port_verify(bad, **kw),
                        reference["plants"][name][mode])


if __name__ == "__main__":
    _reference_main(sys.argv[1])
