"""The port's packed KV cache against the reference, and its own invariants.

(a) ``kv_encode`` pages and ``kv_decode`` values equal the reference's bit
    for bit, for m2xfp and mxfp4, hd 32 and 128, on normal and heavy-tailed
    data (the reference runs eagerly in this process: the encode has no
    bf16 cast for XLA to drop), and Sg-EM's ``bits`` / ``adaptive``
    arguments pick the reference's codes;
(b) ``kv_page_write`` leaves rows masked out by ``valid`` byte for byte;
(c) ``check_supported`` refuses a codec without a KV path, naming the
    KV-capable ones;
(d) with ``kv_quant`` set, ``decode_step`` / ``prefill_chunk`` logits agree
    with the reference within LOGIT_TOL and the pages after the sequence
    are equal; the engine gives the reference engine's greedy tokens (the
    reference runs in one child per module, as in test_torch_serve.py);
(e) within the port, slot reuse gives each request's tokens served alone,
    and chunked prefill is bit-identical to sequential decode.

Every input stays in the domain "group amax 0 or >= 2^-100": XLA's CPU
runtime flushes a subnormal group maximum, where the port keeps it
(ROADMAP, queue C). The model has hd 64, two KV groups per head, so the
scale and meta streams hold more than one group per head.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from test_torch_serve import (CHUNKS, ENGINE, LENGTHS, LOGIT_TOL, N_NEW,
                              PROMPTS, SEQ, _flatten,
                              check_prefill_chunk_bitexact_vs_decode,
                              check_slot_reuse, reference_serve,
                              run_reference_child)

BASE = dict(name="kv-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, head_dim=64, d_ff=128, vocab_size=97,
            remat=False, quant="serve")
KV = ("m2xfp", "mxfp4")          # kv_quant, and the weights' codec with it
DATA = ("normal", "heavy_tailed")


def _kv_input(data: str, hd: int, seed: int = 0) -> np.ndarray:
    """(B, 1, nkv, hd) f32 K/V rows: normal or heavy-tailed, with one
    all-zero group, one group of a tiny normal scale (2^-90) and a -0.0."""
    rng = np.random.default_rng(seed)
    shape = (4, 1, 3, hd)
    if data == "normal":
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = heavy_tailed(rng, (12, hd)).reshape(shape)
    x[0, 0, 0, :32] = 0.0
    x[1, 0, 1, :32] *= np.float32(2.0 ** -90)
    x[2, 0, 2, 5] = -0.0
    return x


def _ref_codec(fmt):
    from repro.core.codecs import get_codec
    return get_codec(fmt)


def _port_codec(fmt):
    from repro_torch.models.kvquant import kv_codec
    return kv_codec(fmt)


# ---------------------------------------------------------------------------
# (a) encode / decode bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("fmt", KV)
def test_kv_encode_matches_reference(fmt, hd, data):
    x = _kv_input(data, hd)
    want = _ref_codec(fmt).kv_encode(jnp.asarray(x))
    got = _port_codec(fmt).kv_encode(torch.from_numpy(x))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == torch.uint8, name
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("data", DATA + ("random_bytes",))
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("fmt", KV)
def test_kv_decode_matches_reference(fmt, hd, data):
    """The decode of encoded pages, and of random stream bytes (every code,
    meta field and scale byte 2-255), has the reference's bf16 bits. Scale
    bytes 0 and 1 decode small codes to f32 subnormals, which XLA's CPU
    runtime flushes to zero; the encoder writes them only for group maxima
    below 2^-124, outside this file's domain."""
    if data == "random_bytes":
        rng = np.random.default_rng(hd)
        spec = _port_codec(fmt).kv_spec(64, 1, 1, hd, "cpu")
        page = {k: rng.integers(2 if k == "scales" else 0, 256, v.shape,
                                dtype=np.uint8) for k, v in spec.items()}
    else:
        page = {k: np.asarray(v) for k, v in _ref_codec(fmt).kv_encode(
            jnp.asarray(_kv_input(data, hd))).items()}
    want = np.asarray(_ref_codec(fmt).kv_decode(
        {k: jnp.asarray(v) for k, v in page.items()}))
    got = _port_codec(fmt).kv_decode(
        {k: torch.from_numpy(v.copy()) for k, v in page.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("bits,adaptive", [(1, False), (2, False), (2, True),
                                           (3, True)])
def test_sg_em_bits_and_adaptive_match_reference(bits, adaptive):
    from repro.core.dtypes import exp2int
    from repro.core.m2xfp import sg_em_dequant_with_scale as ref_sgem
    from repro.core.scaling import shared_scale_exponent
    from repro_torch.core.m2xfp import sg_em_dequant_with_scale
    xg = heavy_tailed(np.random.default_rng(bits), (64, 128)).reshape(
        64, 4, 32)
    s = np.asarray(exp2int(shared_scale_exponent(
        jnp.abs(jnp.asarray(xg)).max(-1, keepdims=True), "floor")))
    want = ref_sgem(jnp.asarray(xg), jnp.asarray(s), 8, bits=bits,
                    adaptive=adaptive, return_codes=True)
    got = sg_em_dequant_with_scale(
        torch.from_numpy(xg), torch.from_numpy(s), 8, bits=bits,
        adaptive=adaptive, return_codes=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (b) masked page writes, (c) supported codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", KV)
def test_kv_page_write_keeps_masked_rows(fmt):
    from repro_torch.models.kvquant import (
        kv_cache_spec, kv_encode, kv_page_write)
    rng = np.random.default_rng(5)
    page = kv_cache_spec(4, 6, 2, 64, fmt, "cpu")
    for v in page.values():
        v.copy_(torch.from_numpy(rng.integers(0, 256, v.shape,
                                              dtype=np.uint8)))
    before = {k: v.clone() for k, v in page.items()}
    enc = kv_encode(torch.from_numpy(
        rng.standard_normal((4, 1, 2, 64)).astype(np.float32)), fmt)
    slot = torch.tensor([0, 5, 2, 2])
    valid = torch.tensor([True, False, True, False])
    kv_page_write(page, enc, slot, valid)
    for k in page:
        for b in range(4):
            for w in range(6):
                want = enc[k][b, 0] if valid[b] and w == slot[b] \
                    else before[k][b, w]
                assert torch.equal(page[k][b, w], want), (k, b, w)


@pytest.mark.parametrize("kv_quant", ["nvfp4", "no-kv-path", "int4"])
def test_check_supported_names_kv_codecs(kv_quant, monkeypatch):
    """An unknown codec and a registered one without a KV path (nvfp4, or
    one planted here) both raise ValueError listing kv_codecs()."""
    import dataclasses
    from repro_torch.core import codecs
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import check_supported
    m2xfp = codecs.get_codec("m2xfp")
    monkeypatch.setitem(codecs._REGISTRY, "no-kv-path", dataclasses.replace(
        m2xfp, name="no-kv-path", kv_encode=None, kv_decode=None,
        kv_spec=None))
    assert codecs.kv_codecs() == ("m2xfp", "m2xfp_ideal6", "mxfp4")
    cfg = ModelConfig(**BASE, kv_quant=kv_quant)
    with pytest.raises(ValueError, match="KV-capable codecs: m2xfp, "
                                         "m2xfp_ideal6, mxfp4"):
        check_supported(cfg)
    for fmt in KV:
        check_supported(ModelConfig(**BASE, kv_quant=fmt))


@pytest.mark.parametrize("fmt,nbytes", [("m2xfp", 603_979_776),
                                        ("mxfp4", 570_425_344)])
def test_kv_cache_bytes_full_width(fmt, nbytes):
    """chip_smoke's serve traffic (paper-llama2-7b, 8 slots x 512
    positions, 32 layers): the packed pages' bytes, laid out on the "meta"
    device; bf16 pages take 2,147,483,648."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    cfg = get_config("paper-llama2-7b", quant="serve", kv_quant=fmt)
    caches = init_caches(cfg, 8, 512, "meta")
    got = sum(t.nbytes for c in caches["layers"] for kv in ("k", "v")
              for t in c[kv].values())
    assert got == nbytes
    bf16 = init_caches(get_config("paper-llama2-7b"), 8, 512, "meta")
    assert sum(c[kv].nbytes for c in bf16["layers"]
               for kv in ("k", "v")) == 2_147_483_648


# ---------------------------------------------------------------------------
# (d) the model and engine against the reference
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    """Child process: per codec, the reference's packed tree, its engine's
    greedy tokens, and per-position logits with the caches after them."""
    import pickle

    import jax
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import prequantize_params

    params = init_params(jax.random.PRNGKey(0), ModelConfig(**BASE))
    out = {"packed": {}, "tokens": {}, "logits": {}, "caches": {}}
    for fmt in KV:
        cfg = ModelConfig(**BASE, quant_format=fmt, kv_quant=fmt)
        packed = prequantize_params(params, cfg)
        out["packed"][fmt] = _flatten(packed)
        reference_serve(packed, cfg, out, fmt)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


def _port_cfg(fmt):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**BASE, quant_format=fmt, kv_quant=fmt)


def _port_packed(reference, fmt):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference["packed"][fmt], _port_cfg(fmt), "cpu")


def _assert_caches_equal(port, ref):
    """The port's per-layer caches against the reference's, whose leaves
    are stacked on a leading layer axis."""
    for i, layer in enumerate(port["layers"]):
        for name, buf in layer.items():
            streams = buf if isinstance(buf, dict) else {"": buf}
            for s, t in streams.items():
                want = ref["layers"][name][s] if s else ref["layers"][name]
                np.testing.assert_array_equal(
                    t.numpy(), want[i], err_msg=f"layer {i} {name} {s}")


@pytest.mark.parametrize("fmt", KV)
def test_decode_and_prefill_match_reference(reference, fmt):
    from repro_torch.models.model import (
        decode_step, init_caches, prefill_chunk)
    cfg = _port_cfg(fmt)
    params = _port_packed(reference, fmt)
    caches = init_caches(cfg, 2, 16, "cpu")
    assert set(caches["layers"][0]["k"]) == set(
        reference["caches"][f"decode_{fmt}"]["layers"]["k"])
    tokens = torch.from_numpy(SEQ)
    seq = [decode_step(params, cfg, {"tokens": tokens[:, t:t + 1]}, caches,
                       torch.full((2,), t))[:, 0]
           for t in range(SEQ.shape[1])]
    np.testing.assert_allclose(torch.stack(seq, 1).numpy(),
                               reference["logits"][f"decode_{fmt}"],
                               **LOGIT_TOL)
    _assert_caches_equal(caches, reference["caches"][f"decode_{fmt}"])
    caches = init_caches(cfg, 2, 16, "cpu")
    got = prefill_chunk(params, cfg, {"tokens": tokens}, caches,
                        torch.zeros(2, dtype=torch.long),
                        torch.from_numpy(LENGTHS)).numpy()
    want = reference["logits"][f"prefill_{fmt}"]
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **LOGIT_TOL)
    _assert_caches_equal(caches, reference["caches"][f"prefill_{fmt}"])


@pytest.mark.parametrize("fmt", KV)
def test_engine_tokens_match_reference(reference, fmt):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(_port_packed(reference, fmt), _port_cfg(fmt),
                      device="cpu", **ENGINE)
    assert eng.generate(PROMPTS, N_NEW) == reference["tokens"][fmt]
    eng.scheduler.check()


# ---------------------------------------------------------------------------
# (e) slot reuse and chunked prefill within the port
# ---------------------------------------------------------------------------

def test_slot_reuse_matches_requests_served_alone(reference):
    """Slot reuse with a packed m2xfp cache: stale page bytes of evicted
    requests stay, masked by their position track."""
    check_slot_reuse(_port_packed(reference, "m2xfp"), _port_cfg("m2xfp"))


@pytest.mark.parametrize("chunk,lengths", CHUNKS)
@pytest.mark.parametrize("fmt", KV)
def test_prefill_chunk_bitexact_vs_decode(fmt, chunk, lengths):
    check_prefill_chunk_bitexact_vs_decode(_port_cfg(fmt), chunk, lengths)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
