"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``): the registry's Prometheus text and JSONL records, the
``REPRO_OBS`` modes and their errors, the span tracer's Chrome-trace
events, the quantization-health probes and weight sweep, the engine's,
guard's, checkpoint's and trainer's metrics and spans, and the off path.

The registry, tracer, probes, guard, checkpoint and trainer run in this
process against the reference's, on the same calls and seeded inputs.
The reference engine runs in one child (as in test_torch_serve.py: XLA's
excess precision off) under ``REPRO_OBS=1`` on tests/test_serve.py's tiny
model with an m2xfp KV cache; the port's engine serves the same packed
weights under ``REPRO_OBS=1`` and must give the same tokens, the same
metric names and label sets (the GEMM counter's ``backend`` label names
the port's backends: "plain" where the reference has "xla", "cuda" where
it has "pallas"), the same step, token, element, group, clip,
saturation and metadata counts and the same spans.
"""
import json
import os
import pickle
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_serve import _flatten, run_reference_child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(name="serve-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=97, remat=False,
            quant="serve", kv_quant="m2xfp")
ENGINE = dict(n_slots=2, max_len=32, prefill_chunk=4)
PROMPTS = [[94, 94, 95, 36, 16], [89, 10, 25, 13, 30, 51, 11, 77, 23],
           [76, 30, 76]]
N_NEW = 6
FORMATS = ("m2xfp", "mxfp4")
# the weight sweep's re-encode drift is a ratio of two f32 means, which
# the packages reduce in other orders: within 2^-20 of the larger
DRIFT_RTOL = 2.0 ** -20
# the GEMM counter's backend label: the reference's name -> the port's
BACKEND = {"xla": "plain", "pallas": "cuda"}


# ---------------------------------------------------------------------------
# The reference engine, run in a child process
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    """Child: the reference's packed trees and weight sweeps (m2xfp,
    mxfp4), then its engine under REPRO_OBS=1 with the registry's snapshot
    and text, the tracer's events, tokens, stats and guard summary."""
    os.environ["REPRO_OBS"] = "1"
    os.environ.pop("REPRO_OBS_DIR", None)
    import jax
    from repro import obs
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import ServeEngine, prequantize_params

    params = init_params(jax.random.PRNGKey(0), ModelConfig(**BASE))
    out = {"packed": {}, "health": {}, "health_text": {}}
    packed = {}
    for fmt in FORMATS:
        cfg = ModelConfig(**BASE, quant_format=fmt)
        packed[fmt] = prequantize_params(params, cfg)
        out["packed"][fmt] = _flatten(packed[fmt])
        obs.reset()
        out["health"][fmt] = obs.quant_health.weight_tree_health(packed[fmt])
        out["health_text"][fmt] = obs.registry().render_prometheus()
    obs.reset()
    cfg = ModelConfig(**BASE, quant_format="m2xfp")
    eng = ServeEngine(packed["m2xfp"], cfg, **ENGINE)
    out["tokens"] = eng.generate(PROMPTS, N_NEW)
    jax.effects_barrier()
    out["snapshot"] = obs.registry().snapshot()
    out["events"] = obs.tracer().events()
    out["stats"] = eng.stats.to_dict()
    out["guard"] = eng.guard_summary()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops: the intra-op pool costs more than it saves when the
    other test workers hold every core (as in test_torch_moe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every test starts with observability off and empty buffers, in both
    packages."""
    from repro_torch import obs
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    obs.reset()
    yield
    obs.reset()


def _ref_obs():
    from repro import obs as ref_obs
    ref_obs.reset()
    return ref_obs


def _port_cfg(fmt="m2xfp", **kw):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{**BASE, **kw}, quant_format=fmt)


def _port_packed(reference, fmt="m2xfp"):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference["packed"][fmt], _port_cfg(fmt), "cpu")


def _engine(packed, cfg=None, **kw):
    from repro_torch.serve import ServeEngine
    return ServeEngine(packed, cfg or _port_cfg(), device="cpu",
                       **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's engine on the reference's packed weights under
    REPRO_OBS=1: tokens, snapshot, events, stats, guard summary."""
    from repro_torch import obs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OBS", "1")
        mp.delenv("REPRO_OBS_DIR", raising=False)
        obs.reset()
        eng = _engine(_port_packed(reference))
        tokens = eng.generate(PROMPTS, N_NEW)
        run = dict(tokens=tokens, snapshot=obs.registry().snapshot(),
                   events=obs.tracer().events(), stats=eng.stats.to_dict(),
                   guard=eng.guard_summary())
        obs.reset()
    return run


def _by_metric(snapshot, mapped: bool = False) -> dict:
    """{metric name: {label tuple: record}}; ``mapped`` renames the
    reference's GEMM backends to the port's."""
    out = {}
    for rec in snapshot:
        labels = dict(rec["labels"])
        if mapped and rec["name"] == "repro_serve_gemm_traces_total":
            labels["backend"] = BACKEND[labels["backend"]]
        out.setdefault(rec["name"], {})[
            tuple(sorted(labels.items()))] = rec
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_counter_labels_and_monotonicity():
    from repro_torch import obs
    c = obs.counter("t_total", "help text")
    c.inc()
    c.inc(2.5, site="a")
    c.inc(site="a")
    assert c.value() == 1.0
    assert c.value(site="a") == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_add_and_kind_mismatch():
    from repro_torch import obs
    g = obs.gauge("t_gauge")
    g.set(2.0, k="x")
    g.add(0.5, k="x")
    assert g.value(k="x") == 2.5
    assert g.value() == 0.0                    # unseen label set
    with pytest.raises(TypeError):
        obs.counter("t_gauge")


def test_histogram_cumulative_buckets():
    from repro_torch import obs
    h = obs.histogram("t_hist", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0, 0.1):
        h.observe(v)
    snap = h.snapshot()
    assert snap["buckets"] == {"1.0": 2, "10.0": 3, "+Inf": 4}
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(55.6)
    with pytest.raises(ValueError, match="needs >= 1 bucket"):
        obs.histogram("t_empty", buckets=())


def _registry_calls(reg) -> None:
    """One call sequence for either package's MetricsRegistry: labels that
    need escaping, float and integer bucket bounds, help text given on the
    first call only, a metric never sampled."""
    reg.counter("t_req_total", "requests").inc(3, route="/v1")
    reg.counter("t_req_total").inc(route='a"b\\c\nd')
    reg.counter("t_req_total").inc(0.25)
    reg.gauge("t_temp", "temperature").set(-1.5, zone="z1", rack=7)
    reg.gauge("t_temp").add(2, zone="z1", rack=7)
    reg.gauge("t_unsampled", "never set")
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.5, 1.0, 3.0):
        h.observe(v, phase="p")
    h.observe(0.2)
    reg.histogram("t_steps", buckets=(1, 2, 4)).observe(3)


def test_prometheus_text_equals_reference():
    from repro.obs.registry import MetricsRegistry as RefRegistry
    from repro_torch.obs.registry import MetricsRegistry
    ref, port = RefRegistry(), MetricsRegistry()
    _registry_calls(ref)
    _registry_calls(port)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert 't_req_total{route="a\\"b\\\\c\\nd"} 1.0' in text
    assert 't_lat_seconds_bucket{phase="p",le="2.5"} 3' in text
    assert 't_steps_bucket{le="4"} 1' in text
    assert "t_unsampled" not in text
    assert MetricsRegistry().render_prometheus() == ""


def test_jsonl_equals_reference_modulo_timestamps(tmp_path):
    from repro.obs.registry import MetricsRegistry as RefRegistry
    from repro_torch.obs.registry import MetricsRegistry
    ref, port = RefRegistry(), MetricsRegistry()
    _registry_calls(ref)
    _registry_calls(port)
    paths = {}
    for name, reg in (("ref", ref), ("port", port)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        assert reg.dump_jsonl(paths[name]) == reg.dump_jsonl(paths[name])
    recs = {}
    for name, path in paths.items():
        lines = [json.loads(ln) for ln in open(path)]
        assert all(isinstance(r.pop("ts"), float) for r in lines)
        recs[name] = lines
    assert recs["port"] == recs["ref"]
    assert len(recs["port"]) == 2 * 7          # appended twice


@pytest.mark.parametrize("raw", [None, "", "0", "1", "metrics", "trace",
                                 "health", "metrics,trace", " trace , ",
                                 "metrics,health,trace"])
def test_enabled_modes_equal_reference(monkeypatch, raw):
    from repro_torch import obs
    ref_obs = _ref_obs()
    if raw is None:
        monkeypatch.delenv("REPRO_OBS", raising=False)
    else:
        monkeypatch.setenv("REPRO_OBS", raw)
    for p in obs.PILLARS + ("other",):
        assert obs.enabled(p) == ref_obs.enabled(p), p
    assert obs.pillars() == frozenset(p for p in obs.PILLARS
                                      if ref_obs.enabled(p))
    assert obs.PILLARS == ref_obs.PILLARS
    assert obs.DEFAULT_LATENCY_BUCKETS == ref_obs.DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize("raw", ["metrcs", "metrics,bogus", "1,trace"])
def test_unknown_pillar_error_equals_reference(monkeypatch, raw):
    from repro_torch import obs
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", raw)
    with pytest.raises(ValueError, match="unknown pillar") as port_err:
        obs.enabled()
    with pytest.raises(ValueError) as ref_err:
        ref_obs.enabled()
    assert str(port_err.value) == str(ref_err.value)


def test_envflags_reads_equal_reference(monkeypatch):
    from repro.core import envflags as ref_flags
    from repro_torch import obs
    from repro_torch.core import envflags
    assert [f.name for f in envflags.defined_flags()] == \
        ["REPRO_ATTN_KV_CHUNK", "REPRO_ATTN_Q_TILE", "REPRO_BF16_TP_REDUCE",
         "REPRO_GATHER_PACKED", "REPRO_KV_QUANT", "REPRO_MOE_GROUP",
         "REPRO_OBS", "REPRO_OBS_DIR", "REPRO_REMAT_POLICY",
         "REPRO_RULES_JSON"]
    ref_specs = {f.name: f for f in ref_flags.defined_flags()}
    for f in envflags.defined_flags():     # each as the reference declares
        r = ref_specs[f.name]
        assert (f.kind, f.default, f.choices, f.minimum) == \
            (r.kind, r.default, r.choices, r.minimum), f.name
    for name in ("REPRO_OBS", "REPRO_OBS_DIR"):
        port_flag = {f.name: f for f in envflags.defined_flags()}[name]
        ref_flag = {f.name: f for f in ref_flags.defined_flags()}[name]
        assert (port_flag.kind, port_flag.default) == \
            (ref_flag.kind, ref_flag.default) == ("str", "")
        for raw in (None, "", "x", "/tmp/d"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
            assert envflags.get_raw(name) == ref_flags.get_raw(name)
            assert envflags.get_str(name) == ref_flags.get_str(name)
            assert obs.obs_dir() == _ref_obs().obs_dir()
    with pytest.raises(KeyError, match="not declared"):
        envflags.get_raw("REPRO_NOT_A_FLAG")
    with pytest.raises(ValueError, match="different spec"):
        envflags.declare("REPRO_OBS", "str", "1", "other")
    envflags.declare("REPRO_OBS", "str", *[
        (f.default, f.help) for f in envflags.defined_flags()
        if f.name == "REPRO_OBS"][0])                  # same spec: no-op


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_spans_disabled_record_nothing():
    from repro_torch import obs
    first = obs.span("t.outer")
    assert obs.span("t.other", cat="x", k=1) is first   # one shared no-op
    with first:
        with obs.span("t.inner"):
            pass
    obs.instant("t.mark")
    assert obs.tracer().events() == []


def _span_calls(obs) -> None:
    with obs.span("t.outer", cat="t", job=1):
        with obs.span("t.inner", cat="t"):
            obs.instant("t.mark", rid=3)
    with obs.span("t.after"):
        pass


def test_span_events_and_export_equal_reference(monkeypatch, tmp_path):
    from repro_torch import obs
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "trace")
    _span_calls(obs)
    _span_calls(ref_obs)
    evs = obs.tracer().events()
    timing = {"ts", "dur", "pid", "tid"}
    assert [{k: v for k, v in e.items() if k not in timing} for e in evs] \
        == [{k: v for k, v in e.items() if k not in timing}
            for e in ref_obs.tracer().events()]
    assert [sorted(e) for e in evs] == \
        [sorted(e) for e in ref_obs.tracer().events()]
    mark, inner, outer, after = evs
    assert outer["ts"] <= inner["ts"] <= mark["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["tid"] == outer["tid"] and outer["ph"] == "X"
    assert outer["args"] == {"job": 1} and mark["ph"] == "i"
    assert after["ts"] >= outer["ts"] + outer["dur"] - 1e-6

    docs = {}
    for name, pkg in (("port", obs), ("ref", ref_obs)):
        path = str(tmp_path / f"{name}.json")
        assert pkg.export_chrome_trace(path) == 4
        docs[name] = json.load(open(path))
    assert sorted(docs["port"]) == sorted(docs["ref"])
    assert docs["port"]["traceEvents"][0] == {
        **docs["ref"]["traceEvents"][0], "pid": os.getpid()}
    ref_obs.reset()


# ---------------------------------------------------------------------------
# quantization health: probes
# ---------------------------------------------------------------------------

def _heavy(rng, shape) -> np.ndarray:
    """Heavy-tailed f32 with outlier columns, a zero group and groups with
    scales far from 1. (No finite input in the domain the packages agree
    on, group amax 0 or >= 2^-100, reaches an E8M0 bound under the floor
    rule: the saturation counters stay 0 in both.)"""
    x = rng.standard_normal(shape).astype(np.float32) * np.exp(
        rng.standard_normal(shape[-1]).astype(np.float32))
    x[..., ::29] *= 40.0
    x[0, :32] = 0.0
    x[1, :32] *= 2.0 ** -90
    x[2, 32:64] *= 2.0 ** 100
    return x


@pytest.mark.parametrize("codec", ["m2xfp", "mxfp4", "m2xfp_ideal6",
                                   "nvfp4"])
def test_probe_act_equals_reference(monkeypatch, codec):
    import jax
    import jax.numpy as jnp
    from repro_torch import obs
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "health")
    x = _heavy(np.random.default_rng(5), (6, 256))
    for site in ("a", "b", "a"):
        obs.quant_health.probe_act(torch.from_numpy(x), site, codec)
        ref_obs.quant_health.probe_act(jnp.asarray(x), site, codec)
    assert obs.registry().render_prometheus() == ""    # still pending
    obs.quant_health.flush()
    jax.effects_barrier()
    text = obs.registry().render_prometheus()
    assert text == ref_obs.registry().render_prometheus()
    if codec == "nvfp4":                       # E4M3 scales: no probe
        assert text == ""
    else:
        assert obs.counter("repro_quant_clipped_total").value(
            site="a", codec=codec) > 0
        assert obs.counter("repro_quant_elems_total").value(
            site="a", codec=codec) == 2 * x.size
    ref_obs.reset()


def _encoders(pkg: str):
    """(site, callable on a (rows, 256) f32 array) of the encoders that
    probe their scaled values, in package ``pkg``."""
    if pkg == "port":
        from repro_torch.core import codecs, m2xfp
        conv = torch.from_numpy
    else:
        import jax.numpy as jnp
        from repro.core import codecs, m2xfp
        conv = jnp.asarray
    return [
        ("encode_act", lambda x: m2xfp.encode_act_m2xfp(conv(x))),
        ("encode_weight", lambda x: m2xfp.encode_weight_m2xfp(conv(x))),
        ("kv_encode_m2xfp",
         lambda x: codecs._kv_encode_sgem(conv(x).reshape(2, -1, 64))),
        ("kv_encode_mxfp4",
         lambda x: codecs._kv_encode_mxfp4(conv(x).reshape(2, -1, 64))),
    ]


@pytest.mark.parametrize("index", range(4),
                         ids=["encode_act", "encode_weight",
                              "kv_encode_m2xfp", "kv_encode_mxfp4"])
def test_probe_scaled_equals_reference(monkeypatch, index):
    import jax
    from repro_torch import obs
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "health")
    x = _heavy(np.random.default_rng(6), (6, 256))
    _encoders("port")[index][1](x)
    _encoders("ref")[index][1](x)
    obs.quant_health.flush()
    jax.effects_barrier()
    text = obs.registry().render_prometheus()
    assert text and text == ref_obs.registry().render_prometheus()
    ref_obs.reset()


def test_probe_buffer_holds_device_stats_until_the_copy(monkeypatch):
    """A probe leaves one int64 (7,) tensor in the active buffer; the
    registry sees it only when the buffer's owner copies it."""
    from repro_torch import obs
    from repro_torch.obs import quant_health
    monkeypatch.setenv("REPRO_OBS", "health")
    buf = quant_health.ProbeBuffer()
    x = torch.from_numpy(_heavy(np.random.default_rng(7), (4, 64)))
    with quant_health.collect(buf):
        quant_health.probe_act(x, "s")
    keys, stats = buf.take()
    assert keys == [("s", "m2xfp", x.numel(), x.numel() // 32)]
    assert [(t.dtype, tuple(t.shape)) for t in stats] == \
        [(torch.int64, (7,))]
    assert obs.registry().render_prometheus() == ""
    assert buf.take() == ([], [])
    quant_health.ProbeBuffer.deliver(keys, torch.stack(stats).numpy())
    n, groups, want = quant_health.act_stats(x)
    assert torch.equal(stats[0], want)
    assert obs.counter("repro_quant_elems_total").value(
        site="s", codec="m2xfp") == n


def test_e8m0_bounds_constants():
    from repro.obs import quant_health as ref_qh
    from repro_torch.obs import quant_health
    assert (quant_health.E8M0_BYTE_LOW, quant_health.E8M0_BYTE_HIGH) == \
        (ref_qh.E8M0_BYTE_LOW, ref_qh.E8M0_BYTE_HIGH) == (1, 254)


def test_act_reencode_drift_equals_reference():
    from repro.obs import quant_health as ref_qh
    from repro_torch.obs import quant_health
    x = np.random.default_rng(4).standard_normal((8, 64)).astype(np.float32)
    for fmt in ("m2xfp", "mxfp4"):
        got, want = (quant_health.act_reencode_drift(x, fmt),
                     ref_qh.act_reencode_drift(x, fmt))
        assert got < 1e-3
        assert abs(got - want) <= DRIFT_RTOL * max(got, want) + 1e-30


# ---------------------------------------------------------------------------
# quantization health: the weight sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_weight_tree_health_equals_reference(monkeypatch, reference, fmt):
    """Same layer keys in the same order, elements, groups, clip,
    saturation and metadata rates equal; drift within DRIFT_RTOL; the
    gauges as the reference's except the drift gauge's values."""
    from repro_torch import obs
    from repro_torch.obs import quant_health
    monkeypatch.setenv("REPRO_OBS", "health")
    got = quant_health.weight_tree_health(_port_packed(reference, fmt))
    want = reference["health"][fmt]
    assert list(got) == list(want)
    assert "layers/attn/wq[1]" in got
    for layer, st in got.items():
        ref_st = dict(want[layer])
        drift, ref_drift = st.pop("reencode_drift"), \
            ref_st.pop("reencode_drift")
        assert st == ref_st, layer
        assert abs(drift - ref_drift) <= DRIFT_RTOL * max(drift, ref_drift)
    strip = [ln for ln in reference["health_text"][fmt].splitlines()
             if not ln.startswith("repro_quant_reencode_drift{")]
    text = [ln for ln in obs.registry().render_prometheus().splitlines()
            if not ln.startswith("repro_quant_reencode_drift{")]
    assert text == strip


def test_weight_tree_health_without_drift_and_flat_keys():
    from repro_torch.models.quant import pack_serving_weight
    from repro_torch.obs import quant_health
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 16)).astype(np.float32) * 0.1)
    report = quant_health.weight_tree_health(
        {"layer0": pack_serving_weight(w)}, drift=False)
    st = report["layer0"]
    assert st["elems"] == w.numel() and "reencode_drift" not in st
    assert sum(st["meta_hist"]) == 4 * st["groups"]
    assert quant_health.weight_tree_health({"x": w}) == {}


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_engine_tokens_and_stats_equal_reference(reference, port_run):
    assert port_run["tokens"] == reference["tokens"]
    assert port_run["guard"] == reference["guard"]
    for key in ("steps", "decode_steps", "prefill_steps", "slot_steps",
                "prefill_tokens", "generated_tokens", "quarantined"):
        assert port_run["stats"][key] == reference["stats"][key], key


def test_engine_metric_names_and_label_sets_equal_reference(reference,
                                                            port_run):
    got = _by_metric(port_run["snapshot"])
    want = _by_metric(reference["snapshot"], mapped=True)
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
    assert ("backend", "plain") in next(iter(
        got["repro_serve_gemm_traces_total"]))


# metrics whose values depend on the host's clock
TIMED = {"repro_serve_step_latency_seconds"}
# the drift gauge: within DRIFT_RTOL (f32 means in other orders)
DRIFTS = {"repro_quant_reencode_drift"}


def test_engine_metric_values_equal_reference(reference, port_run):
    """Counters, gauges and histograms equal the reference's: steps,
    tokens, requests, the GEMM call sites, every probe's elements, groups,
    clipped elements, saturated groups and metadata codes (the activations
    agree to f32 accumulation order, and no element of this model's run
    lies at a rounding edge, so the counts are equal, not close), the
    guard's state, queue, slots and occupancy, the TTFT histogram, and the
    step-latency histogram's counts."""
    got = _by_metric(port_run["snapshot"])
    want = _by_metric(reference["snapshot"], mapped=True)
    for name, recs in want.items():
        for labels, rec in recs.items():
            mine = got[name][labels]
            if name in TIMED:
                assert mine["count"] == rec["count"], (name, labels)
            elif name in DRIFTS:
                assert abs(mine["value"] - rec["value"]) <= DRIFT_RTOL * \
                    max(mine["value"], rec["value"]), (name, labels)
            elif rec["type"] == "histogram":
                assert (mine["buckets"], mine["sum"], mine["count"]) == \
                    (rec["buckets"], rec["sum"], rec["count"]), name
            else:
                assert mine["value"] == rec["value"], (name, labels)
    steps = got["repro_serve_steps_total"]
    assert sum(r["value"] for r in steps.values()) == \
        port_run["stats"]["steps"]
    elems = got["repro_quant_elems_total"][
        (("codec", "m2xfp"), ("site", "serve_gemm"))]["value"]
    rows = 2 * port_run["stats"]["decode_steps"] + \
        2 * 4 * port_run["stats"]["prefill_steps"]        # B x T a launch
    assert elems == rows * (4 * 64 + 2 * 64 + 128) * 2    # 7 GEMMs, 2 layers


def test_engine_spans_equal_reference(reference, port_run):
    """The same spans and instants, as many of each, with the same
    arguments for the GEMM call sites; step > phase > dispatch nest."""
    names = Counter(e["name"] for e in port_run["events"])
    assert names == Counter(e["name"] for e in reference["events"])
    assert names["trace.serve_matmul"] == 14       # 7 sites x 2 launches

    def gemm_args(events, mapped):
        out = []
        for e in events:
            if e["name"] == "trace.serve_matmul":
                a = dict(e["args"])
                a["backend"] = BACKEND[a["backend"]] if mapped \
                    else a["backend"]
                out.append(tuple(sorted(a.items())))
        return Counter(out)
    assert gemm_args(port_run["events"], False) == \
        gemm_args(reference["events"], True)

    def contains(outer, inner):
        return (outer["ts"] <= inner["ts"] + 1e-6 and
                inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
                + 1e-6 and outer["tid"] == inner["tid"])
    spans = [e for e in port_run["events"] if e["ph"] == "X"]
    for disp in (e for e in spans if e["name"] == "serve.kernel.dispatch"):
        phase = next(p for p in spans if p["name"].startswith("serve.phase")
                     and contains(p, disp))
        assert any(s["name"] == "serve.step" and contains(s, phase)
                   for s in spans)


def test_obs_off_bit_identical_tokens(monkeypatch, reference):
    """REPRO_OBS unset, "metrics,trace" and "1" give the same tokens."""
    from repro_torch import obs
    packed = _port_packed(reference)
    outs = {}
    for mode in (None, "metrics,trace", "1"):
        if mode is None:
            monkeypatch.delenv("REPRO_OBS", raising=False)
        else:
            monkeypatch.setenv("REPRO_OBS", mode)
        obs.reset()
        outs[mode] = _engine(packed).generate(PROMPTS, N_NEW)
    assert outs[None] == outs["metrics,trace"] == outs["1"]
    assert "repro_serve_steps_total" in obs.registry().render_prometheus()


def _forbid_probes(monkeypatch):
    """Every probe and sweep internal raises if it runs."""
    from repro_torch.obs import quant_health

    def boom(*a, **k):
        raise AssertionError("a probe internal ran")
    for name in ("act_stats", "_scaled_stats", "_stream_counts",
                 "_layer_drift"):
        monkeypatch.setattr(quant_health, name, boom)


def test_obs_off_runs_no_probe_and_records_nothing(monkeypatch, reference):
    from repro_torch import obs
    from repro_torch.models import quant
    _forbid_probes(monkeypatch)

    def boom(*a, **k):
        raise AssertionError("the GEMM site bookkeeping ran")
    monkeypatch.setattr(quant, "_first_at_site", boom)
    eng = _engine(_port_packed(reference))
    eng.generate(PROMPTS, 2)
    assert obs.registry().render_prometheus() == ""
    assert obs.tracer().events() == []
    assert eng._probes.take() == ([], [])


def test_host_pillars_run_no_probe(monkeypatch, reference):
    """The metrics and trace pillars are host-only: no probe runs, and the
    engine records its metrics and spans."""
    from repro_torch import obs
    _forbid_probes(monkeypatch)
    monkeypatch.setenv("REPRO_OBS", "metrics,trace")
    _engine(_port_packed(reference)).generate(PROMPTS, 2)
    text = obs.registry().render_prometheus()
    assert "repro_serve_steps_total" in text
    assert "repro_quant_" not in text
    assert any(e["name"] == "serve.kernel.dispatch"
               for e in obs.tracer().events())


def test_serve_gemm_sites_counted_per_launch_kind(monkeypatch, reference):
    """In an engine, each GEMM call site counts once per launch kind (a
    second engine counts again, as the reference retraces); outside one,
    every call counts (an eager reference call traces every time)."""
    from repro_torch import obs
    from repro_torch.models.quant import quantized_matmul
    monkeypatch.setenv("REPRO_OBS", "metrics")
    packed = _port_packed(reference)
    c = obs.counter("repro_serve_gemm_traces_total")
    labels = dict(backend="plain", codec="m2xfp", k=64, n=32)
    _engine(packed).generate(PROMPTS, 2)
    assert c.value(**labels) == 4                 # wk, wv x 2 launch kinds
    _engine(packed).generate(PROMPTS[:1], 2)
    assert c.value(**labels) == 8
    wk = packed["layers"][0]["attn"]["wk"]
    for _ in range(3):
        quantized_matmul(torch.zeros(1, 64, dtype=torch.bfloat16), wk,
                         "serve")
    assert c.value(**labels) == 11


def test_autodump_writes_obs_dir(monkeypatch, tmp_path, reference):
    from repro_torch import obs
    monkeypatch.setenv("REPRO_OBS", "1")
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path / "dump"))
    _engine(_port_packed(reference), _port_cfg(kv_quant="none")).generate(
        PROMPTS, 2)
    recs = [json.loads(ln) for ln in open(tmp_path / "dump" /
                                          "metrics.jsonl")]
    assert {"repro_serve_steps_total", "repro_quant_elems_total"} <= \
        {r["name"] for r in recs}
    doc = json.load(open(tmp_path / "dump" / "trace.json"))
    assert any(e["name"] == "serve.run" for e in doc["traceEvents"])
    monkeypatch.setenv("REPRO_OBS", "0")
    assert obs.autodump() == {}


# ---------------------------------------------------------------------------
# guard, checkpoint and trainer metrics
# ---------------------------------------------------------------------------

def _guard_calls(guard_cls, cfg_cls) -> None:
    g = guard_cls(cfg_cls(watchdog_s=0.0, max_quarantines=1))
    g.record_shed("queue_full")
    g.record_expired("queued", 2)
    g.record_quarantine("kv")
    g.note_step(1.0)                           # watchdog trip, degraded
    g.record_scrub("logits")
    g.record_retry()
    g.record_quarantine("logits")              # over budget: FAILED
    g.note_step(1.0)


def test_guard_metrics_equal_reference(monkeypatch):
    from repro.serve import guard as ref_guard
    from repro_torch import obs
    from repro_torch.serve import guard
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "metrics")
    _guard_calls(guard.EngineGuard, guard.GuardConfig)
    _guard_calls(ref_guard.EngineGuard, ref_guard.GuardConfig)
    text = obs.registry().render_prometheus()
    assert text == ref_obs.registry().render_prometheus()
    assert "repro_guard_health_state 2.0" in text
    assert 'repro_guard_quarantine_total{site="kv"} 1.0' in text
    ref_obs.reset()


def test_stream_validation_metrics_equal_reference(monkeypatch):
    import jax.numpy as jnp
    from repro.models.quant import pack_serving_weight as ref_pack
    from repro.serve import guard as ref_guard
    from repro_torch import obs
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.serve import guard
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "metrics")
    w = np.random.default_rng(2).standard_normal((64, 16)).astype(
        np.float32)
    ref_p = ref_pack(jnp.asarray(w))
    bad = np.asarray(ref_p.streams["scales"]).copy()
    bad[0, 3] = 255
    ref_p = type(ref_p)({**ref_p.streams, "scales": jnp.asarray(bad)},
                        ref_p.shape, ref_p.codec)
    port_p = PackedTensor({k: torch.from_numpy(np.asarray(v).copy())
                           for k, v in ref_p.streams.items()},
                          ref_p.shape, ref_p.codec)
    assert guard.verify_packed_tree({"w": port_p})[1] == \
        ref_guard.verify_packed_tree({"w": ref_p})[1] == [("w", "clamp")]
    text = obs.registry().render_prometheus()
    assert text == ref_obs.registry().render_prometheus()
    assert 'repro_guard_stream_invalid_total{stage="weights"} 1.0' in text
    ref_obs.reset()


def test_checkpoint_spans_equal_reference(monkeypatch, tmp_path):
    from repro.checkpoint import restore_state as ref_restore, \
        save_state as ref_save
    from repro_torch import obs
    from repro_torch.checkpoint import restore_state, save_state
    ref_obs = _ref_obs()
    monkeypatch.setenv("REPRO_OBS", "trace")
    leaves = {"a": np.arange(6, dtype=np.float32)}
    save_state(str(tmp_path / "port"), 3, leaves)
    restore_state(str(tmp_path / "port"), leaves)
    restore_state(str(tmp_path / "port"), leaves, step=3)
    ref_save(str(tmp_path / "ref"), 3, leaves)
    ref_restore(str(tmp_path / "ref"), leaves)
    ref_restore(str(tmp_path / "ref"), leaves, step=3)

    def strip(events, root):
        return [(e["name"], e["cat"], {**e["args"], "dir": os.path.relpath(
            e["args"]["dir"], root)}) for e in events]
    got = strip(obs.tracer().events(), tmp_path / "port")
    assert got == strip(ref_obs.tracer().events(), tmp_path / "ref")
    assert [g[0] for g in got] == ["checkpoint.save", "checkpoint.restore",
                                   "checkpoint.restore"]
    assert got[1][2]["step"] == -1
    ref_obs.reset()


def test_publish_train_metrics_equals_reference(monkeypatch):
    import jax.numpy as jnp
    from repro.train.trainer import publish_train_metrics as ref_publish
    from repro_torch import obs
    from repro_torch.train import publish_train_metrics
    ref_obs = _ref_obs()
    vals = dict(loss=2.718281828, grad_norm=0.5, lr=3e-4)
    publish_train_metrics({k: torch.tensor(v) for k, v in vals.items()})
    assert obs.registry().render_prometheus() == ""      # off: nothing
    monkeypatch.setenv("REPRO_OBS", "metrics")
    for step in (0, 20):
        publish_train_metrics(
            {**{k: torch.tensor(v) for k, v in vals.items()},
             "hist": torch.ones(3), "note": "x", "count": 7}, step=step)
        ref_publish({**{k: jnp.asarray(v, jnp.float32)
                        for k, v in vals.items()},
                     "hist": jnp.ones(3), "note": "x", "count": 7},
                    step=step)
    text = obs.registry().render_prometheus()
    assert text == ref_obs.registry().render_prometheus()
    assert "repro_train_steps_total 2.0" in text
    assert "repro_train_hist" not in text and "repro_train_count" in text
    ref_obs.reset()


# ---------------------------------------------------------------------------
# the report script
# ---------------------------------------------------------------------------

def test_obs_report_renders_dump(monkeypatch, tmp_path):
    from repro_torch import obs
    monkeypatch.setenv("REPRO_OBS", "1")
    obs.counter("repro_demo_total", "demo").inc(5, site="x")
    obs.histogram("repro_demo_seconds", "demo",
                  buckets=(0.1, 1.0)).observe(0.5)
    obs.gauge("repro_quant_clip_rate", "").set(
        0.25, layer="l0", kind="weight")
    with obs.span("demo.work", cat="demo"):
        pass
    d = str(tmp_path / "dump")
    obs.dump(d)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "obs_report.py"), d],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "repro_demo_total{site=x} = 5" in out
    assert "count=1" in out and "p50=" in out
    assert "top clip-rate layers" in out and "l0" in out
    assert "demo.work" in out


if __name__ == "__main__":
    _reference_main(sys.argv[1])
