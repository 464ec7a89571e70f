"""The port's serving guard, packed-stream validation and fault harness
against the reference's.

One child per module (the reference, run as in test_torch_serve.py) builds
the reference's tiny fault-test model (tests/test_faults.py's ``_cfg``,
m2xfp weights) and serves it under each entry of ``CASES``, with an m2xfp
or a bf16 KV cache, recording every request's tokens, state and reason,
``guard_summary()``, the integer ``ServeStats`` fields and what the
injector fired. The port's engine, on the same packed weights under the
same ``FaultPlan``, must record the same. The child also plants damaged
bytes in the packed weights (``PLANTS``) and records
``validate_packed_tree``'s report and ``verify_packed_tree``'s repairs,
repaired streams and errors; saves a packed checkpoint with a poisoned
scale byte (its CRC passes, ``validate_streams`` must catch it); and
corrupts and truncates copies of a clean checkpoint with the harness. The
port must give the same strings and bytes.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_serve import _assert_same_tree, _flatten, run_reference_child

BASE = dict(name="fault-test", family="dense", n_layers=2, d_model=64,
            n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=97, remat=False,
            quant="serve")
RUN = dict(n_slots=4, max_len=32, prefill_chunk=4)

# name -> how to drive the engine: ``kv`` the KV cache ("m2xfp" or "none"
# for bf16), ``plan`` FaultPlan fields or ``chaos`` a chaos_plan seed,
# ``engine`` extra ServeEngine arguments (n_slots stays 4: the child
# compiles one engine's launches per KV cache), ``n`` / ``tokens`` the
# traffic, ``shed`` one submission past a full queue, ``reuse`` the first
# prompt served again after the run (it lands on the scrubbed slot),
# ``persistent`` a launch that always raises TransientStepError.
CASES = {
    "clean": dict(kv="m2xfp"),
    "clean_bf16": dict(kv="none"),
    "nan_logits": dict(kv="m2xfp", plan=dict(seed=1,
                                             nan_logit_steps=((4, 2),))),
    "kv_scale_255": dict(kv="m2xfp", plan=dict(seed=1,
                                               kv_poison_steps=((3, 1),))),
    "kv_nan_bf16": dict(kv="none", plan=dict(seed=1,
                                             kv_poison_steps=((3, 1),))),
    "kv_and_nan": dict(kv="m2xfp", plan=dict(
        seed=1, kv_poison_steps=((3, 1),), nan_logit_steps=((4, 2),))),
    "kv_and_nan_bf16": dict(kv="none", plan=dict(
        seed=1, kv_poison_steps=((3, 1),), nan_logit_steps=((4, 2),))),
    "retry": dict(kv="m2xfp", plan=dict(seed=3, fail_steps=(2,))),
    "reuse": dict(kv="m2xfp", plan=dict(seed=2, kv_poison_steps=((3, 0),)),
                  reuse=True),
    "reuse_bf16": dict(kv="none", plan=dict(seed=2,
                                            kv_poison_steps=((3, 0),)),
                       reuse=True),
    "deadline_and_shed": dict(kv="m2xfp", shed=True, n=6, engine=dict(
        max_queue=6, default_ttl_steps=3)),
    "persistent_failure": dict(kv="m2xfp", persistent=True),
    **{f"chaos_{s}": dict(kv="m2xfp", chaos=s, n=8, tokens=6)
       for s in (7, 11, 23)},
}
# Port only (the reference's guard=False tokens are test_torch_serve's).
GUARD_OFF = dict(kv="m2xfp", engine=dict(guard=False))

# name -> damage planted in the reference's layer-stacked packed weights:
# (key, stream, index, byte), the index's first entry being the layer, or
# (key, "codes", "truncate", None): every layer's code stream one row short.
PLANTS = {
    "scale_255": [("layers/attn/wq", "scales", (1, 0, 5), 255)],
    "scale_0": [("layers/ffn/down", "scales", (0, 2, 7), 0)],
    "two_weights": [("layers/ffn/up", "scales", (1, 1, 9), 255),
                    ("layers/ffn/up", "scales", (0, 1, 2), 0),
                    ("layers/ffn/up", "scales", (1, 0, 0), 255),
                    ("layers/attn/wo", "scales", (1, 1, 1), 255)],
    "truncated_codes": [("layers/attn/wk", "codes", "truncate", None)],
}
CORRUPT = [dict(seed=11), dict(seed=3, leaf="layers/attn/wq/.codes")]


def _prompts(n, length=6):
    return [[(7 * i + j) % 97 for j in range(length)] for i in range(n)]


def drive(api, make_engine, case: dict) -> dict:
    """Serve ``case`` with one package's engine (``make_engine(kv, **kw)``)
    and harness (``api``: FaultPlan, FaultInjector, chaos_plan,
    GuardConfig, AdmissionError, EngineFailedError, TransientStepError).
    Returns what the two packages must agree on."""
    if case.get("persistent"):
        eng = make_engine(case["kv"], n_slots=2, max_len=32,
                          guard=api.GuardConfig(max_step_retries=1,
                                                retry_backoff_s=0.0))
        eng.submit(_prompts(1)[0], 4)

        def always_fail(*a, **k):
            raise api.TransientStepError("injected: persistent")

        eng._step = eng._prefill = always_fail
        errors = []
        for call in (eng.run, eng.step, lambda: eng.submit([1], 1)):
            try:
                call()
                errors.append(None)
            except api.EngineFailedError as e:
                errors.append(str(e))
        return dict(errors=errors, health=eng.health,
                    guard=eng.guard_summary())
    eng = make_engine(case["kv"], **{**RUN, **case.get("engine", {})})
    reqs = [eng.submit(p, case.get("tokens", 8))
            for p in _prompts(case.get("n", 4))]
    shed = []
    if case.get("shed"):
        try:
            eng.submit([1, 2, 3], 8)
        except api.AdmissionError as e:
            shed.append(e.reason)
    plan = None
    if "plan" in case:
        plan = api.FaultPlan(**case["plan"])
    elif "chaos" in case:
        plan = api.chaos_plan(case["chaos"], n_slots=4, first_step=2,
                              horizon=12)
    fired = []
    if plan is not None:
        with api.FaultInjector(eng, plan) as inj:
            eng.run()
        fired = sorted(inj.fired)
    else:
        eng.run()
    if case.get("reuse"):
        reqs.append(eng.submit(_prompts(4)[0], 8))
        eng.run()
    stats = {k: v for k, v in eng.stats.to_dict().items()
             if isinstance(v, int)}
    eng.scheduler.check()
    return dict(outputs=[list(map(int, r.output)) for r in reqs],
                states=[r.state for r in reqs],
                reasons=[r.fail_reason for r in reqs],
                guard=eng.guard_summary(), health=eng.health, stats=stats,
                fired=[list(f) for f in fired], shed=shed)


# ---------------------------------------------------------------------------
# The reference, in a child process
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    import pickle
    import types

    import jax
    import jax.numpy as jnp
    from repro.core.codecs import PackedTensor, validate_packed_tree
    from repro.models.config import ModelConfig
    from repro.models.model import init_params
    from repro.serve import (AdmissionError, EngineFailedError, GuardConfig,
                             ServeEngine, StreamIntegrityError,
                             load_packed_checkpoint, prequantize_params,
                             save_packed_checkpoint, verify_packed_tree)
    from repro.serve.guard import TransientStepError
    from repro.testing import (FaultInjector, FaultPlan, chaos_plan,
                               corrupt_checkpoint_leaf, truncate_checkpoint)

    root = os.path.dirname(out_path)
    cfgs = {kv: ModelConfig(**BASE, kv_quant=kv) for kv in ("m2xfp", "none")}
    params = init_params(jax.random.PRNGKey(0), cfgs["m2xfp"])
    packed = prequantize_params(params, cfgs["m2xfp"])
    out = {"root": root, "dense": _flatten(params),
           "packed": _flatten(packed), "cases": {}, "plants": {}}

    # Every ServeEngine jits its launches anew. Engines that differ only in
    # their requests reuse one engine's compiled launches (and so its
    # sentinel mailbox), which changes nothing they compute.
    templates = {}

    def make_engine(kv, **kw):
        eng = ServeEngine(packed, cfgs[kv], **kw)
        key = (kv, kw.get("n_slots"), kw.get("guard") is False)
        t = templates.setdefault(key, eng)
        eng._step, eng._prefill = t._step, t._prefill
        eng._reset, eng._scrub = t._reset, t._scrub
        if eng.guard:
            eng.guard.mailbox = t.guard.mailbox
        return eng

    api = types.SimpleNamespace(
        FaultPlan=FaultPlan, FaultInjector=FaultInjector,
        chaos_plan=chaos_plan, GuardConfig=GuardConfig,
        AdmissionError=AdmissionError, EngineFailedError=EngineFailedError,
        TransientStepError=TransientStepError)
    for name, case in CASES.items():
        out["cases"][name] = drive(api, make_engine, case)

    is_p = lambda x: isinstance(x, PackedTensor)  # noqa: E731

    def plant(tree, damage):
        def fix(path, leaf):
            if not is_p(leaf):
                return leaf
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            streams = dict(leaf.streams)
            for k, stream, idx, byte in damage:
                if k == key:
                    a = np.array(streams[stream])
                    if idx == "truncate":
                        a = a[:, :-1]
                    else:
                        a[idx] = byte
                    streams[stream] = jnp.asarray(a)
            return PackedTensor(streams, leaf.shape, leaf.codec)
        return jax.tree_util.tree_map_with_path(fix, tree, is_leaf=is_p)

    def verify(tree, **kw):
        try:
            fixed, repairs = verify_packed_tree(tree, **kw)
            return dict(repairs=repairs, tree=_flatten(fixed))
        except StreamIntegrityError as e:
            return dict(error=str(e), leaves=e.leaves)

    cfg = cfgs["m2xfp"]
    for name, damage in PLANTS.items():
        bad = plant(packed, damage)
        out["plants"][name] = dict(
            report=validate_packed_tree(bad),
            requantize=verify(bad, cfg=cfg, source_params=params),
            clamp=verify(bad), no_repair=verify(bad, repair=False))

    save_packed_checkpoint(os.path.join(root, "clean"), packed, cfg)
    poisoned = os.path.join(root, "poisoned")
    save_packed_checkpoint(poisoned, plant(packed, PLANTS["scale_255"]), cfg)
    try:
        load_packed_checkpoint(poisoned, cfg, validate_streams=True)
    except ValueError as e:
        out["poisoned_error"] = str(e)
    out["corrupt"] = []
    for i, kw in enumerate(CORRUPT):
        dst = os.path.join(root, f"corrupt_{i}")
        shutil.copytree(os.path.join(root, "clean"), dst)
        out["corrupt"].append(corrupt_checkpoint_leaf(dst, **kw))
    dst = os.path.join(root, "truncated")
    shutil.copytree(os.path.join(root, "clean"), dst)
    truncate_checkpoint(dst, nbytes=100)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


# ---------------------------------------------------------------------------
# The port
# ---------------------------------------------------------------------------

def _cfg(kv="m2xfp"):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**BASE, kv_quant=kv)


def _packed(reference):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(reference["packed"], _cfg(), "cpu")


def _port_api():
    import types
    from repro_torch.serve import (AdmissionError, EngineFailedError,
                                   GuardConfig, TransientStepError)
    from repro_torch.testing import FaultInjector, FaultPlan, chaos_plan
    return types.SimpleNamespace(
        FaultPlan=FaultPlan, FaultInjector=FaultInjector,
        chaos_plan=chaos_plan, GuardConfig=GuardConfig,
        AdmissionError=AdmissionError, EngineFailedError=EngineFailedError,
        TransientStepError=TransientStepError)


@pytest.fixture(scope="module")
def port_cases(reference):
    """Every case of CASES served by the port's engine."""
    from repro_torch.serve import ServeEngine
    params = _packed(reference)

    def make_engine(kv, **kw):
        return ServeEngine(params, _cfg(kv), device="cpu", **kw)
    return {name: drive(_port_api(), make_engine, case)
            for name, case in {**CASES, "guard_off": GUARD_OFF}.items()}


@pytest.mark.chaos
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_under_fault_plan_matches_reference(reference, port_cases,
                                                   name):
    """Tokens, request states and reasons, guard summary, integer stats
    and the injector's fired faults equal the reference engine's."""
    assert port_cases[name] == reference["cases"][name]


def test_fault_cases_do_what_they_plan(reference):
    """The reference's own outcomes, so that agreement means something:
    the planned slots' occupants are quarantined with their reason, the
    survivors' tokens equal the fault-free run's, the retried run loses no
    token, the scrubbed slot serves the first prompt again with its
    fault-free tokens, and the persistent failure FAILs the engine."""
    cases = reference["cases"]
    clean, clean_bf16 = cases["clean"], cases["clean_bf16"]
    for name, base in (("kv_and_nan", clean),
                       ("kv_and_nan_bf16", clean_bf16)):
        got = cases[name]
        assert got["states"] == ["finished", "quarantined", "quarantined",
                                 "finished"]
        assert got["reasons"][1:3] == ["kv", "logits"]
        assert [got["outputs"][i] for i in (0, 3)] == \
            [base["outputs"][i] for i in (0, 3)]
        assert got["guard"]["quarantines"] == 2
    assert cases["retry"]["outputs"] == clean["outputs"]
    assert cases["retry"]["guard"]["retries"] == 1
    for name, base in (("reuse", clean), ("reuse_bf16", clean_bf16)):
        assert cases[name]["states"][0] == "quarantined"
        assert cases[name]["outputs"][4] == base["outputs"][0]
    assert cases["deadline_and_shed"]["shed"] == ["queue_full"]
    assert {"deadline_queued", "deadline_running"} <= set(
        cases["deadline_and_shed"]["reasons"])
    assert cases["persistent_failure"]["health"] == "failed"
    assert all(cases["persistent_failure"]["errors"])


def test_guard_off_gives_the_default_guards_tokens(port_cases):
    """Port only: the guard reads the launch and changes no token."""
    assert port_cases["guard_off"]["guard"] == {}
    assert port_cases["guard_off"]["outputs"] == \
        port_cases["clean"]["outputs"]


def test_retried_step_gives_the_fault_free_tokens(port_cases):
    """Port only: the transient failure fires before the launch writes the
    caches in place, so the retried run's tokens are the fault-free run's."""
    got = port_cases["retry"]
    assert got["guard"]["retries"] == 1 and got["fired"] == [["fail", 2]]
    assert got["outputs"] == port_cases["clean"]["outputs"]
    assert set(got["states"]) == {"finished"}


# ---------------------------------------------------------------------------
# Packed-stream validation and repair
# ---------------------------------------------------------------------------

def _port_plant(params, damage):
    """The port's counterpart of the child's ``plant``, on per-layer
    leaves (a copy: ``params`` stays intact)."""
    from repro_torch.core.codecs import PackedTensor, packed_leaves
    from repro_torch.serve.guard import _replace_packed
    weights = packed_leaves(params)
    fixed = {}
    for key, stream, idx, byte in damage:
        leaves = fixed.setdefault(key, [
            PackedTensor({s: t.clone() for s, t in p.streams.items()},
                         p.shape, p.codec) for p in weights[key][1]])
        if idx == "truncate":
            for p in leaves:
                p.streams[stream] = p.streams[stream][:-1].contiguous()
        else:
            leaves[idx[0]].streams[stream][idx[1:]] = byte
    return _replace_packed(params, fixed)


def _port_verify(tree, **kw):
    from repro_torch.convert import stack_layers
    from repro_torch.serve import StreamIntegrityError, verify_packed_tree
    try:
        fixed, repairs = verify_packed_tree(tree, **kw)
        return dict(repairs=repairs, tree=stack_layers(fixed))
    except StreamIntegrityError as e:
        return dict(error=str(e), leaves=e.leaves)


def _assert_same_verify(got, want):
    from repro_torch.convert import flat_leaves
    assert sorted(got) == sorted(want)
    if "error" in want:
        assert got == want
        return
    assert got["repairs"] == want["repairs"]
    g, w = flat_leaves(got["tree"]), flat_leaves(want["tree"])
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_array_equal(
            g[k].contiguous().view(torch.uint8).numpy().reshape(-1),
            np.ascontiguousarray(w[k]).view(np.uint8).reshape(-1),
            err_msg=k)


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_validate_packed_tree_report_matches_reference(reference, name):
    from repro_torch.core.codecs import validate_packed_tree
    params = _packed(reference)
    assert validate_packed_tree(params) == {}
    got = validate_packed_tree(_port_plant(params, PLANTS[name]))
    assert got == reference["plants"][name]["report"]
    assert validate_packed_tree(params) == {}        # the plant copied


@pytest.mark.parametrize("mode", ["requantize", "clamp", "no_repair"])
@pytest.mark.parametrize("name", sorted(PLANTS))
def test_verify_packed_tree_matches_reference(reference, name, mode):
    """Repairs, repaired streams (every leaf, bytes) and errors equal the
    reference's: re-quantize from the dense weights, clamp without them,
    raise when repair is off or the damage is beyond clamping."""
    from repro_torch.convert import from_jax_tree
    bad = _port_plant(_packed(reference), PLANTS[name])
    kw = {"no_repair": dict(repair=False), "clamp": {},
          "requantize": dict(cfg=_cfg(), source_params=from_jax_tree(
              reference["dense"], _cfg(), "cpu"))}[mode]
    _assert_same_verify(_port_verify(bad, **kw),
                        reference["plants"][name][mode])


def test_verify_packed_tree_intact_is_identity(reference):
    from repro_torch.serve import verify_packed_tree
    params = _packed(reference)
    out, repairs = verify_packed_tree(params)
    assert out is params and repairs == []


# ---------------------------------------------------------------------------
# Checkpoints: stream validation on load, the harness's damage
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_load_validate_streams_raises_like_reference(reference):
    """A checkpoint saved with scale byte 255 passes its CRC; the stream
    validation names the leaf in the reference's words."""
    from repro_torch.serve.prequant import load_packed_checkpoint
    path = os.path.join(reference["root"], "poisoned")
    params, _ = load_packed_checkpoint(path, _cfg(), device="cpu")
    assert params["layers"][1]["attn"]["wq"]["scales"][0, 5] == 255
    with pytest.raises(ValueError) as ei:
        load_packed_checkpoint(path, _cfg(), validate_streams=True,
                               device="cpu")
    assert str(ei.value) == reference["poisoned_error"]


@pytest.mark.chaos
@pytest.mark.parametrize("i", range(len(CORRUPT)))
def test_corrupt_checkpoint_leaf_writes_reference_bytes(reference, tmp_path,
                                                        i):
    """The same seed flips the same bit of the same leaf; the port's load
    then raises CheckpointCorruptError naming it."""
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.serve.prequant import load_packed_checkpoint
    from repro_torch.testing import corrupt_checkpoint_leaf
    dst = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(reference["root"], "clean"), dst)
    key = corrupt_checkpoint_leaf(dst, **CORRUPT[i])
    assert key == reference["corrupt"][i]
    npz = os.path.join("step_0000000000", "arrays.npz")
    with np.load(os.path.join(dst, npz)) as got, \
            np.load(os.path.join(reference["root"], f"corrupt_{i}",
                                 npz)) as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].tobytes() == want[k].tobytes(), k
    with pytest.raises(CheckpointCorruptError) as ei:
        load_packed_checkpoint(dst, _cfg(), device="cpu")
    assert ei.value.leaf == key


@pytest.mark.chaos
def test_truncate_checkpoint_writes_reference_bytes(reference, tmp_path):
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.serve.prequant import load_packed_checkpoint
    from repro_torch.testing import truncate_checkpoint
    dst = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(reference["root"], "clean"), dst)
    path = truncate_checkpoint(dst, nbytes=100)
    with open(path, "rb") as f, open(os.path.join(
            reference["root"], "truncated", "step_0000000000",
            "arrays.npz"), "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        load_packed_checkpoint(dst, _cfg(), device="cpu")


# ---------------------------------------------------------------------------
# Port-only units: sentinels, poisoning, scrub, state machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["none", "m2xfp"])
def test_probes_count_planted_poison_per_slot(kv):
    """probe_kv counts NaNs in bf16 pages and 255 bytes in packed scales
    per slot, in every layer; codes and meta bytes and ``pos`` are not
    counted; probe_logits masks idle rows."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.guard import probe_kv, probe_logits
    caches = init_caches(_cfg(kv), 4, 8, "cpu")
    want = np.zeros(4, np.int64)
    for layer, slot, n in ((0, 1, 3), (1, 1, 1), (1, 3, 2)):
        page = caches["layers"][layer]["v"]
        if kv == "none":
            page[slot, :n, 0, 0] = float("nan")
        else:
            page["scales"][slot, :n, 0, 0] = 255
            page["codes"][:, :, 0, 0] = 255       # legal code bytes
            page["meta"][:, :, 0, 0] = 255
        want[slot] += n
    caches["layers"][0]["pos"][:] = 255
    assert probe_kv(caches, 4).tolist() == want.tolist()
    logits = torch.zeros(4, 5)
    logits[0, 1] = float("inf")
    logits[2, :3] = float("nan")
    assert probe_logits(logits).tolist() == [1, 0, 3, 0]
    assert probe_logits(logits, torch.tensor([1, 1, 0, 1])).tolist() == \
        [1, 0, 0, 0]


@pytest.mark.parametrize("kv", ["none", "m2xfp"])
def test_poison_and_scrub_touch_one_slot(kv):
    """The harness writes the reference's entry (layer 0, K, the slot's
    last position, head 0, element or group 0) and names the reference's
    leaf; a scrub zeroes that slot's pages in every layer and no other
    slot's bytes."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import _reset_slot
    from repro_torch.serve.guard import probe_kv
    from repro_torch.testing import poison_kv_nan, poison_kv_scale
    from test_torch_serve import _clone_caches
    caches = init_caches(_cfg(kv), 4, 8, "cpu")
    for layer in caches["layers"]:                # non-zero, finite pages
        for name in ("k", "v"):
            for t in (layer[name].values() if kv != "none"
                      else [layer[name]]):
                t.copy_(torch.randint(1, 100, t.shape).to(t.dtype))
        layer["pos"].copy_(torch.arange(8))
    if kv == "none":
        key = poison_kv_nan(caches, 2)
        assert key == "layers/k"
        assert torch.isnan(caches["layers"][0]["k"][2, 7, 0, 0])
        with pytest.raises(ValueError):
            poison_kv_scale(caches, 2)
    else:
        key = poison_kv_scale(caches, 2)
        assert key == "layers/k/scales"
        assert int(caches["layers"][0]["k"]["scales"][2, 7, 0, 0]) == 255
    assert probe_kv(caches, 4).tolist() == [0, 0, 1, 0]
    before = _clone_caches(caches)
    _reset_slot(caches, 2, scrub=True)
    for layer, old in zip(caches["layers"], before["layers"]):
        assert bool((layer["pos"][2] == -1).all())
        for name in ("k", "v"):
            pages = (zip(layer[name].values(), old[name].values())
                     if kv != "none" else [(layer[name], old[name])])
            for t, o in pages:
                assert not bool(t[2].any())
                keep = [0, 1, 3]
                assert torch.equal(t[keep], o[keep])
    assert probe_kv(caches, 4).tolist() == [0, 0, 0, 0]


def test_watchdog_and_recovery_state_machine():
    """A slow step trips the watchdog into DEGRADED; the configured streak
    of clean steps recovers to HEALTHY; the quarantine budget FAILs."""
    from repro_torch.serve import EngineFailedError, EngineGuard, GuardConfig
    from repro_torch.serve.guard import DEGRADED, FAILED, HEALTHY
    g = EngineGuard(GuardConfig(watchdog_s=0.1, recovery_steps=2))
    g.note_step(0.5)
    assert g.state == DEGRADED and g.watchdog_trips == 1
    g.note_step(0.01)
    assert g.state == DEGRADED
    g.note_step(0.01)
    assert g.state == HEALTHY and g.degraded_steps == 3
    g = EngineGuard(GuardConfig(max_quarantines=1))
    g.record_quarantine("kv")
    assert g.state == DEGRADED
    g.record_quarantine("logits")
    assert g.state == FAILED
    with pytest.raises(EngineFailedError):
        g.check_alive()


def test_verify_on_admit_repairs_by_clamp(reference):
    """verify_on_admit = 1: the seeded pick validates one weight; picked
    damage repairs the whole dict (clamp, no source) and degrades."""
    from repro_torch.core.codecs import packed_leaves, validate_packed_tree
    from repro_torch.serve import GuardConfig, ServeEngine
    params = _packed(reference)
    keys = list(packed_leaves(params))
    rng = np.random.default_rng(0)            # GuardConfig's seed
    rng.random()                              # the admit coin
    pick = int(rng.integers(len(keys)))
    bad = _port_plant(params, [(keys[pick], "scales", (0, 0, 0), 255)])
    eng = ServeEngine(bad, _cfg(), device="cpu", guard=GuardConfig(
        verify_on_admit=1.0), **RUN)
    eng.generate(_prompts(1), 2)
    assert validate_packed_tree(eng.params) == {}
    assert eng.guard.degraded_steps > 0


@pytest.mark.parametrize("source", [False, True])
def test_engine_verify_weights_repairs_at_init(reference, source):
    """verify_weights=True repairs planted weights before serving: from
    the dense source weights exactly (the engine stays healthy), else by
    clamp (the engine starts degraded)."""
    from repro_torch.convert import from_jax_tree
    from repro_torch.serve import ServeEngine, verify_packed_tree
    params = _packed(reference)
    bad = _port_plant(params, PLANTS["scale_255"])
    kw = dict(source_params=from_jax_tree(reference["dense"], _cfg(),
                                          "cpu")) if source else {}
    eng = ServeEngine(bad, _cfg(), device="cpu", verify_weights=True,
                      **kw, **RUN)
    _assert_same_tree(eng.params,
                      params if source else verify_packed_tree(bad)[0])
    assert eng.health == ("healthy" if source else "degraded")


def test_stats_and_accounting(reference):
    from repro_torch.serve import ServeEngine, tree_nbytes
    eng = ServeEngine(_packed(reference), _cfg(), device="cpu", **RUN)
    eng.generate(_prompts(2), 3)
    d = eng.stats.to_dict()
    assert d["generated_tokens"] == 6 and d["tokens_per_sec"] > 0
    assert eng.weight_bytes() == tree_nbytes(eng.params) > 0
    # 2 layers x (codes 16 + scales 1 + meta 1 bytes per 32 elements of K
    # and V: 4 slots x 32 positions x 1 head x hd 32) + pos (int32)
    assert eng.kv_bytes() == 2 * (2 * 4 * 32 * 18 + 4 * 32 * 4)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
