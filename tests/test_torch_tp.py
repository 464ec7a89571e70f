"""The remat and attention-tiling flags (ROADMAP A12) and tensor-parallel
compute on weight shards (A13) against the reference.

One child (the reference, with XLA's excess precision off, 4 host devices
and ``REPRO_ATTN_KV_CHUNK`` / ``REPRO_ATTN_Q_TILE`` set to CHUNK_FLAGS
before anything is imported) computes:

(a) the declarations of the five new flags, the errors of bad values and
    the bool flags' parsing;
(b) ``forward``'s logits of the dense config at CHUNK_S positions under
    CHUNK_FLAGS (q tiles of 128 against KV chunks of 64);
(c) loss and gradients under each ``REPRO_REMAT_POLICY`` for the dense
    config, xlstm-smoke and zamba2-smoke;
(d) loss and gradients of TP_CASES on the (1, 2) and (2, 2) ("data",
    "model") meshes (parameters and batch at the train state's shardings,
    jitted under ``use_sharding``: GSPMD's tensor-parallel partitioning),
    accumulated over one microbatch per "data" rank (the reference's
    ``_grads_and_loss``), which is what the port's sharded step computes:
    a rank's mixture-of-experts routing groups hold its own rows only;
(e) the reference engine's tokens (guard off) and top-2 margins for
    SERVE_REF (packed m2xfp and mxfp4 from its own parameters).

The port's multi-rank runs use gloo on the CPU (2 or 4 ranks, each run
under RANK_TIMEOUT_S, ``repro_torch.testing.distributed.run_ranks``).
Bounds: a row-parallel product sums t f32 partial sums, each rounded, so
it is within t ulps of the sum of |partials| of the unsharded product
(derived and checked in ``test_row_parallel_product_within_t_ulps``).
Over a whole model each such difference may flip a later bf16 rounding,
which later products carry on, as the reference's f32 accumulation does
against the port's (tests/test_torch_train.py): logits, losses and
gradients are held to that file's bounds (NONE_LOGIT_TOL, LOSS_TOL,
GRAD_TOL / GRAD_L2).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_serve import BASE as SERVE_BASE
from test_torch_serve import ENGINE, N_NEW, PROMPTS, _flatten, \
    run_reference_child
from test_torch_train import (LOSS_TOL, NONE_LOGIT_TOL, assert_grads_close,
                              leaves_of)

DEVICES = 4
CHUNK_FLAGS = {"REPRO_ATTN_KV_CHUNK": "64", "REPRO_ATTN_Q_TILE": "128"}
CHUNK_S = 256
NEW_FLAGS = ("REPRO_REMAT_POLICY", "REPRO_ATTN_KV_CHUNK",
             "REPRO_ATTN_Q_TILE", "REPRO_GATHER_PACKED",
             "REPRO_BF16_TP_REDUCE")
BAD_VALUES = [("REPRO_REMAT_POLICY", "bogus"), ("REPRO_REMAT_POLICY", ""),
              ("REPRO_ATTN_KV_CHUNK", "0"), ("REPRO_ATTN_KV_CHUNK", "x"),
              ("REPRO_ATTN_Q_TILE", "-3")]
BOOL_VALUES = ("1", "true", "", "0")
POLICIES = ("none", "dots", "dots_no_batch")
# case -> (registry name or None for DENSE, overrides)
DENSE = dict({k: v for k, v in SERVE_BASE.items() if k != "quant"},
             name="tp-dense")
# wo's and down's K-shards on the 1 x 2 mesh (48 and 80 rows) split
# 32-groups (ROADMAP C3), as qwen2-0.5b's (56 and 304 rows) do on a
# 16-wide "model" axis
STRADDLE = dict(d_model=96, n_heads=3, n_kv_heads=1, d_ff=160)
CONFIGS = {"dense": (None, {}),
           "variant": ("qwen3-8b", {"qkv_bias": True}),
           "moe": ("olmoe-1b-7b", {}),
           "xlstm-smoke": ("xlstm-125m", {}),
           "zamba2-smoke": ("zamba2-7b", {}),
           "straddle": (None, STRADDLE)}
REMAT_CASES = ("dense", "xlstm-smoke", "zamba2-smoke")
# name -> (config case, quant, meshes)
TP_CASES = {"dense-none": ("dense", "none", ("1x2", "2x2")),
            "dense-qat": ("dense", "qat", ("1x2",)),
            "variant-none": ("variant", "none", ("1x2", "2x2")),
            "moe-none": ("moe", "none", ("1x2", "2x2")),
            "straddle-none": ("straddle", "none", ("1x2",))}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
TRAIN_B, TRAIN_S = 4, 16
REMAT_B, REMAT_S = 2, 32
# (name, config case, codec, overrides): SERVE_REF have reference tokens;
# SERVE_PORT is held to the unplaced port's, which tests/test_torch_moe,
# tests/test_torch_serve and tests/test_torch_codecs hold to the
# reference's
SERVE_REF = [("dense-m2xfp", "dense", "m2xfp", {}),
             ("dense-mxfp4", "dense", "mxfp4", {}),
             ("variant-m2xfp", "variant", "m2xfp", {}),
             ("straddle-m2xfp", "straddle", "m2xfp", {})]
# (name, config case, codec, overrides, engine overrides): olmoe-smoke
# with 64 experts, packed (K, E, N) experts whose down projection the
# reference's specs shard over E (expert-parallel); the dense config with
# two KV heads and a ring of 33 slots, which does not divide over "model",
# so the caches are head-sharded
SERVE_PORT = [("moe-m2xfp", "moe", "m2xfp", {"n_experts": 64}, {}),
              ("dense-kv-heads", "dense", "m2xfp", {"n_kv_heads": 2},
               {"max_len": 33}),
              ("straddle-mxfp4", "straddle", "mxfp4", {}, {})]
# a reference top-2 margin at most this is a near-tie either side may
# break either way (the TP sums move a logit by ~1e-6 here)
NEAR_TIE = 1e-3
RANK_TIMEOUT_S = 150


def make_config(pkg: str, case: str, **kw):
    """``case``'s config in package ``pkg`` ("repro" or "repro_torch")."""
    import importlib
    arch, overrides = CONFIGS[case]
    if arch is None:
        model_config = importlib.import_module(
            f"{pkg}.models.config").ModelConfig
        return model_config(**{**DENSE, **overrides, **kw})
    configs = importlib.import_module(f"{pkg}.configs")
    return configs.smoke_config(arch, **overrides, **kw)


def train_batch(cfg, b=TRAIN_B, s=TRAIN_S, seed=3) -> dict:
    """Tokens and labels, every label valid (so each batch slice weighs
    alike in the mean)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}


def remat_batch(cfg) -> dict:
    """tests/test_torch_recurrent.py's batch (B, S = 2, 32; every seventh
    label ignored), on which that file holds xlstm-smoke's and
    zamba2-smoke's gradients to the reference. (On ``train_batch``'s
    seed 3 zamba2-smoke's ``A_log`` gradient, a sum whose terms cancel, is
    1.18 x GRAD_L2 from the reference's under every policy, ``none``
    included: bf16 flips of a larger cotangent, not the remat.)"""
    rng = np.random.default_rng(REMAT_S)
    labels = rng.integers(0, cfg.vocab_size, (REMAT_B, REMAT_S)).astype(
        np.int32)
    labels[:, ::7] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (REMAT_B, REMAT_S))
            .astype(np.int32), "labels": labels}


def chunk_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, CHUNK_S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The reference, run in a child process
# ---------------------------------------------------------------------------

def _raises(fn):
    try:
        fn()
    except Exception as e:             # noqa: BLE001 -- recorded
        return f"{type(e).__name__}: {e}"
    return None


def _reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.core import envflags
    from repro.distributed.sharding import use_sharding
    from repro.launch.mesh import make_test_mesh
    from repro.models import attention
    from repro.models.model import forward, init_params
    from repro.serve import ServeEngine, prequantize_params
    from repro.train.trainer import (_grads_and_loss, batch_sharding,
                                     make_train_state,
                                     train_state_shardings)
    from repro_torch.testing import attention_extras
    from test_torch_variants import _margin_recorder
    out = {}
    # (a) flags
    out["flags"] = {f.name: (f.kind, f.default, f.choices, f.minimum)
                    for f in envflags.defined_flags() if f.name in NEW_FLAGS}
    out["errors"], out["bools"] = {}, {}
    for name, value in BAD_VALUES:
        saved = os.environ.get(name)
        os.environ[name] = value
        out["errors"][(name, value)] = _raises(lambda: envflags.get(name))
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved
    for name in ("REPRO_GATHER_PACKED", "REPRO_BF16_TP_REDUCE"):
        for value in BOOL_VALUES:
            os.environ[name] = value
            out["bools"][(name, value)] = envflags.get_bool(name)
        del os.environ[name]
    # (b) the chunked forward under CHUNK_FLAGS
    cfg = make_config("repro", "dense")
    params = init_params(jax.random.PRNGKey(0), cfg)
    tokens = chunk_tokens(cfg)
    out["chunked"] = {
        "consts": (attention.KV_CHUNK, attention.Q_TILE),
        "params": _flatten(params),
        "logits": np.asarray(jax.jit(lambda p: forward(
            p, cfg, {"tokens": jnp.asarray(tokens)}))(params))}

    def grads_of(cfg, params, batch, n_micro=1):
        fn = jax.jit(lambda p: _grads_and_loss(p, cfg, batch, n_micro))
        loss, g = fn(params)
        return float(loss), _flatten(g)

    # (c) remat policies (read when the jitted function is traced)
    out["remat"] = {}
    for case in REMAT_CASES:
        cfg = make_config("repro", case, remat=True)
        params = jax.tree.map(lambda p: p.astype(jnp.float32),
                              init_params(jax.random.PRNGKey(0), cfg))
        batch = {k: jnp.asarray(v) for k, v in remat_batch(cfg).items()}
        res = {"params": _flatten(params)}
        for policy in POLICIES:
            os.environ["REPRO_REMAT_POLICY"] = policy
            res[policy] = grads_of(cfg, params, batch)
        del os.environ["REPRO_REMAT_POLICY"]
        out["remat"][case] = res
    # (d) the tensor-parallel cases on the meshes
    out["tp"] = {}
    for name, (case, quant, meshes) in TP_CASES.items():
        cfg = make_config("repro", case, quant=quant)
        state = make_train_state(jax.random.PRNGKey(0), cfg)
        if cfg.qkv_bias or cfg.qk_norm:
            attn = state["params"]["layers"]["attn"]
            for leaf, values in attention_extras(cfg).items():
                attn[leaf] = jnp.asarray(values)
        batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        res = {"state": _flatten(state)}
        for mesh_name in meshes:
            mesh = make_test_mesh(MESHES[mesh_name], ("data", "model"))
            with use_sharding(mesh):
                psh = train_state_shardings(state, mesh)["params"]
                bsh = batch_sharding(mesh)
                p = jax.device_put(state["params"], psh)
                b = jax.device_put(batch, bsh)
                res[mesh_name] = grads_of(cfg, p, b, MESHES[mesh_name][0])
        out["tp"][name] = res
    # (e) the reference engine
    out["serve"] = {}
    for name, case, fmt, kw in SERVE_REF:
        cfg = make_config("repro", case, quant="serve", quant_format=fmt,
                          **kw)
        params = init_params(jax.random.PRNGKey(0), cfg)
        if cfg.qkv_bias or cfg.qk_norm:
            attn = params["layers"]["attn"]
            for leaf, values in attention_extras(cfg).items():
                attn[leaf] = jnp.asarray(values).astype(attn[leaf].dtype)
        packed = prequantize_params(params, cfg)
        margins = {}
        eng = ServeEngine(packed, cfg, guard=False, **ENGINE)
        eng.sample_fn = _margin_recorder(eng, margins)
        out["serve"][name] = {"packed": _flatten(packed),
                              "tokens": eng.generate(PROMPTS, N_NEW),
                              "margins": margins}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    os.environ.update(CHUNK_FLAGS)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES}").strip()
    _reference_main(sys.argv[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_child(__file__, tmp_path_factory)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

def port_tree(flat, cfg):
    from repro_torch.convert import from_jax_tree
    return from_jax_tree(flat, cfg, "cpu")


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ranks(scenario, world, tmp_path, **inputs):
    from repro_torch.testing.distributed import run_ranks
    return run_ranks(scenario, world, str(tmp_path / scenario),
                     RANK_TIMEOUT_S, **inputs)


# (a) flags ------------------------------------------------------------------

def test_new_flags_declared_as_reference(reference):
    """The five flags' kind, default, choices and minimum are the
    reference's."""
    from repro_torch.core import envflags
    got = {f.name: (f.kind, f.default, f.choices, f.minimum)
           for f in envflags.defined_flags() if f.name in NEW_FLAGS}
    assert got == reference["flags"]
    assert len(got) == len(NEW_FLAGS)


@pytest.mark.parametrize("name,value", BAD_VALUES)
def test_flag_errors_match_reference(reference, monkeypatch, name, value):
    """A bad value raises the reference's error, word for word."""
    from repro_torch.core import envflags
    monkeypatch.setenv(name, value)
    kind = {f.name: f.kind for f in envflags.defined_flags()}[name]
    read = envflags.get_str if kind == "str" else envflags.get_int
    want = reference["errors"][(name, value)]
    assert want is not None
    assert _raises(lambda: read(name)) == want


@pytest.mark.parametrize("value", BOOL_VALUES)
def test_bool_flags_parse_as_reference(reference, monkeypatch, value):
    """A bool flag is true for "1" only, as in the reference."""
    from repro_torch.core import envflags
    for name in ("REPRO_GATHER_PACKED", "REPRO_BF16_TP_REDUCE"):
        monkeypatch.setenv(name, value)
        assert envflags.get_bool(name) == reference["bools"][(name, value)]


def test_env_int_validation(monkeypatch):
    """tests/test_obs.py::test_env_int_validation's cases on the port's
    ``_env_int`` (imported from where the reference's is)."""
    from repro_torch.models.attention import _env_int
    monkeypatch.delenv("T_OBS_X", raising=False)
    assert _env_int("T_OBS_X", 7) == 7
    monkeypatch.setenv("T_OBS_X", "3")
    assert _env_int("T_OBS_X", 7) == 3
    for bad in ("0", "-2"):
        monkeypatch.setenv("T_OBS_X", bad)
        with pytest.raises(ValueError, match="must be >= 1"):
            _env_int("T_OBS_X", 7)
    monkeypatch.setenv("T_OBS_X", "banana")
    with pytest.raises(ValueError, match="not an integer"):
        _env_int("T_OBS_X", 7)
    monkeypatch.setenv("T_OBS_X", "4")
    assert _env_int("T_OBS_X", 7, minimum=4) == 4


_CHUNK_CHILD = """
import pickle, sys, torch
from repro_torch.convert import from_jax_tree
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
with open(sys.argv[1], "rb") as f:
    cfg_kw, flat, tokens = pickle.load(f)
cfg = ModelConfig(**cfg_kw)
with torch.no_grad():
    logits = forward(from_jax_tree(flat, cfg, "cpu"), cfg,
                     {"tokens": torch.from_numpy(tokens)})
with open(sys.argv[2], "wb") as f:
    pickle.dump(((attention.KV_CHUNK, attention.Q_TILE), logits.numpy()), f)
"""


def _chunked_forward(tmp_path, flat, flags: dict):
    """The port's forward in a child whose environment holds ``flags``
    (read at import of repro_torch.models.attention)."""
    cfg = make_config("repro_torch", "dense")
    src = tmp_path / "in.pkl"
    dst = tmp_path / f"out{len(flags)}.pkl"
    with open(src, "wb") as f:
        pickle.dump((dataclasses.asdict(cfg), flat, chunk_tokens(cfg)), f)
    env = {k: v for k, v in os.environ.items() if k not in CHUNK_FLAGS}
    env.update(flags)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    subprocess.run([sys.executable, "-c", _CHUNK_CHILD, str(src), str(dst)],
                   env=env, check=True, timeout=300)
    with open(dst, "rb") as f:
        return pickle.load(f)


def test_chunk_flags_tile_as_reference(reference, tmp_path):
    """With REPRO_ATTN_KV_CHUNK=64 and REPRO_ATTN_Q_TILE=128 set before
    import, the port's attention takes them, and ``forward`` at 256
    positions (2 q tiles x 4 KV chunks) matches the reference's logits
    under the same flags within test_torch_train.py's bound; the defaults
    (one tile, one chunk) give other bits, so the flags changed the
    summation order."""
    ref = reference["chunked"]
    assert ref["consts"] == (64, 128)
    consts, logits = _chunked_forward(tmp_path, ref["params"], CHUNK_FLAGS)
    assert consts == (64, 128)
    d = np.abs(logits - ref["logits"]).max()
    assert d <= NONE_LOGIT_TOL, d
    consts0, logits0 = _chunked_forward(tmp_path, ref["params"], {})
    assert consts0 == (512, 1024)
    assert not np.array_equal(logits0, logits)


# (c) remat ------------------------------------------------------------------

@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_policies_bit_equal_and_match_reference(reference, case,
                                                      monkeypatch):
    """Under REPRO_REMAT_POLICY dots and dots_no_batch the port's loss and
    gradients are the bits of ``none`` (a kept product output is what the
    recompute gives), and each policy's are within test_torch_train.py's
    bounds of the reference's under the same policy."""
    from repro_torch.train.trainer import _loss_and_grads
    ref = reference["remat"][case]
    cfg = make_config("repro_torch", case, remat=True)
    params = port_tree(ref["params"], cfg)
    batch = port_batch(remat_batch(cfg))
    got = {}
    for policy in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        got[policy] = _loss_and_grads(params, cfg, batch)
    loss0, grads0 = got["none"]
    for policy in POLICIES:
        loss, grads = got[policy]
        assert torch.equal(loss, loss0), policy
        for k, g in leaves_of(grads).items():
            np.testing.assert_array_equal(g, leaves_of(grads0)[k],
                                          err_msg=f"{policy} {k}")
        want_loss, want_grads = ref[policy]
        assert abs(float(loss) - want_loss) <= LOSS_TOL, policy
        assert_grads_close(leaves_of(grads), leaves_of(want_grads),
                           f"{case} {policy}")


def test_remat_policy_keeps_the_products(monkeypatch):
    """The policies' selective checkpoint sees the products: under
    ``dots`` the backward recomputes no ``mm`` or ``bmm``, under
    ``dots_no_batch`` only ``bmm`` (attention's batched einsums), under
    ``none`` both (a spy on the ops the recompute runs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.train.trainer import _loss_and_grads
    cfg = make_config("repro_torch", "dense", remat=True)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.train import make_train_state
    params = make_train_state(gen, cfg, device="cpu")["params"]
    batch = port_batch(train_batch(cfg, REMAT_B, REMAT_S))
    counts = {}

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket).split(".")[-1]
            counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))
    seen = {}
    for policy in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        counts.clear()
        with Spy():
            _loss_and_grads(params, cfg, batch)
        seen[policy] = (counts.get("mm", 0), counts.get("bmm", 0))
    none, dots, nob = (seen[p] for p in POLICIES)
    # the forward's products and the backward's are common to every
    # policy; the recompute adds the forward's products again under none
    assert none[0] > nob[0] == dots[0]
    assert none[1] == nob[1] > dots[1]


# (d) tensor-parallel train ---------------------------------------------------

def _tp_inputs(reference, name):
    from repro_torch.convert import from_jax_train_state
    from repro_torch.train import AdamWConfig
    case, quant, _ = TP_CASES[name]
    cfg = make_config("repro_torch", case, quant=quant)
    state = from_jax_train_state(reference["tp"][name]["state"], cfg, "cpu")
    return (name, cfg, AdamWConfig(lr=1e-3), state,
            port_batch(train_batch(cfg)))


@pytest.fixture(scope="module")
def tp_train(reference, tmp_path_factory):
    """The ``tp_train`` scenario per mesh: (case inputs, rank results)."""
    out = {}
    for mesh_name, shape in MESHES.items():
        cases = [_tp_inputs(reference, n) for n, (_, _, meshes)
                 in TP_CASES.items() if mesh_name in meshes]
        from repro_torch.testing.distributed import run_ranks
        tmp = tmp_path_factory.mktemp(f"tp_train_{mesh_name}")
        out[mesh_name] = ({c[0]: c for c in cases}, run_ranks(
            "tp_train", int(np.prod(shape)), str(tmp), RANK_TIMEOUT_S,
            shape=shape, axes=("data", "model"), cases=cases))
    return out


TRAIN_GRID = [(n, m) for n, (_, _, meshes) in TP_CASES.items()
              for m in meshes]


def _weights(cfg) -> dict:
    """{projection name: (K, N, kind)} of one layer: column-parallel q, k,
    v, gate and up, row-parallel wo and down (expert stacks per expert)."""
    d, hd, nh, nkv, ff = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_ff)
    return {"wq": (d, nh * hd, "column"), "wk": (d, nkv * hd, "column"),
            "wv": (d, nkv * hd, "column"), "wo": (nh * hd, d, "row"),
            "gate": (d, ff, "column"), "up": (d, ff, "column"),
            "down": (ff, d, "row")}


@pytest.mark.parametrize("name,mesh_name", TRAIN_GRID)
def test_tp_train_computes_on_shards(tp_train, name, mesh_name):
    """Every projection runs on its local (K, N/t) (column) or (K/t, N)
    (row) shard, no weight is gathered along "model" (weights move only
    along "data", the fsdp gather), and each rank's parameter bytes are
    ``shard_nbytes``."""
    cases, ranks = tp_train[mesh_name]
    cfg = cases[name][1]
    t = MESHES[mesh_name][1]
    for r in ranks:
        got = r["cases"][name]
        assert got["param_bytes"] == got["shard_nbytes"]
        for run in ("grads_run", "step_run"):
            # the last two axes of each local weight (an expert stack's
            # (E, K, N) per expert)
            seen = {(g["kind"], g["w"][-2:]) for g in got[run]["gemms"]}
            for k, n, kind in _weights(cfg).values():
                local = (k, n // t) if kind == "column" else (k // t, n)
                assert (kind, local) in seen, (run, kind, local, seen)
            colls = got[run]["collectives"]
            assert not [c for c in colls if c["moving"] == "weight"
                        and c["group"] == "model"]
            if run == "step_run" and r is ranks[0]:
                print({"case": name, "mesh": mesh_name,
                       "train_step_bytes_per_rank": {
                           f"{g}/{m}/{o}": sum(
                               c["nbytes"] for c in colls
                               if (c["group"], c["moving"], c["op"])
                               == (g, m, o))
                           for g, m, o in sorted({(c["group"], c["moving"],
                                                   c["op"]) for c in colls})}})
            weights = [c for c in colls if c["moving"] == "weight"]
            if MESHES[mesh_name][0] == 1:
                assert not weights
            else:
                assert weights and {c["group"] for c in weights} == {"data"}


@pytest.mark.parametrize("name,mesh_name", TRAIN_GRID)
def test_tp_train_matches_unsharded_and_reference(reference, tp_train, name,
                                                  mesh_name):
    """Each rank's tensor-parallel logits, loss and gradients of its batch
    slice against the unsharded port on the same slice, and their mean
    over the batch ranks against the reference's on the same mesh, within
    the module's bounds; the sharded step's loss and grad_norm against the
    plain step with one microbatch per batch rank and against the
    reference's; the sharded step's new moments and parameters at each
    rank's shards against the plain step's cut to the same shards, within
    ``adamw_agreement``'s bounds."""
    from repro_torch.convert import flat_leaves, stack_layers
    from repro_torch.testing.train import adamw_agreement
    cases, ranks = tp_train[mesh_name]
    for r in ranks:
        got = r["cases"][name]
        d = (got["logits"] - got["plain_logits"]).abs().max()
        assert d <= NONE_LOGIT_TOL, d
        assert abs(float(got["loss"]) - float(got["plain_loss"])) \
            <= LOSS_TOL
        assert_grads_close(leaves_of(got["grads"]),
                           leaves_of(got["plain_grads"]), name)
        m, pm = got["metrics"], got["plain_metrics"]
        assert abs(float(m["loss"]) - float(pm["loss"])) <= LOSS_TOL
        assert abs(float(m["grad_norm"]) - float(pm["grad_norm"])) <= \
            GRAD_L2_REL * float(pm["grad_norm"])
        worst = adamw_agreement(got["start"], [got["new"]],
                                [got["plain_new"]], [float(m["lr"])],
                                cases[name][2])
        assert max(worst.values()) <= 1.0, (name, worst)
    want_loss, want = reference["tp"][name][mesh_name]
    n_data = MESHES[mesh_name][0]
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coordinate"][0], r["cases"][name])
    assert len(by_data) == n_data
    loss = sum(float(c["loss"]) for c in by_data.values()) / n_data
    assert abs(loss - want_loss) <= LOSS_TOL
    flat = [flat_leaves(stack_layers(c["grads"])) for c in by_data.values()]
    mean = {k: sum(f[k] for f in flat) / n_data for k in flat[0]}
    assert_grads_close({k: v.numpy() for k, v in mean.items()},
                       leaves_of(want), f"{name} {mesh_name}")
    ref_norm = float(np.sqrt(sum(float((np.asarray(v, np.float64) ** 2)
                                       .sum())
                                 for v in leaves_of(want).values())))
    step_norm = float(ranks[0]["cases"][name]["metrics"]["grad_norm"])
    assert abs(step_norm - ref_norm) <= GRAD_L2_REL * ref_norm
    assert abs(float(ranks[0]["cases"][name]["metrics"]["loss"])
               - want_loss) <= LOSS_TOL


# the grad_norm: a gradient within GRAD_L2 of its norm moves the norm by at
# most that share (the triangle inequality)
GRAD_L2_REL = 2.0 ** -5


def test_row_parallel_product_within_t_ulps():
    """The bound the module states, derived: t f32 partial sums p_r (each
    the float64 product rounded once to f32) summed in f32 differ from the
    unsharded product (the float64 sum rounded once) by at most
    (t - 1) roundings of partial sums of magnitude <= S = sum |p_r| plus t
    roundings of the partials themselves, each at most ulp(S) / 2, so by
    at most t ulps of S. Checked on products of random bf16 operands at
    t = 2 and 4, summed in rank order as the all-reduce does on one host
    (its order of arrival on NCCL differs, within the same bound)."""
    from repro_torch.models.numerics import dot_f32acc
    rng = np.random.default_rng(0)
    for t in (2, 4):
        x = torch.from_numpy(rng.standard_normal((16, 256)).astype(
            np.float32)).to(torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((256, 64)).astype(
            np.float32)).to(torch.bfloat16)
        whole = dot_f32acc(x, w)
        k = 256 // t
        parts = [dot_f32acc(x[:, r * k:(r + 1) * k], w[r * k:(r + 1) * k])
                 for r in range(t)]
        summed = parts[0]
        for p in parts[1:]:
            summed = summed + p
        s = sum(p.abs() for p in parts)
        ulp = torch.where(s > 0, 2.0 ** (torch.floor(torch.log2(s)) - 23),
                          torch.zeros_like(s))
        d = (summed - whole).abs()
        assert (d <= t * ulp).all(), (d / ulp.clamp_min(1e-45)).max()
        assert (d > 0).any()          # the bound is not vacuous


def _padded_rows(k: int, t: int, r: int) -> tuple:
    """(k0, k1): the K range of rank r's padded row shard of a packed
    (k, N) weight at t ranks (the groups its code bytes touch)."""
    b = k // 2 // t
    return 32 * (r * b // 16), 32 * -(-(r + 1) * b // 16)


@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4", "nvfp4"])
def test_padded_row_shard_decodes_and_sums(fmt):
    """ROADMAP C3's adapter at qwen2-0.5b's K = 896 (``wo``), for both
    kernel codecs and nvfp4 (no kernel: its product decodes the padded
    weight; its scales are 16-row groups): for every rank at t = 2, 4, 8
    and 16 the padded local weight
    (``kernels/layout.py::pad_row_shard`` of the whole streams: the
    rank's code bytes, the other streams' rows of its groups) decodes to the whole weight's rows on the rank's K-set (the
    k whose interleaved byte row, 16 (k // 32) + k % 16, is the rank's)
    and to +0.0 elsewhere; the ranks' plain products of x's columns
    k0 .. k1 - 1 summed in f32 are within t ulps of the sum of |partials|
    of the whole product (test_row_parallel_product_within_t_ulps)."""
    from repro_torch.core.codecs import PackedTensor, get_codec
    from repro_torch.kernels.layout import pad_row_shard
    from repro_torch.models.quant import (_packed_product,
                                          decode_serving_weight,
                                          pack_serving_weight, quantize_act)
    rng = np.random.default_rng(7)
    k, n = 896, 64
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.05)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32))
    p = pack_serving_weight(w, fmt)
    whole = decode_serving_weight(p)
    xq = quantize_act(x, get_codec(fmt))
    full = _packed_product(xq, p)
    for t in (2, 4, 8, 16):
        b = k // 2 // t
        parts = []
        for r in range(t):
            sp, (k0, k1) = pad_row_shard(p.streams, k, r, t)
            assert (k0, k1) == _padded_rows(k, t, r)
            pw = PackedTensor(sp, (k1 - k0, n), fmt)
            d = decode_serving_weight(pw)
            kk = torch.arange(k0, k1)
            byte = 16 * (kk // 32) + kk % 16
            mine = (byte >= r * b) & (byte < (r + 1) * b)
            assert int(mine.sum()) == 2 * b
            assert torch.equal(d[mine], whole[k0:k1][mine])
            assert (d[~mine] == 0).all()
            assert not torch.signbit(d[~mine]).any()
            parts.append(_packed_product(xq[:, k0:k1].contiguous(), pw))
        summed = parts[0]
        for q in parts[1:]:
            summed = summed + q
        s = sum(q.abs() for q in parts)
        ulp = torch.where(s > 0, 2.0 ** (torch.floor(torch.log2(s)) - 23),
                          torch.zeros_like(s))
        assert ((summed - full).abs() <= t * ulp).all(), (fmt, t)


def test_qat_row_shard_splitting_groups_raises():
    """``qat`` on a row shard whose K-shard splits the codec's groups
    (a 48-row shard of 32-groups) is not built (ROADMAP C4): it raises
    ``NotImplementedError`` naming the case before any product."""
    from torch.distributed.tensor import Shard
    from repro_torch.core.codecs import get_codec
    from repro_torch.models.quant import placed_product
    codec = get_codec("m2xfp")
    with pytest.raises(NotImplementedError, match="splits the codec's "
                       "32-element groups"):
        placed_product(torch.zeros(2, 96), torch.zeros(48, 96), Shard(0),
                       (1, 0, None), "qat", codec, False, None, None, None)


# (e) tensor-parallel serve ---------------------------------------------------

def _serve_cases(reference):
    from repro_torch.models.model import init_params, pack_params_for_serving
    from repro_torch.testing import fill_attention_extras
    cases = []
    for name, case, fmt, kw in SERVE_REF:
        cfg = make_config("repro_torch", case, quant="serve",
                          quant_format=fmt, **kw)
        packed = port_tree(reference["serve"][name]["packed"], cfg)
        cases.append((name, cfg, packed, PROMPTS, N_NEW, dict(ENGINE)))
    for name, case, fmt, kw, engine in SERVE_PORT:
        cfg = make_config("repro_torch", case, quant="serve",
                          quant_format=fmt, **kw)
        params = fill_attention_extras(init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
        cases.append((name, cfg, pack_params_for_serving(params, cfg),
                      PROMPTS, N_NEW, dict(ENGINE, **engine)))
    return cases


@pytest.fixture(scope="module")
def tp_serve(reference, tmp_path_factory):
    from repro_torch.testing.distributed import run_ranks
    tmp = tmp_path_factory.mktemp("tp_serve")
    return run_ranks("tp_serve", 2, str(tmp), RANK_TIMEOUT_S, shape=(1, 2),
                     axes=("data", "model"), cases=_serve_cases(reference))


def _near_tie_cut(got: list, want: list, margins: dict) -> list:
    """``got`` and ``want`` cut at each request's first near-tie of the
    reference (its top-2 margin at most NEAR_TIE)."""
    out = []
    for rid, (g, w) in enumerate(zip(got, want)):
        n = next((i for i in range(len(w))
                  if margins.get((rid, i), 1.0) <= NEAR_TIE), len(w))
        out.append((g[:n], w[:n]))
    return out


SERVE_NAMES = [c[0] for c in SERVE_REF + SERVE_PORT]


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_tp_engine_tokens(reference, tp_serve, name):
    """A 1 x 2 engine on placed parameters gives the unplaced engine's
    tokens and the reference engine's (up to a request's first near-tie),
    with chunks of 1 too; every cache leaf is at its placement after each
    step, sequence- or (dense-kv-heads) head-sharded; its products run on
    column and row shards, and no weight moves."""
    for r in tp_serve:
        got = r["cases"][name]
        assert got["tokens"] == got["want"]
        assert got["tokens_chunk1"] == got["want"]
        assert got["placements_kept"] and all(got["placements_kept"])
        kinds = {g["kind"] for g in got["run"]["gemms"]}
        assert {"column", "row"} <= kinds
        if name.startswith("moe"):
            assert "expert" in kinds       # the packed down projection
        # a ring that divides over "model" is sequence-sharded (Shard(1)
        # of a (B, W, nkv, hd) leaf), else head-sharded (Shard(2))
        assert got["cache_k"][1] == ("S(2)" if name == "dense-kv-heads"
                                     else "S(1)"), got["cache_k"]
        assert not [c for c in got["run"]["collectives"]
                    if c["moving"] == "weight"]
        if name in reference["serve"]:
            ref = reference["serve"][name]
            for g, w in _near_tie_cut(got["tokens"], ref["tokens"],
                                      ref["margins"]):
                assert g == w


def test_tp_engine_row_shards_split_groups(tp_serve):
    """ROADMAP C3 on the 1 x 2 mesh: the straddling config's ``wo`` and
    ``down`` (K-shards of 48 and 80 rows, code bytes of 24 and 40 rows)
    run row-parallel on each rank's padded shard, (k1 - k0, d) over the
    groups its bytes touch, in both kernel codecs; none of them is
    replicated."""
    cfg = make_config("repro_torch", "straddle")
    for r in tp_serve:
        rank = r["coordinate"][1]
        for name in ("straddle-m2xfp", "straddle-mxfp4"):
            gemms = r["cases"][name]["run"]["gemms"]
            rows = {g["w"] for g in gemms if g["kind"] == "row"}
            for k in (cfg.n_heads * cfg.hd, cfg.d_ff):
                k0, k1 = _padded_rows(k, 2, rank)
                assert (k1 - k0, cfg.d_model) in rows, (name, k, rows)
            assert not [g for g in gemms if g["kind"] == "replicated"
                        and g["w"][-1] == cfg.d_model
                        and g["w"][0] in (cfg.n_heads * cfg.hd, cfg.d_ff)]


def test_tp_engine_telemetry_as_unplaced(tp_serve):
    """Under REPRO_OBS=1 the placed engine gives the unplaced engine's
    tokens and the same metric names and label sets (the serve GEMM's
    call sites and codecs, the engine's step metrics, the health probes)."""
    for r in tp_serve:
        got = r["obs"]
        assert got["placed"][0] == got["unplaced"][0]
        assert got["placed"][1] == got["unplaced"][1]
        assert any(n == "repro_serve_gemm_traces_total"
                   for n, _ in got["placed"][1])


def test_tp_decode_step_collectives(tp_serve):
    """What one decode launch of the 1 x 2 engine moves per rank: the
    row-parallel all-reduces (f32), the new token's K/V rows and the page
    moved to a head sharding (all-gathers; gloo has no all-to-all), the
    logits' vocabulary gather, and the guard's KV counts (int32). No
    weight."""
    for r in tp_serve:
        dec = r["cases"]["dense-m2xfp"]["decode"]["collectives"]
        ops = {(c["op"], c["dtype"]) for c in dec}
        assert ("all_reduce", "float32") in ops
        assert ("all_reduce", "int32") in ops
        assert all(c["moving"] == "activation" for c in dec)
        print({"decode_step_bytes_per_rank": sum(c["nbytes"] for c in dec),
               "by_op": {f"{o}/{t}": sum(c["nbytes"] for c in dec
                                         if (c["op"], c["dtype"]) == (o, t))
                         for o, t in sorted(ops)}})


# (f) the two levers ----------------------------------------------------------

def _lever_inputs():
    from repro_torch.models.model import init_params
    from repro_torch.models.quant import pack_serving_weight
    gen = torch.Generator().manual_seed(1)
    w = (torch.randn((128, 64), generator=gen) * 0.05)
    experts = torch.randn((128, 64, 96), generator=gen) * 0.05
    weights = {"nvfp4": {"w": pack_serving_weight(w, "nvfp4")},
               "experts": {"ffn": {"gate": pack_serving_weight(
                   experts, "m2xfp")}}}
    cfg = make_config("repro_torch", "variant")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(train_batch(cfg, 2, 8)["tokens"])
    x = torch.randn((8, 256), generator=gen)
    wr = torch.randn((256, 48), generator=gen).to(torch.bfloat16)
    return dict(weights=weights, cfg=cfg, params=params, tokens=tokens,
                row=(x, wr))


@pytest.fixture(scope="module")
def levers(tmp_path_factory):
    from repro_torch.testing.distributed import run_ranks
    inputs = _lever_inputs()
    out = {}
    for shape in ((2, 2), (1, 1)):
        tmp = tmp_path_factory.mktemp(f"levers_{shape[0]}{shape[1]}")
        out[shape] = run_ranks("tp_levers", int(np.prod(shape)), str(tmp),
                               RANK_TIMEOUT_S, shape=shape,
                               axes=("data", "model"), **inputs)
    return inputs, out


@pytest.mark.parametrize("key", ["nvfp4", "experts"])
def test_gather_packed_same_bits_fewer_bytes(levers, key):
    """``decode_serving_weight`` of a placed nvfp4 weight and of a packed
    expert stack on a 2 x 2 mesh: the same local bits with and without
    REPRO_GATHER_PACKED=1; with it the all-gathers along "data" move the
    u8 streams, at most 1/3.5 of the decoded weight's bytes."""
    _, out = levers
    for r in out[(2, 2)]:
        off, on = r["gather"][(key, None)], r["gather"][(key, "1")]
        assert torch.equal(off["local"], on["local"])
        assert off["placements"] == on["placements"]

        def gathered(run):
            return sum(c["nbytes"] for c in run["collectives"]
                       if c["op"] == "all_gather" and c["group"] == "data")
        b_off, b_on = gathered(off["run"]), gathered(on["run"])
        assert b_off > 0 and b_on > 0
        assert b_on * 3.5 <= b_off, (b_on, b_off)
        print({"weight": key, "gathered_bytes_decoded": b_off,
               "gathered_bytes_packed": b_on})
        assert {c["dtype"] for c in on["run"]["collectives"]
                if c["op"] == "all_gather"} <= {"uint8", "float32"}


def test_bf16_tp_reduce(levers):
    """REPRO_BF16_TP_REDUCE=1: every tensor-parallel all-reduce of a
    forward is bf16 (f32 without it: the embedding's all-reduce is bf16
    either way, a bf16 table's rows); the logits stay within
    NONE_LOGIT_TOL of the flag-off logits (each row-parallel partial
    rounded to bf16 before the sum: an ulp flip downstream, as above);
    the row-parallel product with the flag is within 2^-7 of the sum of
    |partials| of the product without it; on one rank the flag-on product
    is the flag-off product rounded to bf16."""
    inputs, out = levers
    x, w = inputs["row"]
    xd = x.double()
    parts = [xd[:, :128] @ w[:128].double(), xd[:, 128:] @ w[128:].double()]
    bound = 2.0 ** -7 * sum(p.abs() for p in parts)
    for r in out[(2, 2)]:
        off, on = r["bf16"][None], r["bf16"]["1"]
        red = lambda run: {c["dtype"] for c in run["collectives"]  # noqa
                           if c["op"] == "all_reduce"
                           and c["group"] == "model"}
        assert red(on["run"]) == {"bfloat16"}
        assert "float32" in red(off["run"])
        d = (on["logits"] - off["logits"]).abs().max()
        assert d <= NONE_LOGIT_TOL, d
        diff = (r["row"]["1"].double() - r["row"][None].double()).abs()
        assert (diff <= bound).all()
        assert (diff > 0).any()
    one = out[(1, 1)][0]
    assert torch.equal(one["row"]["1"],
                       one["row"][None].to(torch.bfloat16).to(torch.float32))
