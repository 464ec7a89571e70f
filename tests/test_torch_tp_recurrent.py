"""Tensor-parallel compute for the recurrent families (ROADMAP A13b):
xlstm-smoke (the ``ssm`` family) and zamba2-smoke (``hybrid``) on weight
shards, against the reference's GSPMD partitioning and the unsharded port.

One child (the reference, with XLA's excess precision off and 4 host
devices) computes:

(a) loss and gradients of TP_CASES on the (1, 2) and (2, 2) ("data",
    "model") meshes (parameters and batch at the train state's
    shardings, jitted under ``use_sharding``), accumulated over one
    microbatch per "data" rank, as tests/test_torch_tp.py does for the
    attention families;
(b) the reference engine's tokens (guard off) and top-2 margins for
    SERVE_CASES (packed m2xfp from its own parameters; 3 requests on 2
    slots, so a slot is reused).

The port runs on gloo ranks (``repro_torch.testing.distributed``): the
sharded step (``tp_train``), a placed engine beside the unplaced one
(``tp_serve``), and a guarded placed engine with a NaN planted in one
rank's part of a head-sharded state (``tp_quarantine``). Bounds are
tests/test_torch_tp.py's, which hold the attention families: the
row-parallel sums of t f32 partials and the gathered rows of the norms
over ``din`` (the same bits as unsharded: the norm runs on the whole row)
move a bf16 rounding at most, so logits, losses and gradients are held to
tests/test_torch_train.py's bounds.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_serve import N_NEW, PROMPTS, _flatten, run_reference_child
from test_torch_tp import (GRAD_L2_REL, MESHES, NEAR_TIE, RANK_TIMEOUT_S,
                           _near_tie_cut, make_config, port_batch, port_tree,
                           train_batch)
from test_torch_train import (LOSS_TOL, NONE_LOGIT_TOL, assert_grads_close,
                              leaves_of)

DEVICES = 4
# name -> (config case of test_torch_tp.CONFIGS, quant, meshes)
TP_CASES = {"xlstm-none": ("xlstm-smoke", "none", ("1x2", "2x2")),
            "zamba2-none": ("zamba2-smoke", "none", ("1x2", "2x2")),
            "xlstm-qat": ("xlstm-smoke", "qat", ("1x2",))}
SERVE_CASES = ("xlstm-smoke", "zamba2-smoke")
SERVE_ENGINE = dict(n_slots=2, max_len=32, prefill_chunk=4)
# (group, leaf) of the head-sharded state each quarantine case poisons
POISON = {"xlstm-smoke": ("mlstm", "C"), "zamba2-smoke": ("mamba", "ssm")}


# ---------------------------------------------------------------------------
# The reference, run in a child process
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    import pickle
    import jax
    from repro.distributed.sharding import use_sharding
    from repro.launch.mesh import make_test_mesh
    from repro.models.model import init_params
    from repro.serve import ServeEngine, prequantize_params
    from repro.train.trainer import (_grads_and_loss, batch_sharding,
                                     make_train_state,
                                     train_state_shardings)
    import jax.numpy as jnp
    from test_torch_variants import _margin_recorder
    out = {"tp": {}, "serve": {}}
    for name, (case, quant, meshes) in TP_CASES.items():
        cfg = make_config("repro", case, quant=quant)
        state = make_train_state(jax.random.PRNGKey(0), cfg)
        batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        res = {"state": _flatten(state)}
        for mesh_name in meshes:
            mesh = make_test_mesh(MESHES[mesh_name], ("data", "model"))
            with use_sharding(mesh):
                p = jax.device_put(state["params"], train_state_shardings(
                    state, mesh)["params"])
                b = jax.device_put(batch, batch_sharding(mesh))
                n_micro = MESHES[mesh_name][0]
                loss, g = jax.jit(lambda p, b: _grads_and_loss(
                    p, cfg, b, n_micro))(p, b)
            res[mesh_name] = (float(loss), _flatten(g))
        out["tp"][name] = res
    for case in SERVE_CASES:
        cfg = make_config("repro", case, quant="serve", quant_format="m2xfp")
        packed = prequantize_params(init_params(jax.random.PRNGKey(0), cfg),
                                    cfg)
        margins = {}
        eng = ServeEngine(packed, cfg, guard=False, **SERVE_ENGINE)
        eng.sample_fn = _margin_recorder(eng, margins)
        out["serve"][case] = {"packed": _flatten(packed),
                              "tokens": eng.generate(PROMPTS, N_NEW),
                              "margins": margins}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES}").strip()
    _reference_main(sys.argv[1])


def _quarantine_ranks(tmp_path_factory) -> list:
    """The ``tp_quarantine`` scenario on a 1 x 2 mesh: per SERVE_CASES a
    guarded placed engine on the port's own packed parameters, with a NaN
    planted in POISON's state of slot 1."""
    from repro_torch.models.model import init_params, pack_params_for_serving
    from repro_torch.testing.distributed import run_ranks
    cases = []
    for case in SERVE_CASES:
        cfg = make_config("repro_torch", case, quant="serve",
                          quant_format="m2xfp")
        params = pack_params_for_serving(init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
        group, leaf = POISON[case]
        cases.append((case, cfg, params, [[1, 2, 3, 4], [5, 6, 7]], 4,
                      group, leaf, 1))
    return run_ranks("tp_quarantine", 2, str(tmp_path_factory.mktemp(
        "tp_quarantine")), RANK_TIMEOUT_S, shape=(1, 2),
        axes=("data", "model"), cases=cases)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """(the reference child's results, the quarantine ranks' results): the
    two run side by side, since the quarantine cases need nothing of the
    reference."""
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(run_reference_child, __file__, tmp_path_factory)
        quarantine = pool.submit(_quarantine_ranks, tmp_path_factory)
        return ref.result(), quarantine.result()


@pytest.fixture(scope="module")
def reference(children):
    return children[0]


# ---------------------------------------------------------------------------
# (a) the sharded train step
# ---------------------------------------------------------------------------

def _train_inputs(reference, name):
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
    from repro_torch.testing.distributed import run_ranks
    out = {}
    for mesh_name, shape in MESHES.items():
        cases = [_train_inputs(reference, n) for n, (_, _, meshes)
                 in TP_CASES.items() if mesh_name in meshes]
        tmp = tmp_path_factory.mktemp(f"tp_recurrent_{mesh_name}")
        out[mesh_name] = ({c[0]: c for c in cases}, run_ranks(
            "tp_train", int(np.prod(shape)), str(tmp), RANK_TIMEOUT_S,
            shape=shape, axes=("data", "model"), cases=cases))
    return out


TRAIN_GRID = [(n, m) for n, (_, _, meshes) in TP_CASES.items()
              for m in meshes]


def _products(cfg) -> dict:
    """{projection: (K, N, kind)} of one block of each kind: the column
    products' N and the row products' K are sharded over "model"."""
    d = cfg.d_model
    din = 2 * d if cfg.family == "ssm" else cfg.ssm_expand * d
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import slstm_ff
        ff = slstm_ff(d)
        return {"up": (d, 2 * din, "column"), "w_o": (d, din, "column"),
                "down": (din, d, "row"), "w": (d, 4 * d, "column"),
                "ff_up": (d, ff, "column"), "ff_down": (ff, d, "row")}
    nh = din // cfg.ssm_head_dim
    return {"in_proj": (d, 2 * din + 2 * cfg.ssm_state + nh, "column"),
            "out_proj": (din, d, "row"),
            "wq": (d, cfg.n_heads * cfg.hd, "column"),
            "wo": (cfg.n_heads * cfg.hd, d, "row"),
            "gate": (d, cfg.d_ff, "column"), "down": (cfg.d_ff, d, "row")}


@pytest.mark.parametrize("name,mesh_name", TRAIN_GRID)
def test_tp_recurrent_train_computes_on_shards(tp_train, name, mesh_name):
    """Every projection of the mLSTM, sLSTM and Mamba2 blocks (and the
    hybrid's shared attention block) runs on its local (K, N/t) or
    (K/t, N) shard; the mLSTM's q/k/v products on its (H/t, P, P) blocks;
    no weight is gathered along "model"; each rank's parameter bytes are
    ``shard_nbytes``."""
    cases, ranks = tp_train[mesh_name]
    cfg = cases[name][1]
    t = MESHES[mesh_name][1]
    for r in ranks:
        got = r["cases"][name]
        assert got["param_bytes"] == got["shard_nbytes"]
        for run in ("grads_run", "step_run"):
            seen = {(g["kind"], g["w"]) for g in got[run]["gemms"]}
            for k, n, kind in _products(cfg).values():
                local = (k, n // t) if kind == "column" else (k // t, n)
                assert (kind, local) in seen, (run, kind, local, seen)
            if cfg.family == "ssm":
                p_ = 2 * cfg.d_model // cfg.n_heads
                assert ("heads", (cfg.n_heads // t, p_, p_)) in seen
            assert not [c for c in got[run]["collectives"]
                        if c["moving"] == "weight" and c["group"] == "model"]


@pytest.mark.parametrize("name,mesh_name", TRAIN_GRID)
def test_tp_recurrent_train_matches_unsharded_and_reference(
        reference, tp_train, name, mesh_name):
    """Each rank's logits, loss and gradients of its batch slice against
    the unsharded port's, their mean over the batch ranks against the
    reference's GSPMD step on the same mesh, and the sharded step's loss
    and grad_norm against the plain step's and the reference's, within
    tests/test_torch_train.py's bounds."""
    from repro_torch.convert import flat_leaves, stack_layers
    _, ranks = tp_train[mesh_name]
    for r in ranks:
        got = r["cases"][name]
        d = (got["logits"] - got["plain_logits"]).abs().max()
        assert d <= NONE_LOGIT_TOL, d
        assert abs(float(got["loss"]) - float(got["plain_loss"])) <= LOSS_TOL
        assert_grads_close(leaves_of(got["grads"]),
                           leaves_of(got["plain_grads"]), name)
        m, pm = got["metrics"], got["plain_metrics"]
        assert abs(float(m["loss"]) - float(pm["loss"])) <= LOSS_TOL
        assert abs(float(m["grad_norm"]) - float(pm["grad_norm"])) <= \
            GRAD_L2_REL * float(pm["grad_norm"])
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


# ---------------------------------------------------------------------------
# (b) the placed engine
# ---------------------------------------------------------------------------

def _serve_cases(reference):
    cases = []
    for case in SERVE_CASES:
        cfg = make_config("repro_torch", case, quant="serve",
                          quant_format="m2xfp")
        packed = port_tree(reference["serve"][case]["packed"], cfg)
        cases.append((case, cfg, packed, PROMPTS, N_NEW, dict(SERVE_ENGINE)))
    return cases


@pytest.fixture(scope="module")
def tp_serve(reference, tmp_path_factory):
    from repro_torch.testing.distributed import run_ranks
    return run_ranks("tp_serve", 2, str(tmp_path_factory.mktemp(
        "tp_serve_recurrent")), RANK_TIMEOUT_S, shape=(1, 2),
        axes=("data", "model"), cases=_serve_cases(reference))


# each state leaf's placements on the (1, 2) mesh: slots whole ("data" of
# size 1), the per-head states over "model", the conv windows and the
# sLSTM's c and h replicated
STATE_PLACEMENTS = {
    "xlstm-smoke": {"C": ["S(0)", "S(1)"], "n": ["S(0)", "S(1)"],
                    "m": ["S(0)", "S(1)"], "conv": ["S(0)", "R"],
                    "c": ["S(0)", "R"], "h": ["S(0)", "R"]},
    "zamba2-smoke": {"ssm": ["S(0)", "S(1)"], "conv": ["S(0)", "R"],
                     "k": ["S(0)", "S(1)"], "v": ["S(0)", "S(1)"],
                     "pos": ["R", "R"]}}


@pytest.mark.parametrize("name", SERVE_CASES)
def test_tp_recurrent_engine_tokens(reference, tp_serve, name):
    """A 1 x 2 engine on placed m2xfp parameters gives the unplaced
    engine's tokens (chunks of 1, as the recurrent families always run)
    and the reference engine's up to a request's first near-tie, with a
    reused slot; every state leaf stays at its placement after each step
    (the per-head states head-sharded); the products run on column and
    row shards and no weight moves."""
    for r in tp_serve:
        got = r["cases"][name]
        assert got["tokens"] == got["want"]
        assert got["tokens_chunk1"] == got["want"]
        assert got["placements_kept"] and all(got["placements_kept"])
        assert got["cache_placements"] == STATE_PLACEMENTS[name]
        kinds = {g["kind"] for g in got["run"]["gemms"]}
        assert {"column", "row"} <= kinds
        assert not [c for c in got["run"]["collectives"]
                    if c["moving"] == "weight"]
        ref = reference["serve"][name]
        for g, w in _near_tie_cut(got["tokens"], ref["tokens"],
                                  ref["margins"]):
            assert g == w


def test_tp_recurrent_decode_moves_activations_only(tp_serve):
    """One decode launch of each placed engine moves activations only:
    the column products' outputs gathered whole (all-gathers), the row
    products' partial sums and the guard's int32 counts (all-reduces);
    no weight."""
    for r in tp_serve:
        for name in SERVE_CASES:
            dec = r["cases"][name]["decode"]["collectives"]
            ops = {(c["op"], c["dtype"]) for c in dec}
            assert ("all_gather", "float32") in ops or \
                ("all_gather", "bfloat16") in ops
            assert ("all_reduce", "int32") in ops
            assert all(c["moving"] == "activation" for c in dec)


@pytest.fixture(scope="module")
def tp_quarantine(children):
    return children[1]


@pytest.mark.parametrize("name", SERVE_CASES)
def test_tp_recurrent_quarantines_one_slot(tp_quarantine, name):
    """A NaN in rank 0's part of slot 1's head-sharded state (the mLSTM's
    C, Mamba2's ssm) is counted by the KV sentinel summed over "model":
    on both ranks the request in slot 1 alone is quarantined and its
    state scrubbed, and the other request finishes with its clean
    tokens."""
    for r in tp_quarantine:
        got = r["cases"][name]
        assert got["placement"] == ["S(0)", "S(1)"]
        poisoned = got["slots_of"].index(1)
        for i, (state, out) in enumerate(zip(got["states"],
                                             got["outputs"])):
            if i == poisoned:
                assert state == "quarantined"
            else:
                assert state != "quarantined"
                assert out == got["clean"][i]
        assert got["quarantined"] == 1
        assert got["summary"]["quarantines"] == 1
        assert not got["nan_left"]
