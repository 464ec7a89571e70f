"""The port's distributed and launch surface (ROADMAP A11) against the
reference.

One child (the reference, run as in test_torch_serve.py with XLA's excess
precision off, and with 512 host devices so that the production meshes
exist) computes:

(a) every leaf's spec under ``param_shardings`` (the dense and the packed
    tree), ``train_state_shardings`` (the f32 train state) and
    ``cache_shardings`` (the per-slot caches of each applicable decode
    shape, long_500k with its rule override) for all eleven configs on
    the 256- and 512-device meshes; each arch's trees are traced once
    (``jax.eval_shape``) and reused across shapes and meshes;
(b) the bytes per device (``NamedSharding.shard_shape``) of parameters,
    optimizer state, caches and inputs of every dry-run cell (the ten
    archs but paper-llama2-7b x applicable shapes x both meshes), a few
    decode cells with an m2xfp KV cache (zamba2-7b's head_dim of 112
    fails there: the first K row does not encode), and xlstm-125m
    decode_32k on a 2 x 4 test mesh;
(c) ``pipeline_apply`` on a (4, 2) ("pipe", "model") mesh with the inputs
    of tests/test_pipeline.py;
(d) ``compressed_psum`` on a (2, 2, 2) ("pod", "data", "model") mesh with
    the inputs of tests/test_sharding.py, and one compressed train step of
    a tiny dense config on a 2-pod mesh;
(e) which rows of a tensor each device of a (2, 2) ("pod", "data") mesh
    holds under specs where two axes shard one dim;
(f) the errors of REPRO_MOE_GROUP, REPRO_KV_QUANT and REPRO_RULES_JSON.

The port's multi-rank runs use gloo on the CPU, 2 or 4 ranks, a
``FileStore`` under the test's ``tmp_path`` and a time limit each
(``repro_torch.testing.distributed.run_ranks``, which kills the ranks and
fails when it is reached).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_serve import run_reference_child

MESHES = ("pod256", "pod512")
DEVICES = 512
# (c): tests/test_pipeline.py's shapes
PIPE = dict(n_stages=4, n_micro=6, mb=8, d=32)
# (d): tests/test_sharding.py's tiny model and compression
TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
            remat=False)
STEP_OPT = dict(lr=1e-3)
STEP_TOPK = 0.5
# (b) decode cells with an m2xfp KV cache
KV_CELLS = [("zamba2-7b", "decode_32k"), ("qwen2-0.5b", "decode_32k")]
# (e) (spec, shape) on the (2, 2) ("pod", "data") mesh
ORDER_CASES = [((("pod", "data"),), (8,)),
               ((("pod", "data"), None), (8, 3)),
               (("data", "pod"), (4, 6))]
# (f)
BAD_FLAGS = [("REPRO_MOE_GROUP", "x", "olmoe-1b-7b", "train_4k"),
             ("REPRO_MOE_GROUP", "0", "olmoe-1b-7b", "train_4k"),
             ("REPRO_KV_QUANT", "bogus", "qwen2-0.5b", "decode_32k"),
             ("REPRO_RULES_JSON", "{bad", "qwen2-0.5b", "prefill_32k")]
RANK_TIMEOUT_S = 120


def tiny_batch(n: int = 8, s: int = 32) -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (n, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (n, s)).astype(np.int32)}


def pipe_inputs():
    """tests/test_pipeline.py's weights and microbatches."""
    rng = np.random.default_rng(0)
    n, m, mb, d = (PIPE[k] for k in ("n_stages", "n_micro", "mb", "d"))
    ws = (rng.standard_normal((n, d, d)) * d ** -0.5).astype(np.float32)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    return ws, x


def psum_grads() -> np.ndarray:
    """tests/test_sharding.py's (2, 64) gradient, one row per pod."""
    return np.random.default_rng(0).standard_normal((2, 64)).astype(
        np.float32)


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
    import pickle

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS, get_config
    from repro.configs.shapes import SHAPES, applicable_shapes, input_specs
    from repro.core import envflags
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import (_path_names, cache_shardings,
                                            logical_to_spec,
                                            param_shardings, use_sharding)
    from repro.launch.mesh import make_production_mesh, make_test_mesh
    from repro.models.config import ModelConfig
    from repro.models.kvquant import kv_encode
    from repro.models.model import (init_caches, init_params,
                                    pack_params_for_serving)
    from repro.train.compression import CompressionConfig, compressed_psum
    from repro.train.optimizer import AdamWConfig
    from repro.train.trainer import (make_train_state, make_train_step,
                                     train_state_shardings)
    from test_torch_serve import _flatten

    key = jax.random.key(0)
    meshes = {"pod256": make_production_mesh(),
              "pod512": make_production_mesh(multi_pod=True)}

    def specs(shardings) -> dict:
        return {"/".join(_path_names(p)): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(shardings)[0]}

    def nbytes(tree, shardings) -> int:
        flat_t = jax.tree.leaves(tree)
        flat_s = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
            x, NamedSharding))
        return sum(int(np.prod(s.shard_shape(t.shape))) * t.dtype.itemsize
                   for t, s in zip(flat_t, flat_s))

    def data_sh(batch, mesh, rules):
        with use_sharding(mesh, rules):
            return {k: NamedSharding(mesh, logical_to_spec(
                ("batch",) + (None,) * (len(v.shape) - 1), v.shape))
                for k, v in batch.items()}

    def caches_of(cfg, shape):
        s = SHAPES[shape]
        return jax.eval_shape(lambda: init_caches(
            cfg, s["batch"], s["seq"], per_slot=True))

    def rules_of(shape):
        return {"kv_seq": ("data", "model")} if shape == "long_500k" \
            else None

    def cell_bytes(trees, mesh, rules) -> dict:
        out = dict.fromkeys(("params", "opt_state", "caches", "inputs"), 0)
        if "train" in trees:
            sh = train_state_shardings(trees["train"], mesh, rules)
            out["params"] = nbytes(trees["train"]["params"], sh["params"])
            out["opt_state"] = nbytes(trees["train"]["opt"], sh["opt"])
        else:
            out["params"] = nbytes(trees["packed"], param_shardings(
                trees["packed"], mesh, rules))
        if "caches" in trees:
            out["caches"] = nbytes(trees["caches"], cache_shardings(
                trees["caches"], mesh, rules))
        out["inputs"] = nbytes(trees["inputs"], data_sh(
            trees["inputs"], mesh, rules))
        out["total"] = sum(out.values())
        return out

    out = {"specs": {}, "bytes": {}}
    for arch in ARCHS:
        base = get_config(arch)
        scfg = dataclasses.replace(base, quant="serve")
        dense = jax.eval_shape(lambda: init_params(key, base))
        packed = jax.eval_shape(
            lambda p: pack_params_for_serving(p, scfg), dense)
        train = jax.eval_shape(lambda: make_train_state(key, base))
        decode = [s for s in applicable_shapes(base)
                  if SHAPES[s]["kind"] == "decode"]
        caches = {s: caches_of(scfg, s) for s in decode}
        for name, mesh in meshes.items():
            out["specs"][(arch, name)] = {
                "dense": specs(param_shardings(dense, mesh)),
                "packed": specs(param_shardings(packed, mesh)),
                "train": specs(train_state_shardings(train, mesh)),
                "caches": {s: specs(cache_shardings(caches[s], mesh,
                                                    rules_of(s)))
                           for s in decode}}
            if arch == ARCHS[-1]:      # the paper config: no dry-run cells
                continue
            for shape in applicable_shapes(base):
                kind = SHAPES[shape]["kind"]
                trees = {"inputs": input_specs(base, shape)}
                if kind == "train":
                    trees["train"] = train
                else:
                    trees["packed"] = packed
                if kind == "decode":
                    trees["caches"] = caches[shape]
                out["bytes"][(arch, shape, name)] = cell_bytes(
                    trees, mesh, rules_of(shape))
    # m2xfp KV pages: the cell fails where one K row does not encode
    out["kv_bytes"] = {}
    for arch, shape in KV_CELLS:
        cfg = dataclasses.replace(get_config(arch), quant="serve",
                                  kv_quant="m2xfp")
        try:
            s = SHAPES[shape]
            jax.eval_shape(lambda: kv_encode(jnp.zeros(
                (s["batch"], 1, cfg.n_kv_heads, cfg.hd), jnp.bfloat16),
                "m2xfp"))
            dense = jax.eval_shape(lambda: init_params(key, cfg))
            trees = {"inputs": input_specs(cfg, shape),
                     "packed": jax.eval_shape(
                         lambda p: pack_params_for_serving(p, cfg), dense),
                     "caches": caches_of(cfg, shape)}
            got = {m: cell_bytes(trees, meshes[m], rules_of(shape))
                   for m in MESHES}
        except Exception as e:         # noqa: BLE001 -- a failing cell
            got = f"{type(e).__name__}: {e}"
        out["kv_bytes"][(arch, shape)] = got
    # test_dryrun_cell_small_mesh's cell
    small = make_test_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(get_config("xlstm-125m"), quant="serve")
    trees = {"inputs": input_specs(cfg, "decode_32k"),
             "packed": jax.eval_shape(lambda p: pack_params_for_serving(
                 p, cfg), jax.eval_shape(lambda: init_params(key, cfg))),
             "caches": caches_of(cfg, "decode_32k")}
    out["small_mesh"] = cell_bytes(trees, small, None)

    # (c) the pipeline
    mesh = make_test_mesh((4, 2), ("pipe", "model"))
    ws, x = pipe_inputs()
    out["pipeline"] = np.asarray(pipeline_apply(
        lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x),
        mesh, PIPE["n_stages"]))

    # (d) compressed psum and one compressed train step
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    cc = CompressionConfig(enabled=True, int8=True, topk_density=1.0)
    g = jnp.asarray(psum_grads())

    def body(g, err):
        red, new_err = compressed_psum({"g": g}, {"g": err}, cc, "pod", 2)
        return red["g"], new_err["g"]
    red, new_err = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P("pod"), P("pod")), axis_names={"pod"},
        check_vma=False))(g, jnp.zeros_like(g))
    out["psum"] = {"reduced": np.asarray(red), "err": np.asarray(new_err)}
    cfg = ModelConfig(**TINY)
    cc = CompressionConfig(enabled=True, int8=True, topk_density=STEP_TOPK)
    state = make_train_state(jax.random.PRNGKey(0), cfg, cc)
    mesh = make_test_mesh((2, 1, 1), ("pod", "data", "model"))
    step = make_train_step(cfg, AdamWConfig(**STEP_OPT), cc, mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch().items()}
    new_state, metrics = jax.jit(step)(state, batch)
    out["step"] = {"state": _flatten(state),
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "new_params": _flatten(new_state["params"])}

    # (e) which rows each device holds
    mesh = make_test_mesh((2, 2), ("pod", "data"))
    out["order"] = []
    for spec, shape in ORDER_CASES:
        imap = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        out["order"].append({
            (i, j): [(sl.start or 0, shape[d] if sl.stop is None
                      else sl.stop) for d, sl in enumerate(
                          imap[mesh.devices[i, j]])]
            for i in range(2) for j in range(2)})

    # (f) flag errors: the dry-run reads them as its run_cell does
    out["flags"] = {}
    for name, value, arch, shape in BAD_FLAGS:
        os.environ[name] = value
        try:
            if name == "REPRO_MOE_GROUP":
                err = _raises(lambda: envflags.get_int(name))
            elif name == "REPRO_RULES_JSON":
                err = _raises(lambda: json.loads(envflags.get_str(name)))
            else:
                err = _raises(lambda: caches_of(dataclasses.replace(
                    get_config(arch), quant="serve",
                    kv_quant=envflags.get_str(name)), shape))
        finally:
            del os.environ[name]
        out["flags"][(name, value)] = err
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
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

def _port_specs(shardings, cfg=None, caches=False) -> dict:
    """{reference path: spec} of the port's sharding tree: list indices
    dropped, gemma2's alternating cache layers under the reference's
    "local" / "global" stacks; with the spec of a per-layer leaf as the
    stacked leaf's (a leading None added)."""
    from repro_torch.distributed.sharding import map_with_path
    out = {}

    def visit(path, s):
        names = [str(p) for p in path if not isinstance(p, int)]
        stacked = any(isinstance(p, int) for p in path)
        if caches and cfg.local_global and names[0] == "layers":
            names[0] = "local" if path[1] % 2 == 0 else "global"
        spec = ((None,) + s.spec) if stacked else s.spec
        key = "/".join(names)
        assert out.setdefault(key, spec) == spec, key   # every layer alike
    map_with_path(visit, shardings)
    return out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "qwen2.5-14b", "qwen2-0.5b", "gemma2-9b",
                                  "qwen3-8b", "musicgen-large",
                                  "pixtral-12b", "paper-llama2-7b",
                                  "xlstm-125m", "zamba2-7b"])
def test_leaf_specs_match_reference(reference, arch):
    """Every leaf's spec, as a tuple, equals the reference's on both
    production meshes: the dense and packed parameter trees, the train
    state and the caches of each decode shape (per-layer leaves against
    the stacked leaf minus its leading None)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import cache_specs
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings)
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import init_params
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.train import make_train_state, train_state_shardings
    base = get_config(arch)
    scfg = dataclasses.replace(base, quant="serve")
    gen = torch.Generator()
    dense = init_params(gen, base, "meta")
    packed = init_packed_params(gen, scfg, "meta")
    state = make_train_state(gen, base, device="meta")
    for name in MESHES:
        mesh = make_production_mesh(multi_pod=name == "pod512")
        want = reference["specs"][(arch, name)]
        assert _port_specs(param_shardings(dense, mesh)) == want["dense"]
        assert _port_specs(param_shardings(packed, mesh)) == want["packed"]
        assert _port_specs(train_state_shardings(state, mesh)) == \
            want["train"]
        for shape, ref in want["caches"].items():
            caches = cache_specs(scfg, shape)
            assert _port_specs(cache_shardings(caches, mesh,
                                               cell_rules(shape)),
                               scfg, caches=True) == ref, shape


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "qwen2.5-14b", "qwen2-0.5b", "gemma2-9b",
                                  "qwen3-8b", "musicgen-large",
                                  "pixtral-12b", "xlstm-125m", "zamba2-7b"])
def test_dryrun_bytes_per_rank_match_reference(reference, arch):
    """The dry-run's bytes per rank of parameters, optimizer state, caches
    and inputs equal the reference's as integers, for every applicable
    shape on both meshes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import applicable_shapes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    shapes = applicable_shapes(get_config(arch))
    assert arch in dryrun.DRYRUN_ARCHS
    memo = {}
    for shape in shapes:
        trees = dryrun.build_trees(dryrun.cell_config(arch, shape), shape,
                                   memo)
        for name in MESHES:
            got = dryrun.bytes_per_rank(
                trees, make_production_mesh(multi_pod=name == "pod512"),
                dryrun.cell_rules(shape))
            assert got == reference["bytes"][(arch, shape, name)], \
                (shape, name)
    assert {k[1] for k in reference["bytes"] if k[0] == arch} == set(shapes)


def test_dryrun_cells_with_m2xfp_kv_pages(reference, monkeypatch):
    """With REPRO_KV_QUANT=m2xfp a cell that fails in the reference fails
    in the port (zamba2-7b: one K row of head_dim 112 does not encode in
    groups of 32) with its message, and one that runs has its bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    monkeypatch.setenv("REPRO_KV_QUANT", "m2xfp")
    for (arch, shape), want in reference["kv_bytes"].items():
        for name in MESHES:
            try:
                got = dryrun.bytes_per_rank(
                    dryrun.build_trees(dryrun.cell_config(arch, shape),
                                       shape),
                    make_production_mesh(multi_pod=name == "pod512"),
                    dryrun.cell_rules(shape))
            except Exception as e:  # noqa: BLE001 -- compared below
                got = f"{type(e).__name__}: {e}"
            if isinstance(want, str):
                assert got == want, (arch, got)
            else:
                assert got == want[name], arch
    assert isinstance(reference["kv_bytes"][("zamba2-7b", "decode_32k")],
                      str)


def test_dryrun_cell_small_mesh(reference):
    """tests/test_sharding.py::test_dryrun_cell_small_mesh's cell
    (xlstm-125m decode_32k) on a logical 2 x 4 mesh: its bytes per rank
    equal the reference's on its 2 x 4 test mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LogicalMesh
    mesh = LogicalMesh(("data", "model"), (2, 4))
    trees = dryrun.build_trees(dryrun.cell_config("xlstm-125m",
                                                  "decode_32k"),
                               "decode_32k")
    assert mesh.size == 8
    assert dryrun.bytes_per_rank(trees, mesh) == reference["small_mesh"]


@pytest.mark.parametrize("name,value", [f[:2] for f in BAD_FLAGS])
def test_flag_errors_match_reference(reference, monkeypatch, name, value):
    """REPRO_MOE_GROUP, REPRO_KV_QUANT and REPRO_RULES_JSON, set to a bad
    value, fail the dry-run's cell with the reference's error."""
    from repro_torch.launch import dryrun
    arch, shape = next(f[2:] for f in BAD_FLAGS if f[:2] == (name, value))
    monkeypatch.setenv(name, value)
    r = dryrun.run_cell(arch, shape, False, save=False)
    want = reference["flags"][(name, value)]
    assert want is not None and not r["ok"]
    assert r["error"] == want


def test_rules_json_and_long_context_rules(monkeypatch):
    """The cell's rules: long_500k's kv_seq over both axes, then
    REPRO_RULES_JSON's overrides (lists as tuples), as the reference's
    run_cell builds them."""
    from repro_torch.launch.dryrun import cell_rules
    assert cell_rules("decode_32k") is None
    assert cell_rules("long_500k") == {"kv_seq": ("data", "model")}
    monkeypatch.setenv("REPRO_RULES_JSON",
                       '{"fsdp": null, "mlp": ["data", "model"]}')
    assert cell_rules("long_500k") == {"kv_seq": ("data", "model"),
                                       "fsdp": None,
                                       "mlp": ("data", "model")}


# the reference's own unit cases, and padding / reuse / filter cases of
# logical_to_spec on a logical 2 x 16 x 16 and 16 x 16 mesh
AXES_CASES = [(("layers", "attn", "wq"), (4, 64, 128)),
              (("layers", "ffn", "down"), (4, 128, 64)),
              (("layers", "ffn", "gate"), (4, 8, 64, 128)),
              (("mlstm", "wq"), (4, 2, 16, 16)),
              (("embed",), (1000, 64)), (("final_norm",), (64,)),
              (("shared_attn", "attn", "bq"), (512,)),
              (("mamba_norm",), (6, 64)), (("layers", "ffn", "router"),
                                           (4, 64, 8))]
SPEC_CASES = [(("batch", "seq", "heads"), (64, 10, 40), True),
              (("batch", "seq", "heads"), (64, 10, 40), False),
              (("batch", "kv_heads"), (64, 2), True),
              (("fsdp", "mlp"), (4096, 11008), False),
              (("mlp", "heads"), (512, 512), False),
              (("cache_batch", "kv_seq"), (1, 32768), False),
              (("expert", "fsdp", "expert_mlp"), (8, 6144, 16384), False)]


def test_infer_logical_axes_matches_reference():
    from repro.distributed import sharding as ref
    from repro_torch.distributed import sharding as port
    for names, shape in AXES_CASES:
        assert port.infer_logical_axes(names, shape) == \
            ref.infer_logical_axes(names, shape), names


@pytest.mark.parametrize("multi_pod", [False, True])
def test_logical_to_spec_matches_reference(multi_pod):
    """The reference's logical_to_spec and use_sharding read only a mesh's
    axis names and sizes, so they take the port's logical mesh: the same
    specs, with rule overrides, padding and one use per mesh axis."""
    from repro.distributed import sharding as ref
    from repro_torch.distributed import sharding as port
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    for rules in (None, {"kv_seq": ("data", "model"), "mlp": "model",
                         "heads": ("pod", "model")}):
        for axes, shape, pad in SPEC_CASES:
            with ref.use_sharding(mesh, rules):
                want = tuple(ref.logical_to_spec(axes, shape,
                                                 allow_pad=pad))
            with port.use_sharding(mesh, rules):
                got = port.logical_to_spec(axes, shape, allow_pad=pad)
            assert got == want, (axes, shape, pad, rules)


def test_constrain_and_named_sharding_outside_a_mesh():
    from repro_torch.distributed.sharding import (active_mesh, constrain,
                                                  named_sharding,
                                                  use_sharding)
    from repro_torch.launch.mesh import LogicalMesh
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", "embed")) is x
    assert named_sharding(("batch",), (4,)) is None
    mesh = LogicalMesh(("data", "model"), (2, 2))
    with use_sharding(mesh):
        assert active_mesh() is mesh
        assert constrain(x, ("batch", "embed")) is x   # a plain tensor
        assert named_sharding(("batch", None), (4, 8)).spec == \
            ("data", None)
    assert active_mesh() is None


def test_make_test_mesh_needs_a_process_group():
    """Without an initialised process group the process mesh refuses:
    nothing falls back to one process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh((1, 1), ("data", "model"), "cpu")


def test_report_table_and_help(tmp_path, monkeypatch, capsys):
    """report.py's tables from the dry-run's JSONs (OK/FAIL and bytes per
    rank on both meshes; the roofline's terms and dominant term on
    pod256), and the dry-run's --help naming what the port does not
    report."""
    from repro_torch.launch import dryrun, report
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    for mp in (False, True):
        dryrun.run_cell("xlstm-125m", "decode_32k", mp)
    table = report.dryrun_table(report.load("pod256", str(tmp_path)),
                                report.load("pod512", str(tmp_path)))
    row = next(ln for ln in table.splitlines()
               if ln.startswith("| xlstm-125m | decode_32k |"))
    assert "| OK | OK |" in row
    assert "| xlstm-125m | train_4k | FAIL | FAIL |" in table
    assert "2 cells passed." in table
    roof = report.roofline_table(report.load("pod256", str(tmp_path)))
    row = next(ln for ln in roof.splitlines()
               if ln.startswith("| xlstm-125m | decode_32k |"))
    assert any(f"**{d}**" in row for d in ("compute", "memory",
                                            "collective"))
    monkeypatch.setattr(sys, "argv", ["dryrun", "--help"])
    with pytest.raises(SystemExit):
        dryrun.main()
    assert "no XLA" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Multi-rank runs (gloo on the CPU)
# ---------------------------------------------------------------------------

def _ranks(scenario, world, tmp_path, **inputs):
    from repro_torch.testing.distributed import run_ranks
    return run_ranks(scenario, world, str(tmp_path / scenario),
                     RANK_TIMEOUT_S, **inputs)


def test_pipeline_matches_sequential_and_reference(reference, tmp_path):
    """GPipe fill-drain over 4 gloo ranks: every rank's result is the
    stages applied one after another to each microbatch, bit for bit, and
    within the reference's 1e-5 of its (4, 2)-mesh result."""
    ws, x = pipe_inputs()
    outs = _ranks("pipeline", PIPE["n_stages"], tmp_path,
                  ws=torch.from_numpy(ws), x=torch.from_numpy(x))
    for r in outs:
        assert torch.equal(r["out"], r["sequential"])
        assert torch.equal(r["out"], outs[0]["out"])
    err = np.abs(outs[0]["out"].numpy() - reference["pipeline"]).max()
    assert err < 1e-5, err


def test_compressed_psum_cross_pod(reference, tmp_path):
    """compressed_psum over 2 pods: the pods hold the same result, within
    0.02 of the true mean (tests/test_sharding.py's bound), and equal to
    the reference's, bit for bit, once the port's divisions by a constant
    are taken as XLA's jit takes them (times the rounded reciprocal, as
    test_jit_is_the_reciprocal_rewrite shows for the codecs); the error
    feedback then equals the reference's up to XLA's fma contraction of
    x - q * scale (emulated here)."""
    from repro_torch.train import CompressionConfig
    g = psum_grads()
    grads = [{"g": torch.from_numpy(g[i:i + 1])} for i in range(2)]
    cc = CompressionConfig(enabled=True, int8=True, topk_density=1.0)
    shape, axes = (2, 1, 1), ("pod", "data", "model")
    exact = _ranks("compressed_psum", 2, tmp_path, shape=shape, axes=axes,
                   grads=grads, cfg=cc)
    assert [r["pod"] for r in exact] == [0, 1]
    a, b = (r["reduced"]["g"] for r in exact)
    assert torch.equal(a, b)
    true_mean = g.mean(axis=0)
    assert np.abs(a.numpy()[0] - true_mean).max() < 0.02
    recip = _ranks("compressed_psum", 2, tmp_path / "recip", shape=shape,
                   axes=axes, grads=grads, cfg=cc, reciprocal=True)
    want = reference["psum"]
    # the error feedback x - q * scale: XLA's CPU fusion contracts it into
    # one fma (a single rounding), the port rounds the product and the
    # difference; an fma emulated in float64 gives the reference's bits
    scale = torch.tensor(np.abs(g).max()) * (1.0 / 127.0)
    q = torch.clamp(torch.round(torch.from_numpy(g) / scale), -127, 127)
    fma = (torch.from_numpy(g).double() - q.double() * scale.double())
    for pod, r in enumerate(recip):
        np.testing.assert_array_equal(r["reduced"]["g"].numpy()[0],
                                      want["reduced"][pod])
        np.testing.assert_array_equal(want["err"][pod],
                                      fma.float().numpy()[pod])
        np.testing.assert_array_equal(r["err"]["g"].numpy()[0],
                                      (torch.from_numpy(g) - q * scale)
                                      .numpy()[pod])
    diff = (a.numpy()[0].view(np.uint32)
            != want["reduced"][0].view(np.uint32)).mean()
    assert diff > 0         # without the rewrite the bits do differ
    print({"exact_vs_reference_bits_differing": float(diff)})


def test_compressed_train_step_matches_reference(reference, tmp_path):
    """One compressed train step (int8, top-k 0.5 per leaf of the
    reference's layout) on 2 pods from the reference's state: both pods
    end with the same parameters, and the loss and grad_norm are within
    test_torch_train.py's trajectory bounds of the reference's."""
    from test_torch_train import TRAJ_GNORM_RTOL, TRAJ_LOSS_TOL
    from repro_torch.convert import from_jax_train_state
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import AdamWConfig, CompressionConfig
    cfg = ModelConfig(**TINY)
    want = reference["step"]
    state = from_jax_train_state(want["state"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch().items()}
    outs = _ranks("compressed_step", 2, tmp_path,
                  shape=(2, 1, 1), axes=("pod", "data", "model"), cfg=cfg,
                  opt=AdamWConfig(**STEP_OPT),
                  compression=CompressionConfig(True, True, STEP_TOPK),
                  state=state, batch=batch)
    from repro_torch.tree import tree_leaves
    for part in ("params", "opt"):           # err stays each pod's own
        for x, y in zip(tree_leaves(outs[0]["state"][part]),
                        tree_leaves(outs[1]["state"][part])):
            assert torch.equal(x, y)
    m, w = outs[0]["metrics"], want["metrics"]
    assert abs(float(m["loss"]) - w["loss"]) <= TRAJ_LOSS_TOL
    assert abs(float(m["grad_norm"]) - w["grad_norm"]) <= \
        TRAJ_GNORM_RTOL * w["grad_norm"]


def test_sharded_step_on_a_2x2_mesh(tmp_path):
    """make_sharded_train_step on a 2 x 2 ("data", "model") gloo mesh:
    ffn.gate holds a quarter of its elements on every rank, the loss falls
    over two steps, and against make_train_step(num_microbatches=2) on the
    whole batch (its states cut to the same placements;
    test_placement_order_matches_reference holds the cut) lr and the step
    count are equal and, with the model's compute tensor-parallel over
    "model" (t = 2: its row-parallel partial sums round in another order),
    the loss and grad_norm are within test_torch_train.py's bounds and
    after each step every moment and parameter shard is within what
    gradients agreeing within GRAD_L2 allow (``adamw_agreement``: m and v
    per leaf from the clipped gradients' bound, each parameter from the
    update of its own moments). test_sharded_step_on_a_2x1_mesh keeps the
    bit-for-bit claim where no product is split."""
    from test_torch_train import LOSS_TOL
    from repro_torch.models.config import ModelConfig
    from repro_torch.testing.train import GRAD_L2, adamw_agreement
    from repro_torch.train import AdamWConfig, make_train_state
    cfg = ModelConfig(**TINY)
    state = make_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch().items()}
    opt = AdamWConfig(**STEP_OPT)
    outs = _ranks("sharded_step", 4, tmp_path, shape=(2, 2),
                  axes=("data", "model"), cfg=cfg, opt=opt, state=state,
                  batches=[batch, batch])
    for r in outs:
        gate = r["local"]["params"]["layers"][0]["ffn"]["gate"]
        full = r["plain"]["params"]["layers"][0]["ffn"]["gate"]
        assert gate.numel() / full.numel() <= 0.25
        assert float(r["metrics"][1]["loss"]) < float(r["metrics"][0]["loss"])
        for m, p in zip(r["metrics"], r["plain_metrics"]):
            assert torch.equal(m["lr"], p["lr"])
            assert abs(float(m["loss"]) - float(p["loss"])) <= LOSS_TOL
            assert abs(float(m["grad_norm"]) - float(p["grad_norm"])) <= \
                GRAD_L2 * float(p["grad_norm"])
        worst = adamw_agreement(r["start"], r["steps"], r["plain_steps"],
                                [float(m["lr"]) for m in r["metrics"]], opt)
        assert max(worst.values()) <= 1.0, worst
        assert worst["m"] > 0              # the products were split


def test_sharded_step_on_a_2x1_mesh(tmp_path):
    """make_sharded_train_step on a 2 x 1 ("data", "model") gloo mesh, where
    the tensor-parallel dispatch splits no product: loss, grad_norm, lr and
    every parameter and moment shard equal make_train_step(
    num_microbatches=2) on the whole batch, bit for bit."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import AdamWConfig, make_train_state
    from repro_torch.tree import tree_leaves
    cfg = ModelConfig(**TINY)
    state = make_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch().items()}
    outs = _ranks("sharded_step", 2, tmp_path, shape=(2, 1),
                  axes=("data", "model"), cfg=cfg,
                  opt=AdamWConfig(**STEP_OPT), state=state,
                  batches=[batch, batch])
    for r in outs:
        for m, p in zip(r["metrics"], r["plain_metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(m[k], p[k]), k
        for got, want in zip(tree_leaves(r["local"]),
                             tree_leaves(r["plain_local"])):
            assert torch.equal(got, want)


def test_placement_order_matches_reference(reference, tmp_path):
    """Two mesh axes on one tensor dim (("pod", "data")) and one axis per
    dim: each of the 4 ranks of a (2, 2) ("pod", "data") mesh holds the
    rows the reference's device at the same mesh position holds."""
    cases = [(spec, torch.arange(int(np.prod(shape))).reshape(shape))
             for spec, shape in ORDER_CASES]
    outs = _ranks("placement", 4, tmp_path, shape=(2, 2),
                  axes=("pod", "data"), cases=cases)
    for r in outs:
        pos = tuple(r["coordinate"])
        for (spec, full), local, want in zip(cases, r["local"],
                                             reference["order"]):
            block = full
            for d, (lo, hi) in enumerate(want[pos]):
                block = block[(slice(None),) * d + (slice(lo, hi),)]
            assert torch.equal(local, block), (spec, pos)


def test_restore_with_shardings_places_each_leaf(tmp_path):
    """restore_state(..., shardings=) on a 2 x 2 ("data", "model") gloo
    mesh: each leaf comes back as a DTensor at its placement, holding this
    rank's block of the saved array; a leaf without a sharding comes back
    whole; the manifest's extra as saved."""
    from repro_torch.checkpoint import save_state
    leaves = {"w": torch.arange(48, dtype=torch.float32).reshape(8, 6),
              "layers/b": torch.arange(8, dtype=torch.int32),
              "step": torch.tensor(5, dtype=torch.int32)}
    d = str(tmp_path / "ckpt")
    save_state(d, 3, leaves, extra={"note": "sharded"})
    template = {k: v.to("meta") for k, v in leaves.items()}
    specs = {"w": ("data", "model"), "layers/b": (("data", "model"),)}
    outs = _ranks("restore", 4, tmp_path, shape=(2, 2),
                  axes=("data", "model"), ckpt_dir=d, template=template,
                  specs=specs)
    for r in outs:
        i, j = r["coordinate"]
        assert r["extra"] == {"note": "sharded"}
        assert torch.equal(r["local"]["w"],
                           leaves["w"][4 * i:4 * i + 4, 3 * j:3 * j + 3])
        k = 2 * i + j                  # ("data", "model") major to minor
        assert torch.equal(r["local"]["layers/b"],
                           leaves["layers/b"][2 * k:2 * k + 2])
        assert torch.equal(r["local"]["step"], leaves["step"])
        assert r["placements"]["w"] == [("Shard", 0), ("Shard", 1)]
        assert r["placements"]["layers/b"] == [("Shard", 0), ("Shard", 0)]
        assert "step" not in r["placements"]
