"""The dry-run's step cost and roofline (ROADMAP A14):
``repro_torch.analysis.step_cost`` and ``analysis/roofline.py`` against the
reference's ``repro.analysis.hlo`` and ``repro.analysis.roofline``.

One child (the reference, 2 host devices) lowers and compiles CELLS --
paper-llama2-7b's smoke config, its decode step and prefill packed in
m2xfp and its train step with AdamW -- on one device and on the (1, 2)
("data", "model") mesh (the reference dry-run's shardings) and keeps
``analyze_hlo``'s FLOPs. The port counts the same cells on meta tensors
(``step_costs``: one child on a fake group), beside the reference and
beside the dry-run's command line on one arch of each family.

Forward cells: equal FLOPs. Train cells: the port's step does two kinds
of products more, exactly (``train_extra``): the embedding's gradient, which
the port takes as a one-hot product (``_EmbedLookup``: 2·B·S·V·d, V over
"model") where the reference scatter-adds, and under remat the recompute
of each block's last product (the MLP's ``down``, 2·B·S·d_ff·d per layer,
d_ff over "model"), whose output no gradient needs: XLA drops it as dead
code, ``torch.utils.checkpoint`` recomputes the whole block.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_serve import run_reference_child

DEVICES = 2
ARCH = "paper-llama2-7b"
# kind -> (batch, seq)
CELLS = {"decode": (2, 32), "prefill": (2, 32), "train": (4, 16)}
MESH_SHAPES = {"1": None, "1x2": (1, 2)}
# one cell per family for the command line, on both production meshes,
# and qwen2-0.5b, whose wo and down K-shards split 32-groups on the
# 16-wide "model" axis (ROADMAP C3)
CLI_CELLS = {"dense": "qwen3-8b", "moe": "olmoe-1b-7b",
             "audio": "musicgen-large", "vlm": "pixtral-12b",
             "ssm": "xlstm-125m", "hybrid": "zamba2-7b",
             "dense-c3": "qwen2-0.5b"}
CLI_SHAPE = "decode_32k"
# qwen2-0.5b's prefill cell is counted by a second run of the command
# line's entry in the same child, with the attention in one q tile and one
# KV chunk (CLI_FLAGS): the same FLOPs, least traffic and collective bytes
# as the default tiling (the unfused ops' sum differs), about 3.5 s a mesh
# where 32 x 64 tiles take about 130 s on meta
CLI_EXTRA = ("qwen2-0.5b", "prefill_32k")
CLI_FLAGS = {"REPRO_ATTN_KV_CHUNK": "32768", "REPRO_ATTN_Q_TILE": "32768"}
# the two runs count their 16 cells one after another: about 80 s alone
# on one core (65 s before the qwen2-0.5b cells)
CLI_TIMEOUT_S = 400


def cell_config(pkg: str, kind: str):
    import importlib
    configs = importlib.import_module(f"{pkg}.configs")
    if kind == "train":
        return configs.smoke_config(ARCH, quant="none")
    return configs.smoke_config(ARCH, quant="serve", quant_format="m2xfp")


# ---------------------------------------------------------------------------
# The reference, run in a child process
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    import contextlib
    import pickle
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.analysis.hlo import analyze_hlo
    from repro.distributed.sharding import (cache_shardings,
                                            logical_to_spec,
                                            param_shardings, use_sharding)
    from repro.launch.mesh import make_test_mesh
    from repro.models.model import (decode_step, forward, init_caches,
                                    init_params, pack_params_for_serving)
    from repro.train.optimizer import AdamWConfig
    from repro.train.trainer import (make_train_state, make_train_step,
                                     train_state_shardings)
    key = jax.random.key(0)

    def data(specs, mesh):
        with use_sharding(mesh):
            return {k: NamedSharding(mesh, logical_to_spec(
                ("batch",) + (None,) * (len(v.shape) - 1), v.shape))
                for k, v in specs.items()}

    def lowered(kind, mesh):
        cfg = cell_config("repro", kind)
        b, s = CELLS[kind]
        ctx = use_sharding(mesh) if mesh else contextlib.nullcontext()
        if kind == "train":
            st = jax.eval_shape(lambda: make_train_state(key, cfg))
            batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
                     for k in ("tokens", "labels")}
            with ctx:
                step = make_train_step(cfg, AdamWConfig())
                sh = dict(in_shardings=(train_state_shardings(st, mesh),
                                        data(batch, mesh))) if mesh else {}
                return jax.jit(step, **sh).lower(st, batch)
        p = jax.eval_shape(lambda: pack_params_for_serving(
            init_params(key, cfg), cfg))
        if kind == "prefill":
            batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
            with ctx:
                sh = dict(in_shardings=(param_shardings(p, mesh),
                                        data(batch, mesh))) if mesh else {}
                return jax.jit(lambda p, x: forward(p, cfg, x), **sh).lower(
                    p, batch)
        c = jax.eval_shape(lambda: init_caches(cfg, b, s, per_slot=True))
        batch = {"tokens": jax.ShapeDtypeStruct((b, 1), jnp.int32)}
        i = jax.ShapeDtypeStruct((b,), jnp.int32)
        with ctx:
            sh = dict(in_shardings=(
                param_shardings(p, mesh), data(batch, mesh),
                cache_shardings(c, mesh),
                NamedSharding(mesh, PartitionSpec()))) if mesh else {}
            return jax.jit(lambda p, x, c, i: decode_step(p, cfg, x, c, i),
                           **sh).lower(p, batch, c, i)

    out = {}
    for kind in CELLS:
        for name, shape in MESH_SHAPES.items():
            mesh = make_test_mesh(shape, ("data", "model")) if shape \
                else None
            text = lowered(kind, mesh).compile().as_text()
            out[(kind, name)] = analyze_hlo(text).flops
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES}").strip()
    _reference_main(sys.argv[1])


def run_cli(results_dir) -> str:
    """The dry-run command line's output for CLI_CELLS' archs on
    CLI_SHAPE and for CLI_EXTRA, both meshes, its JSONs under
    ``results_dir``: ``dryrun.main`` run once for each argument list, in
    one child."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    common = ["--mesh", "both", "--results-dir", str(results_dir)]
    argvs = [["--arch", *CLI_CELLS.values(), "--shape", CLI_SHAPE, *common],
             ["--arch", CLI_EXTRA[0], "--shape", CLI_EXTRA[1], *common]]
    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            f"for argv in {argvs!r}:\n"
            "    sys.argv = ['dryrun', *argv]\n    dryrun.main()\n")
    return subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=src, **CLI_FLAGS), check=True,
        timeout=CLI_TIMEOUT_S, capture_output=True, text=True).stdout


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """(the reference child's FLOPs, ``step_costs`` of each cell on meta
    tensors per mesh -- "1": 1 x 1 -- in one child, (the dry-run command
    line's output, its results directory), ``run_plain``'s counts): the
    four run side by side."""
    from repro_torch.analysis.step_cost import cost_spec, step_costs
    keys = [(kind, name) for kind in CELLS for name in MESH_SHAPES]
    specs = [cost_spec(cell_config("repro_torch", kind), kind,
                       *CELLS[kind], MESH_SHAPES[name] or (1, 1))
             for kind, name in keys]
    results = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(4) as pool:
        ref = pool.submit(run_reference_child, __file__, tmp_path_factory)
        port = pool.submit(step_costs, specs)
        cli = pool.submit(run_cli, results)
        plain = pool.submit(run_plain, tmp_path_factory)
        return (ref.result(), dict(zip(keys, port.result())),
                (cli.result(), results), plain.result())


@pytest.fixture(scope="module")
def reference(counts):
    return counts[0]


@pytest.fixture(scope="module")
def port_counts(counts):
    return counts[1]


# ---------------------------------------------------------------------------
# Ring formulas and the collective log
# ---------------------------------------------------------------------------

RING_CASES = [("all_reduce", 4096, 2), ("all_reduce", 4096, 16),
              ("all_gather", 1024, 2), ("all_gather", 1024, 16),
              ("reduce_scatter", 8192, 4), ("all_to_all", 2048, 16),
              ("broadcast", 512, 4), ("all_reduce", 4096, 1)]


@pytest.mark.parametrize("op,nbytes,g", RING_CASES)
def test_ring_formulas_are_the_reference(op, nbytes, g):
    """A hand-made collective record costs what hlo.py's ring estimate
    gives for its output (an all-gather's output is G times the bytes
    handed to it, a reduce-scatter's 1/G), under the reference's kind."""
    from repro.analysis.hlo import _collective_wire_bytes
    from repro_torch.analysis.step_cost import KINDS, collective_cost
    out = {"all_gather": nbytes * g,
           "reduce_scatter": nbytes / g}.get(op, nbytes)
    got = collective_cost([{"op": op, "nbytes": nbytes, "group_size": g}])
    kind = KINDS[op]
    want = _collective_wire_bytes(kind, out, g)
    if op == "broadcast" and g == 1:
        want = 0.0                 # nothing leaves a group of one
    assert got["per_kind_bytes"] == {kind: want}
    assert got["per_kind_count"] == {kind: 1}
    assert got["collective_bytes_per_device"] == want


_LOG_CHILD = """
import pickle, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.analysis.step_cost import CollectiveLog, collective_cost
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
g = mesh.get_group("model")
t = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
with CollectiveLog() as log:
    dist.all_reduce(t, group=g)
    dist.all_gather_into_tensor(torch.empty((16, 16), dtype=t.dtype,
                                            device="meta"), t, group=g)
    d = distribute_tensor(t, mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    d.redistribute(mesh, [Replicate(), Replicate()])
    d.redistribute(mesh, [Replicate(), Shard(0)])
dist.destroy_process_group()
with open(sys.argv[1], "wb") as f:
    pickle.dump((log.records, collective_cost(log.records)), f)
"""


def test_collective_log_counts_hand_made_collectives(tmp_path):
    """On a fake 2 x 2 "cuda" mesh: an eager all_reduce and
    all_gather_into_tensor of a (8, 16) bf16 tensor over "model", and
    DTensor's all-gather (Shard(1) -> Replicate) and all-to-all
    (Shard(1) -> Shard(0)) of its (8, 8) shard, each logged once with its
    group size and the bytes handed to it, and costed by the ring
    formulas."""
    import pickle
    out = tmp_path / "log.pkl"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    subprocess.run([sys.executable, "-c", _LOG_CHILD, str(out)], check=True,
                   timeout=120, env=dict(os.environ, PYTHONPATH=src),
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(out, "rb") as f:
        records, cost = pickle.load(f)
    got = [(r["op"], r["dtype"], r["shape"], r["group_size"], r["nbytes"])
           for r in records]
    assert got == [("all_reduce", "bfloat16", (8, 16), 2, 256),
                   ("all_gather", "bfloat16", (8, 16), 2, 256),
                   ("all_gather", "bfloat16", (8, 8), 2, 128),
                   ("all_to_all", "bfloat16", (8, 8), 2, 128)]
    assert cost["per_kind_count"] == {"all-reduce": 1, "all-gather": 2,
                                      "all-to-all": 1}
    assert cost["per_kind_bytes"] == {"all-reduce": 256.0,
                                      "all-gather": 256.0 + 128.0,
                                      "all-to-all": 64.0}


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
def test_forward_flops_equal_reference_hlo(reference, port_counts, kind,
                                           mesh):
    """The decode step's and the prefill's FLOPs per rank equal
    ``analyze_hlo``'s of the reference's compiled cell, on one device and
    on the (1, 2) mesh (every projection, the attention products and the
    head, 2·M·K·N each)."""
    got = port_counts[(kind, mesh)]
    assert got["flops_per_device"] == reference[(kind, mesh)]
    assert got["flops_per_device"] > got["product_flops"] > 0


def train_extra(cfg, b: int, s: int, t: int) -> int:
    """The train step's products beyond the reference's (module
    docstring): the one-hot embedding gradient and, under remat, each
    layer's recomputed ``down``, on this rank's shards."""
    tokens = b * s
    extra = 2 * tokens * (cfg.vocab_size // t) * cfg.d_model
    if cfg.remat:
        extra += cfg.n_layers * 2 * tokens * (cfg.d_ff // t) * cfg.d_model
    return extra


@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
def test_train_flops_are_reference_plus_explained_products(
        reference, port_counts, mesh):
    """The train step's FLOPs per rank are the reference's plus exactly
    ``train_extra`` (module docstring), which is under 12% of them here."""
    cfg = cell_config("repro_torch", "train")
    t = (MESH_SHAPES[mesh] or (1, 1))[1]
    got = port_counts[("train", mesh)]["flops_per_device"]
    want = reference[("train", mesh)]
    extra = train_extra(cfg, *CELLS["train"], t)
    assert got == want + extra
    assert extra < 0.12 * want


_PLAIN_CHILD = """
import pickle, sys, torch
from repro_torch.analysis import step_cost as sc
from repro_torch.configs import smoke_config
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
cells = pickle.loads(bytes.fromhex(sys.argv[2]))
cfg = smoke_config(sys.argv[1], quant="serve", quant_format="m2xfp")
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
out = {}
for kind, (b, s) in cells.items():
    for device in ("cpu", "meta"):
        with torch.no_grad():
            fn, reads = sc.cell_step(cfg, kind, b, s, mesh, device=device)
            out[kind, device] = sc.count(fn, device, reads)
            out[kind, device].pop("collectives")
dist.destroy_process_group()
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


def run_plain(tmp_path_factory) -> dict:
    """{(kind, device): _PLAIN_CHILD's counts} of the decode step and the
    prefill, on "cpu" and "meta" tensors (one child)."""
    import pickle
    out = tmp_path_factory.mktemp("plain") / "plain.pkl"
    cells = {kind: CELLS[kind] for kind in ("decode", "prefill")}
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    subprocess.run([sys.executable, "-c", _PLAIN_CHILD, ARCH,
                    pickle.dumps(cells).hex(), str(out)], check=True,
                   timeout=300, env=dict(os.environ, PYTHONPATH=src),
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def plain_counts(counts):
    return counts[3]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plain_path_counts_as_meta_and_on_gemm(plain_counts, kind):
    """On the (1, 2) mesh the step run through the plain versions on CPU
    tensors counts the FLOPs of the meta count (which stands for the
    kernels' path: nothing inside a packed product is seen), and its
    packed products' FLOPs are 2·M·K·N summed over ``tp.on_gemm``'s
    dispatches of the packed weights (every dispatch but the head's)."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(ARCH)
    plain = plain_counts[kind, "cpu"]
    meta = plain_counts[kind, "meta"]
    assert plain["flops_per_device"] == meta["flops_per_device"]
    assert plain["hbm_bytes_per_device"] == meta["hbm_bytes_per_device"]
    assert plain["product_flops"] == meta["product_flops"] > 0
    assert plain["products"] == meta["products"] == 7 * cfg.n_layers
    head = (cfg.d_model, cfg.vocab_size // 2)
    dispatched = sum(2 * int(np.prod(x[:-1])) * w[0] * w[1]
                     for kind_, x, w in plain["gemms"] if tuple(w) != head)
    assert dispatched == plain["product_flops"]


def _nbytes(tree) -> int:
    from repro_torch.analysis.step_cost import _local_tensors
    return sum(t.numel() * t.element_size()
               for t in _local_tensors(tree, {}).values())


@pytest.mark.parametrize("kind", list(CELLS))
def test_least_traffic_is_operands_read_and_results_written_once(
        port_counts, kind):
    """On one device ``hbm_bytes_per_device`` (the roofline's memory term)
    is the bytes of the parameters (and AdamW's state), caches and inputs
    read once and of the results written once: the decode step's and the
    prefill's f32 logits, the train step's new state (its scalar metrics
    on top); the unfused ops' sum is larger."""
    from repro_torch.configs.shapes import _tokens_spec
    from repro_torch.models.model import init_caches
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.train import make_train_state
    cfg = cell_config("repro_torch", kind)
    b, s = CELLS[kind]
    got = port_counts[(kind, "1")]
    gen = torch.Generator()
    if kind == "train":
        state = _nbytes(make_train_state(gen, cfg, device="meta"))
        want = 2 * state + 2 * b * s * 4            # tokens and labels
        assert want < got["hbm_bytes_per_device"] <= want + 64
    else:
        params = _nbytes(init_packed_params(gen, cfg, "meta"))
        rows = s if kind == "prefill" else 1
        want = params + _nbytes(_tokens_spec(cfg, b, rows)) \
            + 4 * b * rows * cfg.vocab_size
        if kind == "decode":
            want += _nbytes(init_caches(cfg, b, s, "meta")) + 8 * b
        assert got["hbm_bytes_per_device"] == want
    assert got["hbm_bytes_upper_per_device"] > got["hbm_bytes_per_device"]


# ---------------------------------------------------------------------------
# Collective bytes: the fake group against a real gloo run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_fake_group_collectives_equal_gloo_run(tmp_path, shape):
    """The train step's collectives counted on a fake group of a CPU mesh
    (gloo's collectives) are the ``Recorder``'s of the same step run on
    gloo ranks: the same (op, dtype, shape, group size) in the same order,
    so the same bytes per kind."""
    from repro_torch.analysis.step_cost import collective_cost, step_cost
    from repro_torch.testing.distributed import run_ranks
    from repro_torch.train import make_train_state
    cfg = cell_config("repro_torch", "train")
    b, s = CELLS["train"]
    state = make_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
             .to(torch.int32) for k in ("tokens", "labels")}
    with ThreadPoolExecutor(1) as pool:
        fake = pool.submit(step_cost, cfg, "train", b, s, shape,
                           keep_collectives=True, mesh_device="cpu")
        ranks = run_ranks("step_collectives", int(np.prod(shape)),
                          str(tmp_path), 150, shape=shape,
                          axes=("data", "model"), cfg=cfg, state=state,
                          batch=batch)
        fake = fake.result()

    def key(records):
        return [(r["op"], r["dtype"], tuple(r["shape"]), r["group_size"])
                for r in records]
    gloo = ranks[0]                  # rank 0, as the fake group's rank
    assert key(fake["collectives"]) == key(gloo["collectives"])
    cost = collective_cost(gloo["collectives"])
    assert fake["per_kind_bytes"] == cost["per_kind_bytes"]
    assert fake["collective_bytes_per_device"] > 0


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

def test_roofline_is_the_reference_with_h100_constants(monkeypatch):
    """The port's constants are the H100 SXM's (989e12 dense bf16 FLOP/s,
    3.35e12 B/s HBM3, 50e9 B/s per GPU on the inter-node link) and no
    TPU figure; under them the reference's ``roofline`` and
    ``model_flops`` give the port's terms, dominant term and fractions."""
    import repro.analysis.roofline as ref
    from repro.configs import get_config as ref_config
    from repro_torch.analysis import roofline as port
    from repro_torch.configs import get_config
    assert (port.PEAK_FLOPS, port.HBM_BW, port.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref, name, getattr(port, name))
    cases = [(1.2e15, 3.4e11, 2.0e9, 256, "train_4k"),
             (3.0e12, 9.0e11, 4.0e9, 512, "decode_32k"),
             (5.0e14, 1.0e9, 8.0e11, 256, "prefill_32k")]
    from repro_torch.configs.shapes import SHAPES
    for arch in ("mixtral-8x22b", "xlstm-125m"):
        for flops, hbm, coll, chips, shape in cases:
            mf = port.model_flops(get_config(arch), SHAPES[shape])
            assert mf == ref.model_flops(ref_config(arch), SHAPES[shape])
            got = port.roofline(flops, hbm, coll, chips, mf).as_dict()
            want = ref.roofline(flops, hbm, coll, chips, mf).as_dict()
            assert got == want
    doms = {port.roofline(*c[:4], 1.0).dominant for c in cases}
    assert doms == {"compute", "memory", "collective"}


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_dryrun_cli_reports_cost_for_every_family(counts):
    """``python -m repro_torch.launch.dryrun --arch A B ... --shape
    decode_32k --mesh both`` for one arch of each family and qwen2-0.5b,
    then ``--arch qwen2-0.5b --shape prefill_32k`` (``run_cli``, started
    by the ``counts``
    fixture) finishes within CLI_TIMEOUT_S: every cell OK on pod256 and
    pod512 -- qwen2-0.5b's decode and prefill too, whose row products run
    on padded shards (ROADMAP C3) -- with positive FLOPs, HBM bytes (the
    least traffic below the unfused ops' sum) and collective bytes, a
    dominant term, and its line printing dom= and frac=."""
    text, tmp_path = counts[2]
    cells = [(arch, CLI_SHAPE) for arch in CLI_CELLS.values()] + [CLI_EXTRA]
    for arch, shape in cells:
        rows = [ln for ln in text.splitlines()
                if f" {arch} " in ln and f" {shape} " in ln]
        assert len(rows) == 2 and all(ln.startswith("[OK ]") for ln in rows)
        assert all("dom=" in ln and "frac=" in ln for ln in rows)
        for mesh in ("pod256", "pod512"):
            with open(tmp_path / mesh / f"{arch.replace('.', '_')}__"
                      f"{shape}.json") as f:
                r = json.load(f)
            c, rt = r["step_cost"], r["roofline"]
            assert r["ok"] and c["flops_per_device"] > 0
            assert c["hbm_bytes_upper_per_device"] > \
                c["hbm_bytes_per_device"] > 0
            assert c["collective_bytes_per_device"] > 0
            assert rt["dominant"] in ("compute", "memory", "collective")
            assert rt["chips"] == r["ranks"]
