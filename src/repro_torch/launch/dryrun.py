"""Per-rank dry-run of every (arch x shape x mesh) cell (port of
repro.launch.dryrun).

For each arch (the reference's ten: every config but paper-llama2-7b) x
applicable shape (``configs.shapes``) x logical mesh (16 x 16 = 256 ranks,
2 x 16 x 16 = 512), the cell's trees are built on PyTorch's "meta" device
(shapes and dtypes, no memory) and placed by the mesh's shardings:

  * train_4k: the train state (f32 master parameters, AdamW's m and v, the
    step; ``REPRO_MOE_GROUP`` overrides ``moe_group_size``) and the batch;
  * prefill_32k: the packed serve parameters (``init_packed_params`` in
    ``cfg.quant_format``; ``REPRO_KV_QUANT`` sets ``kv_quant``) and the
    inputs;
  * decode_32k / long_500k: the packed parameters, the per-slot decode
    caches of seq positions and one token per row; with a packed KV cache
    the cell also encodes one K row on meta tensors, the first write a
    decode step makes (zamba2-7b's head_dim of 112 is no multiple of the
    32-element group, so its m2xfp pages raise there, as the reference's
    lowering does).

long_500k shards its cache over both axes (``kv_seq -> ('data',
'model')``), and ``REPRO_RULES_JSON`` overrides rules, as the reference's
run_cell does. The report is, per rank:

  * bytes of parameters, optimizer state, caches and inputs, each from its
    leaves' specs and shapes (no process group);
  * ``step_cost``: the cell's step run on meta tensors at this rank's
    shards over a fake group of the mesh's size
    (``repro_torch.analysis.step_cost``; the command line counts all its
    cells in one child process, one after another): FLOPs, HBM
    bytes (the least traffic, which the roofline reads, and the unfused
    ops' sum, an upper bound) and collective wire bytes per kind -- the train step with AdamW over the reference's
    microbatch counts (``TRAIN_MICROBATCHES``), the prefill forward, the
    decode step against full caches;
  * ``roofline``: its three-term bound on H100s
    (``repro_torch.analysis.roofline``), the dominant term and the share
    of the bound that the model's FLOPs would take.

A cell that raises is a data point. The port has no XLA, so the
reference's compile time, XLA temp bytes, CPU f32 mirror bytes and loop
trips are not reported (``NOT_REPORTED``, each with its reason).

Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis import step_cost
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import (SHAPES, applicable_shapes,
                                        cache_specs, input_specs)
from repro_torch.core import envflags
from repro_torch.core.codecs import get_codec
from repro_torch.distributed.sharding import (NamedSharding,
                                              cache_shardings,
                                              logical_to_spec,
                                              param_shardings, shard_nbytes,
                                              use_sharding)
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
# the reference's dry-run leaves its paper config out (its ARCHS[:-1])
DRYRUN_ARCHS = tuple(a for a in ARCHS if a != "paper-llama2-7b")
NOT_REPORTED = step_cost.NOT_REPORTED
PARTS = ("params", "opt_state", "caches", "inputs")
# gradient-accumulation microbatches per arch for train_4k (the
# reference's, which bound its live activations on 16 GB chips)
TRAIN_MICROBATCHES = {"qwen2-0.5b": 1, "xlstm-125m": 1,
                      "mixtral-8x22b": 8, "zamba2-7b": 8}
DEFAULT_MICROBATCHES = 4
# a cell's step count is cut after this many seconds (a data point)
COST_TIMEOUT_S = 1800.0


def cell_rules(shape_name: str) -> Optional[dict]:
    """The rule overrides of a cell: long_500k's context parallelism over
    both axes, then ``REPRO_RULES_JSON`` (a JSON object; lists become
    tuples), as the reference's run_cell builds them."""
    rules = None
    if shape_name == "long_500k":
        rules = {"kv_seq": ("data", "model")}
    env_rules = envflags.get_str("REPRO_RULES_JSON")
    if env_rules:
        overrides = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in json.loads(env_rules).items()}
        rules = {**(rules or {}), **overrides}
    return rules


def cell_config(arch: str, shape_name: str, quant_train: str = "none"):
    """The cell's config: train cells under ``quant_train`` (and
    ``REPRO_MOE_GROUP``), serve cells packed in ``quant_format`` with
    ``REPRO_KV_QUANT``'s KV cache."""
    base = get_config(arch)
    if SHAPES[shape_name]["kind"] == "train":
        cfg = dataclasses.replace(base, quant=quant_train)
        moe_group = envflags.get_int("REPRO_MOE_GROUP")
        if moe_group is not None:
            cfg = dataclasses.replace(cfg, moe_group_size=moe_group)
        return cfg
    return dataclasses.replace(base, quant="serve",
                               kv_quant=envflags.get_str("REPRO_KV_QUANT"))


def build_trees(cfg, shape_name: str, memo: Optional[dict] = None) -> dict:
    """{part: tree of meta tensors} of a cell (``PARTS``; a part the cell
    lacks is None). ``memo`` keeps the parameter trees by config, so that
    an arch's are built once for all its shapes."""
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.train.trainer import make_train_state
    kind = SHAPES[shape_name]["kind"]
    trees = dict.fromkeys(PARTS)
    trees["inputs"] = input_specs(cfg, shape_name)
    if kind == "decode" and cfg.kv_quant != "none":
        get_codec(cfg.kv_quant)     # the registry's error for a name it
                                    # does not know, as the reference's
    memo = {} if memo is None else memo
    key = (cfg, kind == "train")
    if key not in memo:
        memo[key] = (make_train_state(torch.Generator(), cfg, device="meta")
                     if kind == "train" else
                     init_packed_params(torch.Generator(), cfg, "meta"))
    if kind == "train":
        trees["params"] = memo[key]["params"]
        trees["opt_state"] = memo[key]["opt"]
        return trees
    trees["params"] = memo[key]
    if kind == "decode":
        trees["caches"] = cache_specs(cfg, shape_name)
        if cfg.kv_quant != "none" and cfg.family != "ssm":
            from repro_torch.models.kvquant import kv_encode
            kv_encode(torch.empty((SHAPES[shape_name]["batch"], 1,
                                   cfg.n_kv_heads, cfg.hd),
                                  dtype=torch.bfloat16, device="meta"),
                      cfg.kv_quant)
    return trees


def data_shardings(inputs: dict, mesh, rules=None) -> dict:
    """Each input's sharding: axis 0 over the batch axes, when they divide
    it."""
    with use_sharding(mesh, rules):
        return {k: NamedSharding(mesh, logical_to_spec(
            ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))
            for k, v in inputs.items()}


def tree_shardings(trees: dict, mesh, rules=None) -> dict:
    """{part: sharding tree} of ``build_trees``' parts."""
    from repro_torch.train.trainer import train_state_shardings
    out = dict.fromkeys(PARTS)
    if trees["opt_state"] is not None:
        sh = train_state_shardings({"params": trees["params"],
                                    "opt": trees["opt_state"]}, mesh, rules)
        out["params"], out["opt_state"] = sh["params"], sh["opt"]
    else:
        out["params"] = param_shardings(trees["params"], mesh, rules)
    if trees["caches"] is not None:
        out["caches"] = cache_shardings(trees["caches"], mesh, rules)
    out["inputs"] = data_shardings(trees["inputs"], mesh, rules)
    return out


def bytes_per_rank(trees: dict, mesh, rules=None) -> dict:
    """{part: bytes of one rank's shards, "total": their sum}."""
    sh = tree_shardings(trees, mesh, rules)
    out = {p: (shard_nbytes(trees[p], sh[p]) if trees[p] is not None else 0)
           for p in PARTS}
    out["total"] = sum(out.values())
    return out


def cost_spec(arch: str, shape_name: str, cfg, mesh, rules=None) -> dict:
    """The cell's ``step_cost.cost_spec`` on ``mesh`` (a ``LogicalMesh``):
    its step with the reference's microbatch count for train cells."""
    shape = SHAPES[shape_name]
    mb = TRAIN_MICROBATCHES.get(arch, DEFAULT_MICROBATCHES) \
        if shape["kind"] == "train" else 1
    return step_cost.cost_spec(cfg, shape["kind"], shape["batch"],
                               shape["seq"], mesh.axis_sizes,
                               mesh.axis_names, rules, mb)


def cell_cost(spec: dict, counted: dict, chips: int) -> dict:
    """{"step_cost": one rank's counted step, "roofline": its terms on
    ``chips`` H100s} of a cell from its ``cost_spec`` and counts."""
    from repro_torch.analysis.roofline import model_flops, roofline
    shape = {"kind": spec["kind"], "batch": spec["batch"],
             "seq": spec["seq"]}
    rt = roofline(counted["flops_per_device"],
                  counted["hbm_bytes_per_device"],
                  counted["collective_bytes_per_device"], chips,
                  model_flops(spec["cfg"], shape))
    return {"step_cost": dict(counted,
                              num_microbatches=spec["num_microbatches"]),
            "roofline": rt.as_dict()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant_train: str = "none", save: bool = True,
             trees: Optional[dict] = None, mesh=None,
             results_dir: Optional[str] = None, counted=None) -> dict:
    """One cell on the logical production mesh (or ``mesh``); ``trees``
    may carry the cell's ``build_trees`` from an earlier mesh.
    ``counted`` is the cell's ``step_cost.step_costs`` entry when it was
    counted beside other cells (else the cell is counted here). The JSON
    goes under ``results_dir`` (default ``RESULTS_DIR``)."""
    mesh_name = "pod512" if multi_pod else "pod256"
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "ranks": mesh.size, "ok": False,
              "not_reported": NOT_REPORTED}
    t0 = time.perf_counter()
    try:
        rules = cell_rules(shape_name)
        cfg = cell_config(arch, shape_name, quant_train)
        if trees is None:
            trees = build_trees(cfg, shape_name)
        result["bytes_per_rank"] = bytes_per_rank(trees, mesh, rules)
        spec = cost_spec(arch, shape_name, cfg, mesh, rules)
        if counted is None:
            counted, = step_cost.step_costs([spec], COST_TIMEOUT_S)
        if isinstance(counted, Exception):
            raise counted
        result.update(cell_cost(spec, counted, mesh.size))
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 -- a cell failure is a data point
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["seconds"] = time.perf_counter() - t0
    if save:
        d = os.path.join(results_dir or RESULTS_DIR, mesh_name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch.replace('.', '_')}__"
                                  f"{shape_name}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _count_cells(cells, quant_train: str) -> dict:
    """{(arch, shape, multi_pod): its step_costs entry} of ``cells``,
    counted in one child process (a cell whose config raises is left to
    run_cell, which records the error)."""
    specs = {}
    for arch, sh, mp in cells:
        try:
            cfg = cell_config(arch, sh, quant_train)
        except Exception:  # noqa: BLE001 -- run_cell records it
            continue
        specs[(arch, sh, mp)] = cost_spec(
            arch, sh, cfg, make_production_mesh(multi_pod=mp),
            cell_rules(sh))
    out = step_cost.step_costs(list(specs.values()),
                               COST_TIMEOUT_S * max(len(specs), 1))
    return dict(zip(specs, out))


def main():
    ap = argparse.ArgumentParser(
        description="Per-rank bytes (parameters, optimizer state, caches, "
        "inputs), step cost (FLOPs, HBM bytes, collective bytes) and H100 "
        "roofline of every arch x shape cell on the logical 256- and "
        "512-rank meshes, counted on the meta device (all cells' steps in "
        "one child process). Not reported (the port has no XLA): "
        + "; ".join(f"{k} ({v})" for k, v in NOT_REPORTED.items()) + ".")
    ap.add_argument("--arch", choices=list(ARCHS), nargs="+", default=None,
                    help="one arch or more")
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant-train", default="none",
                    choices=["none", "qat"])
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where the JSONs go (<dir>/<mesh>/<arch>__<shape>"
                    ".json)")
    args = ap.parse_args()
    if not args.all and args.arch is None:
        ap.error("--arch or --all required")
    archs = DRYRUN_ARCHS if args.all else tuple(args.arch)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(arch, sh, mp) for arch in archs
             for sh in (applicable_shapes(get_config(arch))
                        if args.shape is None else [args.shape])
             for mp in meshes]
    counted = _count_cells(cells, args.quant_train)
    memo: dict = {}
    for arch, sh, mp in cells:
        try:
            trees = build_trees(cell_config(arch, sh, args.quant_train),
                                sh, memo)
        except Exception:  # noqa: BLE001 -- run_cell records it
            trees = None
        r = run_cell(arch, sh, mp, args.quant_train, trees=trees,
                     results_dir=args.results_dir,
                     counted=counted.get((arch, sh, mp)))
        if r["ok"]:
            b = r["bytes_per_rank"]
            rt = r["roofline"]
            extra = (f"dom={rt['dominant']:10s} "
                     f"frac={rt['roofline_fraction']:.3f} "
                     + " ".join(f"{p}={b[p] / 2 ** 30:.3f}GiB"
                                for p in (*PARTS, "total"))
                     + f" count={r['step_cost']['seconds']:.1f}s")
        else:
            extra = r["error"][:160]
        print(f"[{'OK ' if r['ok'] else 'FAIL'}] {r['mesh']} "
              f"{arch:16s} {sh:12s} {extra}", flush=True)


if __name__ == "__main__":
    main()
