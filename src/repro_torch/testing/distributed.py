"""Multi-rank runs of the port's distributed code on one host: the harness
behind tests/test_torch_distributed.py.

``run_ranks(scenario, world, workdir, timeout_s, **inputs)`` starts
``world`` processes (``python -m repro_torch.testing.distributed``), each
of which forms a process group (gloo on the CPU, a ``FileStore`` in
``workdir``), runs the named scenario with ``inputs`` (pickled to
``workdir``) and pickles what it returns. It waits at most ``timeout_s``
seconds: a rank still running then is killed with the others and the run
raises ``TimeoutError``; a rank that fails raises ``RuntimeError`` with
its traceback. A group that does not form raises; nothing falls back to a
single process.

Scenarios (each returns a picklable dict):
  * ``pipeline``: ``pipeline_apply`` on a ("pipe",) mesh of every rank,
    and the stages applied one after another to each microbatch;
  * ``compressed_psum``: on a mesh of ``shape`` / ``axes`` with a "pod"
    dim, each rank's pod reduces ``grads[pod]`` (optionally with the
    divisions by a constant taken as XLA's jit takes them: times the
    rounded reciprocal);
  * ``compressed_step``: one compressed train step on such a mesh;
  * ``sharded_step``: steps of ``make_sharded_train_step`` from a placed
    state, each rank's local shards after each step, and the plain step
    with ``num_microbatches`` equal to the batch ranks on the whole batch
    (its states also cut to the same placements);
  * ``placement``: each rank's shard of ``arange`` tensors at given specs;
  * ``restore``: ``restore_state`` of a checkpoint with ``shardings=``;
  * ``tp_train``: per case, the tensor-parallel loss, gradients and logits
    of this rank's batch slice beside the unsharded ones, one sharded
    train step beside the plain step, each rank's parameter bytes, and
    what ``Recorder`` saw (product dispatches, collectives);
  * ``tp_serve``: per case, an engine on placed parameters beside the
    unplaced engine (tokens, chunks of 1 against the configured chunk,
    every cache leaf's placement after each step, the collectives of one
    decode step), and the first case under ``REPRO_OBS=1`` both ways;
  * ``tp_levers``: ``decode_serving_weight`` of placed packed weights with
    and without ``REPRO_GATHER_PACKED``, and products and logits with and
    without ``REPRO_BF16_TP_REDUCE``, with what each moved;
  * ``tp_quarantine``: a guarded engine on placed parameters with a NaN
    planted in one rank's part of a head-sharded recurrent state;
  * ``step_collectives``: the collectives of one sharded train step.

``Recorder`` logs the collectives (``repro_torch.analysis.step_cost``'s
``CollectiveLog``: op, dtype, shape, group, and whether a weight or an
activation moved) and the tensor-parallel product dispatches of what runs
inside it; ``summarize`` turns one into picklable lists (each
collective's group named by its mesh dim). The tests and chip_smoke read
what a step moved from it.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import time
import traceback

import torch

__all__ = ["run_ranks", "Recorder", "summarize", "SCENARIOS"]


def run_ranks(scenario: str, world: int, workdir: str, timeout_s: float,
              **inputs) -> list:
    """Run ``scenario`` on ``world`` gloo ranks; returns each rank's
    result (a list indexed by rank)."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.testing.distributed", scenario,
         str(rank), str(world), workdir], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{scenario} on {world} ranks did not finish in "
                           f"{timeout_s} s; its ranks were killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = {rank: p.stderr.read().decode(errors="replace")[-3000:]
              for rank, p in enumerate(procs) if p.returncode != 0}
    for p in procs:
        p.stderr.close()
    if errors:
        raise RuntimeError(f"{scenario}: ranks {sorted(errors)} failed:\n"
                           + "\n".join(errors.values()))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# Scenarios (run inside a rank)
# ---------------------------------------------------------------------------

def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(tuple(shape), tuple(axes), "cpu")


def _pipeline(rank, world, ws, x):
    from repro_torch.distributed.pipeline import pipeline_apply

    def stage(w, h):
        return torch.tanh(h @ w)
    mesh = _mesh((world,), ("pipe",))
    out = pipeline_apply(stage, ws, x, mesh, world)
    seq = []
    for m in range(x.shape[0]):
        h = x[m]
        for i in range(world):
            h = stage(ws[i], h)
        seq.append(h)
    return {"out": out, "sequential": torch.stack(seq)}


def _reciprocal_divisions():
    """Make the compression's divisions by a constant products with the
    rounded reciprocal, as XLA's jit does (ROADMAP C)."""
    from repro_torch.train import compression
    compression.div_const = lambda x, c: x * (1.0 / c)


def _compressed_psum(rank, world, shape, axes, grads, cfg,
                     reciprocal=False):
    """This rank's pod, its reduced gradients and error feedback."""
    from repro_torch.train.compression import compressed_psum
    if reciprocal:
        _reciprocal_divisions()
    mesh = _mesh(shape, axes)
    pod = mesh.get_local_rank("pod")
    g = grads[pod]
    err = {k: torch.zeros_like(v) for k, v in g.items()}
    red, new_err = compressed_psum(g, err, cfg, mesh.get_group("pod"),
                                   mesh.size(mesh.mesh_dim_names.index(
                                       "pod")))
    return {"pod": pod, "reduced": red, "err": new_err}


def _compressed_step(rank, world, shape, axes, cfg, opt, compression,
                     state, batch):
    from repro_torch.train import make_train_step
    mesh = _mesh(shape, axes)
    step = make_train_step(cfg, opt, compression, mesh=mesh)
    new_state, metrics = step(state, batch)
    return {"metrics": metrics, "state": new_state}


def _sharded_step(rank, world, shape, axes, cfg, opt, state, batches):
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.train import (make_sharded_train_step, make_train_step,
                                   train_state_shardings)
    mesh = _mesh(shape, axes)

    def cut(st):
        return local_tree(place_tree(st, train_state_shardings(st, mesh)))
    placed = place_tree(state, train_state_shardings(state, mesh))
    step = make_sharded_train_step(cfg, opt, mesh)
    metrics, steps = [], []
    for b in batches:
        placed, m = step(placed, b)
        metrics.append(m)
        steps.append(local_tree(placed))
    n_batch = mesh.size(mesh.mesh_dim_names.index("data"))
    plain = make_train_step(cfg, opt, num_microbatches=n_batch)
    ref, ref_metrics, ref_steps = state, [], []
    for b in batches:
        ref, m = plain(ref, b)
        ref_metrics.append(m)
        ref_steps.append(cut(ref))
    return {"metrics": metrics, "local": steps[-1], "steps": steps,
            "plain_metrics": ref_metrics, "plain": ref,
            "plain_local": ref_steps[-1], "plain_steps": ref_steps,
            "start": cut(state), "coordinate": mesh.get_coordinate()}


def _placement(rank, world, shape, axes, cases):
    from repro_torch.distributed.sharding import NamedSharding
    mesh = _mesh(shape, axes)
    out = []
    for spec, full in cases:
        out.append(NamedSharding(mesh, spec).place(full).to_local())
    return {"coordinate": mesh.get_coordinate(), "local": out}


def _restore(rank, world, shape, axes, ckpt_dir, template, specs):
    from repro_torch.checkpoint import restore_state
    from repro_torch.distributed.sharding import NamedSharding
    mesh = _mesh(shape, axes)
    shardings = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    got, extra = restore_state(ckpt_dir, template, shardings=shardings)
    from repro_torch.distributed.sharding import local_tree
    return {"coordinate": mesh.get_coordinate(), "extra": extra,
            "local": local_tree(got),
            "placements": {k: [(type(p).__name__, getattr(p, "dim", None))
                               for p in v.placements]
                           for k, v in got.items() if k in shardings}}


# ---------------------------------------------------------------------------
# Recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Recorder:
    """Collectives and product dispatches while active (a context
    manager). ``collectives``: the records of
    ``repro_torch.analysis.step_cost.CollectiveLog`` (``op``, ``dtype``,
    ``shape``, ``group``, ``group_size``, ``nbytes``), each with
    ``moving`` ("weight" inside ``tp.gather_weight``, which it wraps, else
    "activation"); ``gemms``: dicts of ``kind``, ``x`` and ``w`` (the
    local shapes, from ``tp.on_gemm``). All hooks are put back on exit."""

    collectives: list = dataclasses.field(default_factory=list)
    gemms: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        from repro_torch.analysis.step_cost import CollectiveLog
        from repro_torch.distributed import tp
        rec = self
        self._moving = "activation"
        self._log = CollectiveLog(lambda: {"moving": rec._moving})
        self._log.records = self.collectives
        self._prev_gemm = tp.on_gemm

        def on_gemm(kind, x, w):
            rec.gemms.append({"kind": kind, "x": x, "w": w})
            if rec._prev_gemm is not None:
                rec._prev_gemm(kind, x, w)
        tp.on_gemm = on_gemm
        self._prev_gather = tp.gather_weight

        @functools.wraps(self._prev_gather)
        def gather_weight(t):
            prev, rec._moving = rec._moving, "weight"
            try:
                return rec._prev_gather(t)
            finally:
                rec._moving = prev
        tp.gather_weight = gather_weight
        self._log.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import tp
        self._log.__exit__(*exc)
        tp.on_gemm = self._prev_gemm
        tp.gather_weight = self._prev_gather
        return False


def summarize(rec, mesh) -> dict:
    """A ``Recorder``'s product dispatches and collectives, each
    collective's group named by the mesh dim whose group it is (or
    "world")."""
    names = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    for a in mesh.mesh_dim_names:     # a dim of size 1 never communicates
        if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
            names[mesh.get_group(a).group_name] = a
    return {"gemms": list(rec.gemms),
            "collectives": [dict(c, group=names.get(c["group"], "world"))
                            for c in rec.collectives]}


def _nbytes(tree) -> int:
    from repro_torch.distributed.sharding import local_tree, map_with_path
    out = []
    map_with_path(lambda _, t: out.append(t.numel() * t.element_size()),
                  local_tree(tree))
    return sum(out)


def _tp_train(rank, world, shape, axes, cases):
    """Per case (name, cfg, opt, state, batch): the tensor-parallel loss,
    gradients (gathered whole along "model" from their shards) and logits
    of this rank's batch slice and the unsharded ones; one
    ``make_sharded_train_step`` beside ``make_train_step`` with
    ``num_microbatches`` the batch ranks; this rank's parameter bytes and
    ``shard_nbytes``; both steps' states at this rank's shards; what the
    recorder saw in the gradients' and the step's runs."""
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (local_tree, place_tree,
                                                  shard_nbytes,
                                                  use_sharding)
    from repro_torch.models.model import forward
    from repro_torch.train import (batch_sharding, cast_for_compute,
                                   make_sharded_train_step, make_train_step,
                                   tp_loss_and_grads, train_state_shardings)
    from repro_torch.train.trainer import _local_batch, _loss_and_grads
    from repro_torch.tree import tree_map
    mesh = _mesh(shape, axes)
    n_batch = mesh.size(mesh.mesh_dim_names.index("data"))
    out = {"coordinate": mesh.get_coordinate(), "cases": {}}
    for name, cfg, opt, state, batch in cases:
        sh = train_state_shardings(state, mesh)
        placed = place_tree(state, sh)
        local = _local_batch(batch, batch_sharding(mesh))
        with Recorder() as rec:
            loss, grads = tp_loss_and_grads(placed["params"], cfg, local,
                                            mesh)
        with use_sharding(mesh):            # whole, for the comparison
            grads = tree_map(lambda g, p: tp.wrap(
                g, tp.model_placement(p)).full_tensor(), grads,
                placed["params"])
        plain_loss, plain_grads = _loss_and_grads(state["params"], cfg,
                                                  local)
        with torch.no_grad():
            with use_sharding(mesh):
                logits = forward(cast_for_compute(placed["params"]), cfg,
                                 local)
            plain_logits = forward(cast_for_compute(state["params"]), cfg,
                                   local)
        with Recorder() as step_rec:
            new, metrics = make_sharded_train_step(cfg, opt, mesh)(placed,
                                                                   batch)
        plain_new, plain_metrics = make_train_step(
            cfg, opt, num_microbatches=n_batch)(state, batch)
        out["cases"][name] = {
            "loss": loss, "grads": grads, "logits": logits,
            "plain_loss": plain_loss, "plain_grads": plain_grads,
            "plain_logits": plain_logits, "metrics": metrics,
            "plain_metrics": plain_metrics,
            "param_bytes": _nbytes(new["params"]),
            "shard_nbytes": shard_nbytes(state["params"], sh["params"]),
            "start": local_tree(placed), "new": local_tree(new),
            "plain_new": local_tree(place_tree(plain_new, sh)),
            "grads_run": summarize(rec, mesh),
            "step_run": summarize(step_rec, mesh)}
    return out


def _placements_kept(caches, shardings) -> bool:
    """Every cache leaf a DTensor at its ``cache_shardings`` placement."""
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import map_with_path
    flat = []
    map_with_path(lambda p, t: flat.append(t), caches)
    want = []
    map_with_path(lambda p, s: want.append(s), shardings)
    return len(flat) == len(want) and all(
        tp.is_dtensor(t) and list(t.placements) == s.placements()
        for t, s in zip(flat, want))


def _tp_serve(rank, world, shape, axes, cases):
    """Per case (name, cfg, params, prompts, n_new, engine kwargs): the
    unplaced engine's tokens, the placed engine's (stepped one step at a
    time, every cache leaf's placement checked after each step) with the
    recorder's product dispatches and collectives, the placements of the
    first cache leaf of each name (``cache_k``: the first K leaf's, None
    without one), the placed engine's tokens with chunks of 1, and the
    collectives of one decode launch."""
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  map_with_path,
                                                  param_shardings,
                                                  place_tree, use_sharding)
    from repro_torch.serve.engine import ServeEngine
    mesh = _mesh(shape, axes)
    out = {"coordinate": mesh.get_coordinate(), "cases": {}}
    for name, cfg, params, prompts, n_new, kw in cases:
        want = ServeEngine(params, cfg, device="cpu", **kw).generate(
            prompts, n_new)
        placed = place_tree(params, param_shardings(params, mesh))
        with use_sharding(mesh):
            eng = ServeEngine(placed, cfg, device="cpu", **kw)
            one = ServeEngine(placed, cfg, device="cpu",
                              **dict(kw, prefill_chunk=1))
        shardings = cache_shardings(eng.caches, mesh)
        reqs = [eng.submit(p, n_new) for p in prompts]
        kept = []
        with Recorder() as rec:
            while eng.scheduler.has_work:
                eng.step()
                kept.append(_placements_kept(eng.caches, shardings))
        tokens_chunk1 = one.generate(prompts, n_new)
        # one decode launch: every slot decodes one token
        eng.submit(prompts[0], 2)
        eng.step()                             # admission: a prefill
        with Recorder() as dec:
            eng._launch_decode({})
        first = {}
        map_with_path(lambda path, t: first.setdefault(path[-1], [
            str(p) for p in t.placements]), eng.caches)
        out["cases"][name] = {
            "cache_k": first.get("k"), "cache_placements": first,
            "want": want, "tokens": [r.output for r in reqs],
            "tokens_chunk1": tokens_chunk1, "placements_kept": kept,
            "run": summarize(rec, mesh), "decode": summarize(dec, mesh),
            "steps": eng.stats.steps}
    # the first case again under REPRO_OBS=1, unplaced and placed: the
    # tokens and the metric names and label sets of the two runs
    name, cfg, params, prompts, n_new, kw = cases[0]
    _set_flag("REPRO_OBS", "1")
    try:
        from repro_torch import obs
        seen = {}
        for placed_run in (False, True):
            obs.reset()
            if placed_run:
                with use_sharding(mesh):
                    eng = ServeEngine(place_tree(
                        params, param_shardings(params, mesh)), cfg,
                        device="cpu", **kw)
            else:
                eng = ServeEngine(params, cfg, device="cpu", **kw)
            tokens = eng.generate(prompts, n_new)
            seen[placed_run] = (tokens, sorted({
                (r["name"], tuple(sorted(r["labels"].items())))
                for r in obs.registry().snapshot()}))
        obs.reset()
    finally:
        _set_flag("REPRO_OBS", None)
    out["obs"] = {"case": name, "unplaced": seen[False], "placed": seen[True]}
    return out


def _set_flag(name: str, value) -> None:
    """Set (a string) or unset (None) a flag in this rank's environment,
    where the port reads it through ``core/envflags.py``."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _tp_levers(rank, world, shape, axes, weights, cfg, params, tokens,
               row):
    """``decode_serving_weight`` of each placed packed weight of
    ``weights`` (one-leaf trees: the path gives the weight's specs) with
    ``REPRO_GATHER_PACKED`` unset and "1" (each rank's local result and
    the collectives of each); the forward logits of
    ``params`` on ``tokens`` with ``REPRO_BF16_TP_REDUCE`` unset and "1"
    (with the collectives); and the row-parallel product of ``row`` =
    (x f32, w) with the flag unset and "1" (this rank's full result)."""
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  param_shardings,
                                                  place_tree, use_sharding)
    from repro_torch.models.model import forward
    from repro_torch.models.quant import decode_serving_weight, \
        quantized_matmul
    mesh = _mesh(shape, axes)
    out = {"coordinate": mesh.get_coordinate(), "gather": {}, "bf16": {},
           "row": {}}

    def packed_leaf(tree):
        while isinstance(tree, dict):
            tree, = tree.values()
        return tree
    for key, w in weights.items():
        # each weight sits in a one-leaf tree whose path names its specs
        placed = packed_leaf(place_tree(w, param_shardings(w, mesh)))
        for value in (None, "1"):
            _set_flag("REPRO_GATHER_PACKED", value)
            with Recorder() as rec, use_sharding(mesh):
                got = decode_serving_weight(placed)
            out["gather"][(key, value)] = {
                "local": got.to_local(),
                "placements": [str(p) for p in got.placements],
                "run": summarize(rec, mesh)}
    _set_flag("REPRO_GATHER_PACKED", None)
    placed = place_tree(params, param_shardings(params, mesh))
    x, w = row
    w_placed = NamedSharding(mesh, ("model", None)).place(w)
    for value in (None, "1"):
        _set_flag("REPRO_BF16_TP_REDUCE", value)
        with torch.no_grad(), Recorder() as rec, use_sharding(mesh):
            logits = forward(placed, cfg, {"tokens": tokens})
            prod = tp.full(quantized_matmul(x, w_placed, "none"))
        out["bf16"][value] = {"logits": logits, "run": summarize(rec, mesh)}
        out["row"][value] = prod
    _set_flag("REPRO_BF16_TP_REDUCE", None)
    return out


def _tp_quarantine(rank, world, shape, axes, cases):
    """Per case (name, cfg, params, prompts, n_new, group, leaf, slot): a
    guarded engine on placed parameters run clean, and again with a NaN
    written after its first step into this rank's local part of
    ``caches[group][0][leaf]`` at ``slot`` -- on rank 0 only, in the
    first of its heads: each request's tokens and state, the engine's
    quarantine count, the guard's summary and whether any local cache
    leaf still holds a NaN at the end."""
    from repro_torch.distributed.sharding import (local_tree, map_with_path,
                                                  param_shardings,
                                                  place_tree, use_sharding)
    from repro_torch.serve.engine import ServeEngine
    mesh = _mesh(shape, axes)
    out = {"coordinate": mesh.get_coordinate(), "cases": {}}
    for name, cfg, params, prompts, n_new, group, leaf, slot in cases:
        placed = place_tree(params, param_shardings(params, mesh))

        def engine():
            with use_sharding(mesh):
                return ServeEngine(placed, cfg, n_slots=len(prompts),
                                   max_len=16, device="cpu")
        clean = engine().generate(prompts, n_new)
        eng = engine()
        reqs = [eng.submit(p, n_new) for p in prompts]
        eng.step()
        slots = [r.slot for r in reqs]
        target = eng.caches[group][0][leaf]
        if rank == 0:
            target.to_local()[slot].view(-1)[0] = float("nan")
        eng.run()
        nans = []
        map_with_path(lambda _, t: nans.append(bool(torch.isnan(t).any())
                                               if t.is_floating_point()
                                               else False),
                      local_tree(eng.caches))
        out["cases"][name] = {
            "clean": clean, "outputs": [r.output for r in reqs],
            "states": [r.state for r in reqs],
            "slots_of": slots,
            "placement": [str(p) for p in target.placements],
            "quarantined": eng.stats.quarantined,
            "summary": eng.guard_summary(), "nan_left": any(nans)}
    return out


def _step_collectives(rank, world, shape, axes, cfg, state, batch):
    """The collectives one ``make_sharded_train_step`` of placed ``state``
    on ``batch`` issues on this rank, as ``Recorder`` logs them."""
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.train import (AdamWConfig, make_sharded_train_step,
                                   train_state_shardings)
    mesh = _mesh(shape, axes)
    placed = place_tree(state, train_state_shardings(state, mesh))
    step = make_sharded_train_step(cfg, AdamWConfig(), mesh)
    with Recorder() as rec:
        step(placed, batch)
    return {"coordinate": mesh.get_coordinate(),
            "collectives": rec.collectives}


SCENARIOS = {"pipeline": _pipeline, "compressed_psum": _compressed_psum,
             "compressed_step": _compressed_step,
             "sharded_step": _sharded_step, "placement": _placement,
             "restore": _restore, "tp_train": _tp_train,
             "tp_serve": _tp_serve, "tp_levers": _tp_levers,
             "tp_quarantine": _tp_quarantine,
             "step_collectives": _step_collectives}


def _rank_main(scenario: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        result = SCENARIOS[scenario](rank, world, **inputs)
        with open(os.path.join(workdir, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(workdir, f"rank{rank}.pkl.tmp"),
                   os.path.join(workdir, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
