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
    state, each rank's local shards, and the plain step with
    ``num_microbatches`` equal to the batch ranks on the whole batch (its
    state also cut to the same placements);
  * ``placement``: each rank's shard of ``arange`` tensors at given specs;
  * ``restore``: ``restore_state`` of a checkpoint with ``shardings=``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

import torch

__all__ = ["run_ranks"]


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
    placed = place_tree(state, train_state_shardings(state, mesh))
    step = make_sharded_train_step(cfg, opt, mesh)
    metrics = []
    for b in batches:
        placed, m = step(placed, b)
        metrics.append(m)
    n_batch = mesh.size(mesh.mesh_dim_names.index("data"))
    plain = make_train_step(cfg, opt, num_microbatches=n_batch)
    ref, ref_metrics = state, []
    for b in batches:
        ref, m = plain(ref, b)
        ref_metrics.append(m)
    return {"metrics": metrics, "local": local_tree(placed),
            "plain_metrics": ref_metrics, "plain": ref,
            "plain_local": local_tree(place_tree(
                ref, train_state_shardings(ref, mesh))),
            "coordinate": mesh.get_coordinate()}


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


SCENARIOS = {"pipeline": _pipeline, "compressed_psum": _compressed_psum,
             "compressed_step": _compressed_step,
             "sharded_step": _sharded_step, "placement": _placement,
             "restore": _restore}


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
