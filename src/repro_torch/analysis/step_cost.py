"""What one rank's step costs, counted by running it (the port's
counterpart of repro.analysis.hlo, which parses the reference's compiled
HLO; the port has no HLO, so it runs the step instead).

``step_costs`` runs each cell's step -- a train step with AdamW
(``make_sharded_train_step``), a prefill forward, or a ``decode_step``
against full caches -- on PyTorch's "meta" device (shapes only, no
memory), placed at the cell's shardings on a ``DeviceMesh`` over a fake
process group of the mesh's size (``torch.testing``'s ``FakeStore``,
backend "fake": its collectives return at once), as rank 0. The fake
group must be the process's default group, so ``step_costs`` counts the
cells in one child process (``python -m repro_torch.analysis.step_cost``),
one after another, and ``step_cost`` one; ``count_cells`` counts them in a
process that has no default group of its own. Eager PyTorch runs every loop
trip, so nothing is multiplied by a trip count.

Counted per rank, under the keys of the reference's ``HloAnalysis``:

  flops_per_device   2·M·K·N for every product, the reference's dot-only
      convention: the aten products (``mm``, ``addmm``, ``bmm``,
      ``baddbmm``, by ``torch.utils.flop_counter``'s formulas) seen by a
      dispatch mode, and each packed product once at
      ``kernels.ops.packed_matmul`` (``product_scope``), whose interior
      is not counted: on the card that is a kernel no dispatch mode sees,
      on the CPU the plain version's decode and product, so both count the
      same. A row shard whose K-shard splits 32-groups runs on a padded
      weight (``models/quant.py::RowPadded``, ROADMAP C3) and counts
      as what the card runs, 2·M·K_launched·N with K_launched the padded
      K (up to two partial groups above K/t). Elementwise work is not
      counted.
  hbm_bytes_per_device   the least traffic of the step: this rank's part
      of every tensor it is handed (parameters, optimizer state, caches,
      inputs; ``count``'s ``reads``) read once, and every tensor it
      returns (logits; a train step's new state and metrics) written
      once. Activations, and a decode step's writes into its caches, are
      left out, so no schedule of the step moves fewer bytes; a decode
      step reads its whole caches (the port's and the reference's mask
      the positions past a slot's index, they do not skip them). This is
      the roofline's memory term.
  hbm_bytes_upper_per_device   the input and output bytes of every aten op
      the step dispatches on the compute device (views, and the interior
      of a packed product, which counts its x, streams and output once,
      excluded); an in-place write counts its whole operand. The port
      does not fuse, so this bounds the reference's post-fusion proxy
      (operand and result bytes of top-level HLO instructions) from
      above; it is no bound on time.
  collective_bytes_per_device, per_kind_bytes, per_kind_count   every
      collective the step issues (``CollectiveLog``: DTensor's functional
      collectives and the port's eager ``torch.distributed`` calls), with
      its group's size G, through the reference's ring formulas (hlo.py,
      copied in ``wire_bytes``); a broadcast counts as a
      collective-permute. The fake mesh is a "cuda" mesh by default, so
      DTensor issues the card's collectives (an all-to-all where a CPU
      mesh, for gloo, makes it an all-gather and a slice).

Not reported (``NOT_REPORTED``): loop trips, compile time, XLA's temp
bytes and the CPU backend's f32 mirrors, each with its reason.

``CollectiveLog`` is also the collective hook of
``repro_torch.testing.distributed.Recorder``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Optional

import torch

__all__ = ["step_cost", "step_costs", "count_cells", "cost_spec", "count",
           "cell_step",
           "wire_bytes", "collective_cost", "CollectiveLog", "NOT_REPORTED",
           "KINDS"]

NOT_REPORTED = {
    "loop_trips": "eager PyTorch runs every trip of every loop; there is "
                  "no loop body to multiply",
    "compile_s": "the port is not compiled",
    "temp_bytes": "XLA's temporary buffers have no counterpart; the "
                  "caching allocator's peak is measured on the card only",
    "cpu_f32_mirror_bytes": "an artifact of XLA's CPU backend, which the "
                            "port does not have",
}

# the port's collective names -> the reference's (hlo.py) kinds
KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all": "all-to-all",
         "broadcast": "collective-permute"}


def wire_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Bytes one rank sends for a collective of ``kind`` (the reference's
    names) whose output is ``out_bytes`` over a group of ``g``: hlo.py's
    ring estimates."""
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes if g > 1 else 0.0        # collective-permute


def _out_bytes(op: str, nbytes: int, g: int) -> float:
    """A collective's output bytes from the bytes handed to it."""
    if op == "all_gather":
        return nbytes * g
    if op == "reduce_scatter":
        return nbytes / g
    return nbytes


def collective_cost(records) -> dict:
    """{collective_bytes_per_device, per_kind_bytes, per_kind_count} of
    ``CollectiveLog`` records."""
    size = defaultdict(float)
    n = defaultdict(int)
    for r in records:
        kind = KINDS[r["op"]]
        g = r["group_size"]
        size[kind] += wire_bytes(kind, _out_bytes(r["op"], r["nbytes"], g),
                                 g)
        n[kind] += 1
    return {"collective_bytes_per_device": sum(size.values()),
            "per_kind_bytes": dict(size), "per_kind_count": dict(n)}


# ---------------------------------------------------------------------------
# The collective hook
# ---------------------------------------------------------------------------

_FUNCOL = {"all_reduce": "all_reduce",
           "all_gather_into_tensor": "all_gather",
           "reduce_scatter_tensor": "reduce_scatter",
           "all_to_all_single": "all_to_all",
           "broadcast": "broadcast"}
_EAGER = ("all_reduce", "all_gather_into_tensor", "all_gather",
          "reduce_scatter_tensor", "all_to_all_single", "broadcast")


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class CollectiveLog:
    """Every collective issued while active (a context manager), in
    ``records``: dicts of ``op`` (all_reduce, all_gather, reduce_scatter,
    all_to_all, broadcast), ``dtype``, ``shape`` and ``nbytes`` of the
    tensor handed to it (an all-gather's input), ``group`` (the group's
    name), ``group_size``, and what ``annotate()`` adds. DTensor's
    functional collectives are seen through a dispatch mode, the eager
    ``torch.distributed`` calls through wrappers of those functions; all
    are put back on exit."""

    def __init__(self, annotate: Optional[Callable[[], dict]] = None):
        self.records: list = []
        self._annotate = annotate

    def _log(self, op, t, group_name, group_size):
        rec = {"op": op, "dtype": str(t.dtype).replace("torch.", ""),
               "shape": tuple(t.shape), "group": str(group_name),
               "group_size": int(group_size),
               "nbytes": t.numel() * t.element_size()}
        if self._annotate is not None:
            rec.update(self._annotate())
        self.records.append(rec)

    def __enter__(self):
        import torch.distributed as dist
        from torch.utils._python_dispatch import TorchDispatchMode
        log = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                if func.namespace == "_dtensor" \
                        and name == "shard_dim_alltoall":
                    log._log("all_to_all", args[0], args[3],
                             _group_size(args[3]))
                elif func.namespace == "_c10d_functional" \
                        and name in _FUNCOL:
                    group = [a for a in args if isinstance(a, str)][-1]
                    sizes = [a for a in args[1:] if isinstance(a, int)
                             and not isinstance(a, bool)]
                    g = sizes[0] if name in ("all_gather_into_tensor",
                                             "reduce_scatter_tensor") \
                        and sizes else _group_size(group)
                    log._log(_FUNCOL[name], args[0], group, g)
                return func(*args, **(kwargs or {}))

        self._saved = {n: getattr(dist, n) for n in _EAGER}

        def wrapped(n, f):
            @functools.wraps(f)
            def call(tensor, *a, **k):
                group = k.get("group") or dist.group.WORLD
                t = tensor[0] if isinstance(tensor, (list, tuple)) \
                    else tensor
                log._log(_FUNCOL.get(n, n),
                         t if n != "all_gather_into_tensor" else a[0],
                         group.group_name, group.size())
                return f(tensor, *a, **k)
            return call
        for n, f in self._saved.items():
            setattr(dist, n, wrapped(n, f))
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        self._mode.__exit__(*exc)
        for n, f in self._saved.items():
            setattr(dist, n, f)
        return False


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dots() -> dict:
    """The aten products -> the index of their first matrix operand (the
    second follows it): ``addmm`` and ``baddbmm`` take the bias first."""
    aten = torch.ops.aten
    return {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1}


def _dot_flops(a: torch.Tensor, b: torch.Tensor) -> int:
    """2·M·K·N of a (..., M, K) @ (..., K, N) product (batched: times the
    batch)."""
    return 2 * math.prod(a.shape) * b.shape[-1]


# ops that allocate without moving data, or alias their input
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "_wrap_tensor_autograd", "wait_tensor", "lift_fresh",
               "_local_scalar_dense")


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _signature(x, tensors: list, opaque: list):
    """The memo key of an op's arguments ``x`` (nested tuples, lists and
    dicts): a tensor by its dtype, shape, stride and offset, anything else
    by its type and value. Every tensor is appended to ``tensors``; one
    that is not a plain meta tensor is also appended to ``opaque``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        if type(x) is not torch.Tensor or not x.is_meta:
            opaque.append(x)
            return None
        return (x.dtype, x.shape, x.stride(), x.storage_offset())
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_signature(v, tensors, opaque) for v in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _signature(v, tensors, opaque))
                               for k, v in x.items())
    return (type(x), x)


@functools.lru_cache(maxsize=None)
def _functional(func) -> bool:
    """Whether ``func`` is an aten op that writes no input and returns no
    alias of one (its results are fresh tensors)."""
    schema = func._schema
    return func.namespace in ("aten", "prims") and not func.is_view \
        and not schema.is_mutable \
        and all(r.alias_info is None for r in schema.returns)


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


class _Counter:
    """The dispatch mode and the packed-product scope of ``count``.

    On meta tensors a functional aten op computes nothing but its
    results' shapes, strides and dtypes, through PyTorch's Python meta
    functions, which cost far more than the counting. A step repeats the
    same few ops layer after layer, so the mode keeps each op's results'
    metadata by its arguments' (tensors by dtype, shape, stride and
    offset; everything else by type and value) and makes fresh meta
    tensors from them when the same call comes again: the counts see the
    same arguments and results either way."""

    def __init__(self, device: str):
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.product_flops = 0
        self.products = 0
        self._inside = 0
        self._memo: dict = {}

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        c = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                tensors, opaque = [], []
                key = _signature((args, kwargs), tensors, opaque)
                out = c.run(func, args, kwargs, None if opaque else key)
                if not c._inside:
                    c.op(func, args, tensors, out)
                return out
        return _Mode()

    def run(self, func, args, kwargs, key):
        """``func(*args, **kwargs)``, or on meta tensors its results made
        anew from a memo (class docstring); ``key`` is the arguments'
        ``_signature`` (None: not to be kept)."""
        if key is None or self.device != "meta" or not _functional(func):
            return func(*args, **kwargs)
        key = (func, key)
        try:
            hit = self._memo.get(key)
        except TypeError:                      # an unhashable argument
            return func(*args, **kwargs)
        if hit is not None:
            return hit[0](_meta_like(t) for t in hit[1]) if hit[0] \
                else _meta_like(hit[1])
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and type(out) is torch.Tensor \
                and out.is_meta:
            self._memo[key] = (None, _meta_like(out))
        elif isinstance(out, (tuple, list)) and out and all(
                type(t) is torch.Tensor and t.is_meta for t in out):
            self._memo[key] = (type(out), [_meta_like(t) for t in out])
        return out

    def op(self, func, args, tensors, out) -> None:
        tensors = tensors + ([out] if isinstance(out, torch.Tensor)
                             else _tensors(out))
        if not any(t.device.type == self.device for t in tensors):
            return
        first = _dots().get(func.overloadpacket)
        if first is not None:
            self.flops += _dot_flops(args[first], args[first + 1])
        name = func.__name__.split(".")[0]
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in tensors)

    @contextlib.contextmanager
    def product(self, x, w_packed: dict, n: int):
        """A packed product x (M, K) @ W (K, N): 2·M·K·N FLOPs and the
        bytes of x, the streams and the f32 output, once."""
        m, k = x.shape
        flops = 2 * m * k * n
        self.flops += flops
        self.product_flops += flops
        self.products += 1
        self.bytes += _nbytes(x) + sum(_nbytes(s) for s in w_packed.values()) \
            + 4 * m * n
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1


def _local_tensors(tree, out: dict) -> dict:
    """{id: tensor} of this rank's part of every tensor of ``tree``
    (dicts, lists, tuples, PackedTensors' streams; a DTensor by its local
    shard)."""
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.distributed import tp
    if isinstance(tree, PackedTensor):
        tree = tree.streams
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _local_tensors(v, out)
    elif isinstance(tree, torch.Tensor):
        t = tree.to_local() if tp.is_dtensor(tree) else tree
        out.setdefault(id(tree), t)
    return out


def count(fn: Callable[[], object], device: str = "meta",
          reads=()) -> dict:
    """Run ``fn()`` and count what it does on ``device`` (module
    docstring); ``reads`` is the tree of what ``fn`` is handed. The cost
    keys, plus ``product_flops`` and ``products`` (the packed products
    alone), ``collectives`` (the log) and ``gemms`` (the tensor-parallel
    product dispatches, ``tp.on_gemm``'s kind and local shapes)."""
    from repro_torch.distributed import tp
    from repro_torch.kernels import ops
    c = _Counter(device)
    gemms = []
    prev, prev_gemm = ops.product_scope, tp.on_gemm
    ops.product_scope = c.product

    def on_gemm(kind, x, w):
        gemms.append((kind, x, w))
        if prev_gemm is not None:
            prev_gemm(kind, x, w)
    tp.on_gemm = on_gemm
    log = CollectiveLog()
    t0 = time.perf_counter()
    try:
        with log, c.mode():
            result = fn()
    finally:
        ops.product_scope, tp.on_gemm = prev, prev_gemm
    handed = _local_tensors(reads, {})
    made = {k: t for k, t in _local_tensors(result, {}).items()
            if k not in handed}
    out = {"flops_per_device": c.flops,
           "hbm_bytes_per_device": sum(_nbytes(t) for t in handed.values())
           + sum(_nbytes(t) for t in made.values()),
           "hbm_bytes_upper_per_device": c.bytes,
           "product_flops": c.product_flops, "products": c.products}
    out.update(collective_cost(log.records))
    out["collectives"] = log.records
    out["gemms"] = gemms
    out["count_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# A cell's step on meta
# ---------------------------------------------------------------------------

def _local_inputs(inputs: dict, mesh, rules) -> dict:
    """This rank's slice of each input (axis 0 over the batch axes)."""
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  logical_to_spec,
                                                  use_sharding)
    with use_sharding(mesh, rules):
        return {k: NamedSharding(mesh, logical_to_spec(
            ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape))).place(
            v).to_local() for k, v in inputs.items()}


def cell_step(cfg, kind: str, batch: int, seq: int, mesh, rules=None,
              num_microbatches: int = 1,
              device: str = "meta") -> tuple:
    """(the step of one rank of ``mesh`` (a ``DeviceMesh``) for a cell, on
    tensors of ``device`` placed at the cell's shardings, what it is
    handed: ``count``'s ``reads``). ``kind`` "train" is the sharded AdamW
    step of ``cfg``, "prefill" ``forward`` of ``cfg``'s packed serve
    parameters, "decode" ``decode_step`` of one token per slot against
    caches of ``seq`` positions. On "meta" nothing is computed; on "cpu"
    the parameters are drawn and packed and the step runs the plain
    versions (inputs and caches zero)."""
    from repro_torch.configs.shapes import _tokens_spec
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings,
                                                  place_tree, use_sharding)
    from repro_torch.models.model import decode_step, forward, init_caches
    from repro_torch.models.quant import pad_row_shards
    gen = torch.Generator()

    def on_device(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    if kind == "train":
        from repro_torch.train import (AdamWConfig, make_sharded_train_step,
                                       make_train_state,
                                       train_state_shardings)
        state = make_train_state(gen, cfg, device=device)
        placed = place_tree(state, train_state_shardings(state, mesh, rules))
        inputs = _tokens_spec(cfg, batch, seq)
        inputs["labels"] = torch.empty((batch, seq), dtype=torch.int32,
                                       device="meta")
        inputs = {k: on_device(v) for k, v in inputs.items()}
        step = make_sharded_train_step(cfg, AdamWConfig(), mesh, rules,
                                       num_microbatches)
        return (lambda: step(placed, inputs)), (placed, inputs)
    from repro_torch.serve.prequant import init_packed_params
    params = init_packed_params(gen, cfg, device)
    placed = place_tree(params, param_shardings(params, mesh, rules))
    with use_sharding(mesh, rules):
        placed = pad_row_shards(placed)
    if kind == "prefill":
        local = _local_inputs({k: on_device(v) for k, v in _tokens_spec(
            cfg, batch, seq).items()}, mesh, rules)

        def prefill():
            with torch.no_grad(), use_sharding(mesh, rules):
                return forward(placed, cfg, local)
        return prefill, (placed, local)
    caches = init_caches(cfg, batch, seq, device)
    caches = place_tree(caches, cache_shardings(caches, mesh, rules))
    local = _local_inputs({k: on_device(v) for k, v in dict(
        _tokens_spec(cfg, batch, 1), index=torch.empty(
            (batch,), dtype=torch.int64, device="meta")).items()}, mesh,
        rules)
    index = local.pop("index")

    def decode():
        with torch.no_grad(), use_sharding(mesh, rules):
            return decode_step(placed, cfg, local, caches, index)
    return decode, (placed, caches, local, index)


def count_cells(specs: list) -> list:
    """Count each cell of ``specs`` (``cost_spec``) in this process, as
    rank 0 of a fake group of its mesh's size made the default group, on a
    mesh of its ``mesh_device``'s type (a group is formed anew where the
    size or the device type changes, and destroyed at the end): its
    counts, or the traceback of a cell that raised (the others still
    run). The process must have no default group of its own
    (``step_costs`` runs this in a child)."""
    import traceback
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    out, group = [], None
    try:
        for spec in specs:
            shape, axes = tuple(spec["mesh_shape"]), tuple(spec["axes"])
            t0 = time.perf_counter()
            try:
                if group != (math.prod(shape), spec["mesh_device"]):
                    if group is not None:
                        dist.destroy_process_group()
                        group = None
                    dist.init_process_group("fake", store=FakeStore(),
                                            rank=0,
                                            world_size=math.prod(shape))
                    group = (math.prod(shape), spec["mesh_device"])
                mesh = init_device_mesh(spec["mesh_device"], shape,
                                        mesh_dim_names=axes)
                fn, reads = cell_step(spec["cfg"], spec["kind"],
                                      spec["batch"], spec["seq"], mesh,
                                      spec["rules"],
                                      spec["num_microbatches"])
                res = count(fn, reads=reads)
            except Exception:  # noqa: BLE001 -- reported for this cell
                out.append(traceback.format_exc()[-3000:])
                continue
            if not spec["keep_collectives"]:
                res.pop("collectives")
                res.pop("gemms")
            res["seconds"] = time.perf_counter() - t0
            out.append(res)
    finally:
        if group is not None:
            dist.destroy_process_group()
    return out


def cost_spec(cfg, kind: str, batch: int, seq: int, mesh_shape=(1, 1),
              axes=("data", "model"), rules: Optional[dict] = None,
              num_microbatches: int = 1, keep_collectives: bool = False,
              mesh_device: str = "cuda") -> dict:
    """One cell for ``step_costs``: ``cfg``'s step of ``kind`` ("train",
    "prefill", "decode"; ``cell_step``) on a ``mesh_shape`` mesh named
    ``axes`` with the logical ``rules``. ``keep_collectives`` keeps the
    collective log and the product dispatches. ``mesh_device`` is the
    mesh's device type, which picks DTensor's collectives: "cuda" (the
    default; no card is needed) those of NCCL on the card, "cpu" gloo's
    (an all-to-all made an all-gather and a slice)."""
    return dict(cfg=cfg, kind=kind, batch=batch, seq=seq,
                mesh_shape=tuple(mesh_shape), axes=tuple(axes), rules=rules,
                num_microbatches=num_microbatches,
                keep_collectives=keep_collectives, mesh_device=mesh_device)


def step_costs(specs: list, timeout_s: float = 900.0) -> list:
    """One rank's cost (module docstring) of each cell of ``specs``
    (``cost_spec``), counted one after another in one child process:
    per cell its counts with ``seconds``, or a ``RuntimeError`` naming
    what it raised. A child still running after ``timeout_s`` is killed
    and ``TimeoutError`` raised; a child that fails raises
    ``RuntimeError`` with its stderr's tail."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        src_path, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp,
                                                                  "out.pkl")
        with open(src_path, "wb") as f:
            pickle.dump(specs, f)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.analysis.step_cost",
                 src_path, dst], env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"step_costs of {len(specs)} cells did not "
                               f"finish in {timeout_s} s") from None
        if proc.returncode != 0:
            raise RuntimeError("step_costs failed:\n" + proc.stderr.decode(
                errors="replace")[-3000:])
        with open(dst, "rb") as f:
            out = pickle.load(f)
    return [RuntimeError(f"step_cost of {spec['cfg'].name} {spec['kind']} "
                         f"failed:\n{r}") if isinstance(r, str) else r
            for spec, r in zip(specs, out)]


def step_cost(cfg, kind: str, batch: int, seq: int, mesh_shape=(1, 1),
              axes=("data", "model"), rules: Optional[dict] = None,
              num_microbatches: int = 1, timeout_s: float = 900.0,
              keep_collectives: bool = False,
              mesh_device: str = "cuda") -> dict:
    """One cell's ``step_costs`` (``cost_spec``'s arguments); raises what
    the cell raised."""
    out, = step_costs([cost_spec(cfg, kind, batch, seq, mesh_shape, axes,
                                 rules, num_microbatches, keep_collectives,
                                 mesh_device)], timeout_s)
    if isinstance(out, Exception):
        raise out
    return out


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        _specs = pickle.load(f)
    _result = count_cells(_specs)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(_result, f)
