"""Quantized linear layers of the serve path (port of repro.models.quant).

Modes (``ModelConfig.quant``):
  none  : plain bf16 GEMM with f32 accumulation.
  qat   : fake-quant with a straight-through estimator on the weight
          (groups along K) and the activations (along the last axis) in
          codec ``fmt``, then the plain GEMM: W4A4 simulated inside the
          training graph, the gradient that of the identity.
  serve : the weight is a packed :class:`PackedTensor` resident on the
          device at its codec's bits per element; the activations are
          fake-quantized online with the same codec and rounded to bf16.
          A codec with a fused dequant-GEMM (``kernel_codecs()``) takes
          it -- the hand-written CUDA kernel for a CUDA tensor, its plain
          version for a CPU tensor; one without (nvfp4) decodes the weight
          in its exact dtype and multiplies (``dot_f32acc``), as the
          reference's decode mirror does.

Every format decision goes through the codec registry
(``repro_torch.core.codecs``):
``fake_quant_weight`` / ``fake_quant_act`` look a codec up by name.

Tensor parallelism (ROADMAP A13): under ``use_sharding`` with a
``DeviceMesh``, a placed weight (a DTensor, or a PackedTensor of DTensor
streams) runs its product on this rank's shard through
``repro_torch.distributed.tp``: the kernel (or its plain version) on the
local packed streams; along "fsdp" the u8 streams are gathered before the
product, since the kernel reads packed bytes. The activations' online
quantization works in groups of 32 along K, so a K-shard of x quantizes
to the same bits as its slice of the whole x; a codec whose activation
scale is per tensor (``act_batch_invariant`` False) quantizes the
gathered x. A row shard whose K-shard is not whole 32-groups (ROADMAP
C3: the reference's specs then replicate ``scales`` and ``meta`` and
shard ``codes``, whose group-half interleave gives a rank bytes of a
K-set that is not x's K-shard) runs the same kernel on a padded weight
(``RowPadded``, built once by ``pad_row_shards`` where the weight is
placed for serving) over the gathered quantized x's columns of the groups
it touches. ``qat`` at such a shard, and the decode of such a placed
weight (a packed expert stack), raise ``NotImplementedError`` (ROADMAP
C4). ``decode_serving_weight`` of placed streams gathers the
decoded weight along "fsdp", or under ``REPRO_GATHER_PACKED=1`` the u8
streams before decoding.

Telemetry (``REPRO_OBS``) at the serve GEMM: the ``health`` pillar probes
the activations about to be quantized online, on their device; the
``metrics`` pillar counts the GEMM call sites by backend and the ``trace``
pillar spans them. The reference counts and spans each call site once per
trace of a jitted launch, not once per call; the port, which runs eagerly,
does so once per call site (the caller's code line) per launch kind of an
engine (``traced_once``), and once per call outside an engine's launch (an
eager reference call traces every time). Off, each costs one flag check.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys

import torch

from repro_torch import obs
from repro_torch.core import envflags
from repro_torch.core.codecs import PackedTensor, get_codec, packed_codecs
from repro_torch.distributed import tp
from repro_torch.kernels.layout import GROUP_BYTES, pad_row_shard
from repro_torch.kernels.ops import packed_matmul
from .numerics import dot_f32acc

__all__ = [
    "fake_quant_weight", "fake_quant_act", "ste", "init_linear",
    "pack_serving_weight", "decode_serving_weight", "quantized_matmul",
    "PackedTensor", "traced_once", "RowPadded", "pad_row_shards",
]

# the call sites of the serve GEMM already counted and spanned in the
# current launch kind (None: outside an engine's launch, every call counts)
_SITES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_serve_gemm_sites", default=None)
_NO_SPAN = contextlib.nullcontext()


def ste(x: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value ``x + (qx - x)`` (in bf16 it
    need not equal ``qx``; the reference's forward sees this sum), the
    gradient that of the identity in ``x``."""
    return x + (qx - x).detach()


def fake_quant_weight(w: torch.Tensor, fmt: str = "m2xfp") -> torch.Tensor:
    """Weight fake-quant along the contraction (first) axis."""
    wt = w.reshape(w.shape[0], -1).T        # (out, in): groups along in-dim
    return get_codec(fmt).fake_quant_weight(wt).T.reshape(w.shape)


def fake_quant_act(x: torch.Tensor, fmt: str = "m2xfp") -> torch.Tensor:
    """Activation fake-quant along the last (contraction) axis."""
    return get_codec(fmt).fake_quant_act(x)


def init_linear(gen: torch.Generator, d_in: int, d_out, device="cuda",
                dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) init, fan-in scaled, (d_in, d_out) in
    ``dtype``; ``d_out`` may be a tuple."""
    shape = (d_in, *d_out) if isinstance(d_out, tuple) else (d_in, d_out)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * d_in ** -0.5).to(dtype)


def _tail_streams(p: PackedTensor) -> tuple:
    """Names of the streams laid out (rows, *weight tail) -- every stream
    but a per-tensor scalar such as nvfp4's ``tscale``."""
    tail = tuple(p.shape[1:])
    return tuple(name for name, s in p.streams.items()
                 if s.dim() == len(p.shape) and tuple(s.shape[1:]) == tail)


def pack_serving_weight(w: torch.Tensor, fmt: str = "m2xfp") -> PackedTensor:
    """(K, N...) weight -> packed codec streams, groups along K (axis 0):
    each stream is (rows, N...) (a mixture-of-experts weight (K, E, N)
    gives (rows, E, N) streams), a per-tensor scalar (nvfp4's ``tscale``
    (1, 1)) keeps its shape. A weight on the "meta" device gives streams
    of the right shapes and dtypes on "meta" without running the encoder:
    each stream's rows per group of 32 are read off the encode of one
    group of two columns."""
    codec = get_codec(fmt)
    if not codec.packed:
        raise ValueError(f"codec {fmt!r} has no packed serving path; "
                         f"packable codecs: {', '.join(packed_codecs())}")
    if w.dim() < 2:
        raise ValueError(f"pack_serving_weight takes a (K, N...) weight, "
                         f"got shape {tuple(w.shape)}")
    k, tail = w.shape[0], tuple(w.shape[1:])
    n = math.prod(tail)
    if w.is_meta:
        streams = {name: torch.empty(
            (s.shape[0] * (k // 32), n) if s.shape[1] == 2 else s.shape,
            dtype=s.dtype, device="meta")
            for name, s in codec.encode(torch.zeros(32, 2)).items()}
    else:
        streams = codec.encode(w.reshape(k, n))
    streams = {name: s.reshape(s.shape[0], *tail)
               if s.dim() == 2 and s.shape[1] == n else s
               for name, s in streams.items()}
    return PackedTensor(streams, (k, *tail), fmt)


def _decode_local(codec, streams: dict, tail: tuple, shape: tuple,
                  dtype) -> torch.Tensor:
    k, n = shape[0], math.prod(shape[1:])
    flat = {name: s.reshape(s.shape[0], n) if name in tail else s
            for name, s in streams.items()}
    return codec.decode(flat, k, n).reshape(shape).to(dtype)


def _local_shape(p: PackedTensor, streams: dict, tail: tuple) -> tuple:
    """The weight shape that ``streams`` (a shard of ``p``'s, cut at group
    boundaries along the rows) decode to."""
    name = tail[0]
    rows = p.streams[name].shape[0]
    local = streams[name]
    return (p.shape[0] * local.shape[0] // rows, *local.shape[1:])


def is_placed(w) -> bool:
    """Whether ``w`` is a placed weight: a DTensor, or a PackedTensor with
    DTensor streams."""
    if isinstance(w, PackedTensor):
        return any(tp.is_dtensor(s) for s in w.streams.values())
    return tp.is_dtensor(w)


def decode_serving_weight(p: PackedTensor, dtype=None) -> torch.Tensor:
    """Packed streams -> dense (K, N...) weight in the codec's exact dtype
    (bf16 for the E8M0-scaled codecs, f32 for nvfp4) unless ``dtype``
    overrides it.

    Placed streams (DTensors) give a DTensor on their mesh, replicated
    along every dim but "model" and sharded along "model" as the streams
    are: by default each rank decodes its own streams and the decoded
    weight is all-gathered along "fsdp", as the reference does; under
    ``REPRO_GATHER_PACKED=1`` the u8 streams are gathered along "fsdp"
    first and then decoded (the same bits: the decode is per group)."""
    codec = get_codec(p.codec)
    tail = _tail_streams(p)
    dtype = dtype or codec.decode_dtype
    if not is_placed(p):
        return _decode_local(codec, p.streams, tail, p.shape, dtype)
    from torch.distributed.tensor import DTensor
    if _splits_groups(p):
        raise NotImplementedError(
            "decode of a placed packed weight whose row shard splits "
            "32-groups (ROADMAP C4); its product runs on a padded shard")
    streams = p.streams
    if envflags.get_bool("REPRO_GATHER_PACKED"):
        streams = {name: tp.gather_weight(s) if tp.is_dtensor(s) else s
                   for name, s in streams.items()}
    ref = streams[tail[0]]
    local = {name: s.to_local() if tp.is_dtensor(s) else s
             for name, s in streams.items()}
    w = _decode_local(codec, local, tail, _local_shape(p, local, tail),
                      dtype)
    return tp.gather_weight(DTensor.from_local(
        w, ref.device_mesh, ref.placements, run_check=False))


@contextlib.contextmanager
def traced_once(seen: set):
    """Within, each serve-GEMM call site counts and spans only its first
    call; ``seen`` keeps the sites (an engine keeps one set per launch
    kind, as the reference traces each jitted launch once)."""
    token = _SITES.set(seen)
    try:
        yield
    finally:
        _SITES.reset(token)


def _first_at_site(codec: str, k: int, n: int) -> bool:
    """Whether this serve-GEMM call is its call site's first in the current
    ``traced_once`` scope (always, outside one). The site is the line that
    called ``quantized_matmul``, with the codec and the shape."""
    seen = _SITES.get()
    if seen is None:
        return True
    # -> _serve_telemetry -> _serve_matmul (or _tp_matmul) ->
    # quantized_matmul -> the site
    caller = sys._getframe(4)
    key = (caller.f_code.co_filename, caller.f_lineno, codec, k, n)
    if key in seen:
        return False
    seen.add(key)
    return True


def _serve_matmul(x: torch.Tensor, w: PackedTensor) -> torch.Tensor:
    """Online activation fake-quant with the weight's codec and bf16
    rounding, then the codec's packed GEMM, or, for a codec without one,
    its decode and ``dot_f32acc`` of the activations upcast to the decoded
    dtype. The f32 result is cast back to ``x.dtype``.

    Telemetry (module docstring): the ``health`` probe of ``x``; the
    counter ``repro_serve_gemm_traces_total`` and the span
    ``trace.serve_matmul`` labeled by backend ("cuda": the hand-written
    kernel on a CUDA tensor; "plain": a CPU tensor's plain version, or a
    codec without a kernel, which decodes -- the reference's "pallas" and
    "xla"), codec, k and n."""
    codec = get_codec(w.codec)
    k = w.shape[0]
    n = math.prod(w.shape[1:])
    span = _serve_telemetry(x, codec, k, n)
    xq = quantize_act(x, codec)
    with span:
        out = _packed_product(xq, w)
    return out.to(x.dtype)


def _serve_telemetry(x: torch.Tensor, codec, k: int, n: int):
    """The serve GEMM's probe, counter and span (module docstring): the
    ``health`` probe of ``x`` now, and the span to run the product in."""
    on = obs.pillars()
    if "health" in on:
        obs.quant_health.probe_act(tp.full(x), site="serve_gemm",
                                   codec=codec.name)
    if ("metrics" in on or "trace" in on) and _first_at_site(
            codec.name, k, n):
        backend = "cuda" if codec.kernel is not None and x.is_cuda \
            else "plain"
        if "metrics" in on:
            obs.counter(
                "repro_serve_gemm_traces_total",
                "serve GEMM call sites traced, by dispatched backend").inc(
                backend=backend, codec=codec.name, k=k, n=n)
        return obs.span("trace.serve_matmul", cat="trace", backend=backend,
                        codec=codec.name, k=k, n=n)
    return _NO_SPAN


def quantize_act(x: torch.Tensor, codec) -> torch.Tensor:
    """The serve path's online activation quantization: ``codec``'s
    fake-quant in f32, rounded to bf16."""
    return codec.fake_quant_act(x.to(torch.float32)).to(torch.bfloat16)


def _packed_product(xq: torch.Tensor, w: PackedTensor) -> torch.Tensor:
    """xq (..., K) bf16 @ packed w (K, N...) -> f32 (..., N): the codec's
    packed GEMM, or for a codec without one its decode and ``dot_f32acc``
    of xq upcast to the decoded dtype. ``w`` holds plain tensors (one
    rank's shard under tensor parallelism)."""
    codec = get_codec(w.codec)
    k = xq.shape[-1]
    if codec.kernel is None:
        wd = decode_serving_weight(w)
        return dot_f32acc(xq.to(wd.dtype), wd.reshape(k, -1))
    out = packed_matmul(xq.reshape(-1, k), w.streams, w.codec)
    return out.reshape(*xq.shape[:-1], out.shape[-1])


def fake_quant_ste(x: torch.Tensor, quantize) -> torch.Tensor:
    """``ste(x, quantize(x as f32) cast back to x's dtype)``; the
    fake-quant itself runs outside autograd (its gradient is cut)."""
    with torch.no_grad():
        qx = quantize(x.detach().to(torch.float32)).to(x.dtype)
    return ste(x, qx)


def quantized_matmul(x: torch.Tensor, w, quant: str,
                     fmt: str = "m2xfp") -> torch.Tensor:
    """x (..., K) @ w (K, N) under the configured quantization mode. ``w``
    is a dense tensor for ``none`` and ``qat`` and a PackedTensor for
    ``serve`` (a dense weight under ``serve`` -- one too narrow to pack --
    runs the dense GEMM, as in the reference). ``fmt`` is the codec of
    ``qat``'s fake-quant; a packed weight carries its own."""
    if is_placed(w):
        return _tp_matmul(x, w, quant, fmt)
    if quant == "serve" and isinstance(w, PackedTensor):
        return _serve_matmul(x, w)
    if quant == "qat":
        w = fake_quant_ste(w, lambda t: fake_quant_weight(t, fmt))
        x = fake_quant_ste(x, lambda t: fake_quant_act(t, fmt))
    elif quant not in ("none", "serve"):
        raise ValueError(f"unknown quant mode {quant!r}")
    return dot_f32acc(x, w).to(x.dtype)


def _tp_matmul(x, w, quant: str, fmt: str):
    """``quantized_matmul`` of a placed weight (module docstring): the
    product on this rank's shard of ``w`` through ``placed_product``. x is
    a DTensor activation on the "model" submesh (or a plain tensor, the
    same on every rank)."""
    cols = None
    if isinstance(w, PackedTensor):
        tail = _tail_streams(w)
        ref = w.streams[tail[0]]
        if isinstance(w, RowPadded):
            w_local, cols = w.local, w.cols
        elif _splits_groups(w):
            raise ValueError(
                "a placed packed weight whose row shard splits 32-groups "
                "(ROADMAP C3) runs on its padded shard: place it with "
                "pad_row_shards (a ServeEngine on placed parameters does)")
        else:
            local = {name: tp.model_local(t)
                     for name, t in w.streams.items()}
            w_local = PackedTensor(local, _local_shape(w, local, tail),
                                   w.codec)
        codec = get_codec(w.codec)
    else:
        ref = w
        w_local = tp.model_local(w)
        codec = get_codec(fmt)
    serve = quant == "serve" and isinstance(w, PackedTensor)
    k, n = w.shape[0], math.prod(w.shape[1:])
    with _serve_telemetry(x, codec, k, n) if serve else _NO_SPAN:
        return placed_product(
            x, w_local, tp.model_placement(ref), (ref.dim() - 1, 0, None),
            quant, codec, serve,
            _packed_product if serve else dot_f32acc,
            lambda xl: _quantize_for(xl, codec, serve, fmt),
            lambda t: fake_quant_weight(t, fmt), cols)


def _splits_groups(w: PackedTensor) -> bool:
    """Whether placed ``w``'s ``codes`` are row-sharded over "model" in
    shards that are not whole 32-groups (ROADMAP C3: qwen2-0.5b's ``wo``,
    K 896, on a 16-wide "model" axis)."""
    codes = w.streams["codes"]
    if not tp.is_dtensor(codes):
        return False
    pl = tp.model_placement(codes)
    return pl.is_shard() and pl.dim == 0 \
        and (codes.shape[0] // tp.tp_size()) % GROUP_BYTES != 0


class RowPadded(PackedTensor):
    """A placed packed weight whose row shard splits 32-groups
    (``_splits_groups``) with this rank's padded operand ``local`` (plain
    tensors) over x's columns ``cols`` = (k0, k1), which its products
    run on (``kernels/layout.py::pad_row_shard``). Made by
    ``pad_row_shards`` where the weight is placed for serving."""

    def __init__(self, placed: PackedTensor, local: PackedTensor,
                 cols: tuple):
        super().__init__(placed.streams, placed.shape, placed.codec)
        self.local, self.cols = local, cols


def pad_row_shards(tree):
    """``tree`` with every placed packed weight whose row shard splits
    32-groups as a ``RowPadded`` of it: its streams gathered whole, then
    this rank's ``pad_row_shard``. Every rank of the active mesh runs it
    together (it gathers); a ``ServeEngine`` on placed parameters does."""
    if isinstance(tree, dict):
        return {key: pad_row_shards(v) for key, v in tree.items()}
    if isinstance(tree, list):
        return [pad_row_shards(v) for v in tree]
    if not isinstance(tree, PackedTensor) or isinstance(tree, RowPadded) \
            or not _splits_groups(tree):
        return tree
    with torch.no_grad():
        whole = {name: s.full_tensor() if tp.is_dtensor(s) else s
                 for name, s in tree.streams.items()}
        streams, cols = pad_row_shard(whole, tree.shape[0], tp.tp_rank(),
                                      tp.tp_size())
    local = PackedTensor(streams, (cols[1] - cols[0], *tree.shape[1:]),
                         tree.codec)
    return RowPadded(tree, local, cols)


def placed_product(x, w_local, placement, dims: tuple, quant: str, codec,
                   serve: bool, matmul, quantize_x, fake_quant_w,
                   cols=None):
    """The tensor-parallel product of x and ``w_local``, this rank's shard
    of a placed weight whose placement along "model" is ``placement``:
    the one dispatch of the dense projections (``_tp_matmul``) and the
    expert stacks (``moe._expert_matmul``). ``dims`` are the weight's
    (N, K, E) dims for ``tp.kind_of``; ``serve`` says that x is quantized
    online with ``codec`` (a packed weight), ``qat`` that it and the shard
    are fake-quantized (``quantize_x``, ``fake_quant_w``); a row product
    of a codec whose activation scale is per tensor quantizes the gathered
    x. ``cols`` (k0, k1): ``w_local`` is a padded row shard
    (``RowPadded``) over x's columns k0 .. k1 - 1, which the product
    takes from the gathered and quantized x. ``matmul(x_local, w_local)``
    gives the local f32 product, cast to x's dtype (a row product's after
    its reduce)."""
    if quant not in ("none", "serve", "qat"):
        raise ValueError(f"unknown quant mode {quant!r}")
    kind = tp.kind_of(placement, *dims)
    if quant == "qat":
        if not codec.act_batch_invariant and kind != "replicated":
            # its weight scale is per tensor too: a shard's would differ
            raise NotImplementedError(
                f"qat with codec {codec.name!r} (a per-tensor scale) on a "
                f"weight sharded over 'model' is not tensor-parallel")
        if kind == "row" and w_local.shape[dims[1]] % codec.group:
            raise NotImplementedError(
                f"qat on a weight row-sharded over 'model' whose K-shard "
                f"({w_local.shape[dims[1]]} rows) splits the codec's "
                f"{codec.group}-element groups (ROADMAP C4)")
        w_local = fake_quant_ste(w_local, fake_quant_w)
    out_dtype = x.dtype
    quantized = serve or quant == "qat"
    if quantized and kind == "row" and (
            cols is not None or not codec.act_batch_invariant):
        # a per-tensor activation scale, or a padded row shard, needs the
        # whole x: quantize the gathered x; ``tp.row`` takes this rank's
        # K-shard of it (or its columns ``cols``)
        x = tp.wrap(quantize_x(tp.full(x)), tp.replicate())
        quantized = False

    def product(xl):
        return matmul(quantize_x(xl) if quantized else xl, w_local)

    def cast(xl):
        return product(xl).to(out_dtype)
    if kind == "column":
        return tp.column(x, cast, w_local.shape)
    if kind == "row":
        return tp.row(x, product, w_local.shape, out_dtype,
                      (None,) * x.dim(), cols)
    if kind == "expert":             # x's E axis: the experts' (ng, E, C, d)
        return tp.expert(x, cast, w_local.shape, dim=1)
    return tp.replicated(x, cast, w_local.shape)


def _quantize_for(x: torch.Tensor, codec, serve: bool, fmt: str):
    """x's online quantization: the serve path's (bf16) or ``qat``'s
    straight-through fake-quant in ``fmt``."""
    if serve:
        return quantize_act(x, codec)
    return fake_quant_ste(x, lambda t: fake_quant_act(t, fmt))
