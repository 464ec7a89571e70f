"""Build and bind the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/lib<name>.so`` at the repository
root, then loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). A library is rebuilt when it is older than any source under
``csrc``. :func:`build` starts one ``nvcc`` per stale source, all at once,
and waits for them; a kernel builds itself at first launch otherwise.

:class:`Binding` is what every kernel object builds on: it binds the C
entry point ``int <name>(..., stream)`` (a ``cudaError_t``), launches on
PyTorch's current stream, raises if the call reports a CUDA error, and
counts its launches (``launches``) so a run can show that its main path
went through the kernel. Each kernel object checks device, dtype, shape
and contiguity of its own operands and allocates its outputs;
:class:`CudaKernel` is the one of the two dequant-GEMMs, and
:func:`split_k` plans its split-K launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "KERNEL_NAMES", "nvcc", "build", "Binding",
           "CudaKernel", "check_cuda", "check_k", "check_stream", "split_k",
           "split_bounds"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_NAMES = ("m2xfp_matmul", "mxfp4_matmul", "m2xfp_quantize",
                "m2xfp_qmatmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the CUDA
    toolkit's default location, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch are built on a machine with the CUDA "
            "toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < newest


def build(names=KERNEL_NAMES) -> dict:
    """Compile every stale kernel library in parallel. Returns
    ``{"seconds": wall time, "ptxas": {name: ptxas -v report}}`` (an
    empty report for a library that was already current)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {name: "" for name in names}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


class Binding:
    """ctypes binding of the C entry point ``int <name>(<argtypes>...,
    stream)`` of ``csrc/<name>.cu``, which returns a ``cudaError_t``."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes + [ctypes.c_void_p]      # + the stream
        self.launches = 0
        self._fn = None
        self._err = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def _bind(self):
        if self._fn is None:
            build((self.name,))
            lib = ctypes.CDLL(str(_lib_path(self.name)))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, device: torch.device, *args, where: str) -> None:
        """Call the entry point on ``device``'s current stream; raise on a
        CUDA error (``where`` names the launch), else count the launch."""
        fn = self._bind()
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} "
                               f"({self._err(rc).decode()}) at launch with "
                               f"{where}")
        self.launches += 1


def check_cuda(name: str, what: str, t: torch.Tensor, dtypes: tuple,
               ndim: int) -> None:
    """``t`` must be a contiguous CUDA tensor of ``ndim`` dims and one of
    ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} must be "
                         f"{' or '.join(str(d).replace('torch.', '') for d in dtypes)}"
                         f", got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {ndim}-d "
                         f"tensor, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def check_stream(name: str, what: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    """A packed stream must be contiguous uint8 of ``shape`` on ``device``."""
    if t.dtype != torch.uint8 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: stream {what!r} must be uint8 {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: stream {what!r} must be contiguous on "
                         f"{device}")


def check_k(name: str, k: int) -> None:
    if k % 32:
        raise ValueError(f"{name}: K={k} is not a multiple of the 32-element "
                         f"quantization group")


# Split-K plan of the dequant-GEMMs (csrc/mx_dequant_gemm.cuh): a block owns
# BLOCK_N output columns (kBlockN there) and one of S contiguous ranges of K
# groups; the S blocks of a column tile form one thread-block cluster, which
# sums their partials in split order, so S is at most a portable cluster's 8.
BLOCK_N = 128
TARGET_BLOCKS = 2 * 132     # two blocks on each of an H100's 132 SMs
MAX_SPLITS = 8


def split_k(k: int, n: int) -> int:
    """Number of K splits of the dequant-GEMM for K x N: enough that the
    column tiles times the splits reach TARGET_BLOCKS, at most one per
    32-group and at most MAX_SPLITS. It depends on (K, N) only, never on M,
    so every row of x is summed in the same order at any M."""
    groups = k // 32
    tiles = max(1, -(-n // BLOCK_N))
    return max(1, min(-(-TARGET_BLOCKS // tiles), groups, MAX_SPLITS))


def split_bounds(groups: int, s: int) -> list:
    """Group boundaries of the ``s`` splits, as the kernel computes them:
    split i covers groups ``[b[i], b[i+1])``."""
    return [i * groups // s for i in range(s + 1)]


class CudaKernel(Binding):
    """One of the two dequant-GEMMs: ``int <name>(x, <streams>..., out, M,
    K, N, S, stream)``; ``streams`` names the packed u8 streams it reads, in
    order (codes: K/2 rows, scales and meta: K/32 rows), and ``S`` is
    :func:`split_k`."""

    ROW_DIV = {"codes": 2, "scales": 32, "meta": 32}

    def __init__(self, name: str, streams: tuple):
        super().__init__(name, [ctypes.c_void_p] * (2 + len(streams))
                         + [ctypes.c_int] * 4)
        self.streams = streams

    def __call__(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        """x (M, K) bf16 on a CUDA device @ packed W (K, N) -> f32 (M, N)."""
        check_cuda(self.name, "x", x, (torch.bfloat16,), 2)
        m, k = x.shape
        check_k(self.name, k)
        n = w["codes"].shape[1]
        for s in self.streams:
            check_stream(self.name, s, w[s], (k // self.ROW_DIV[s], n),
                         x.device)
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return out
        self.launch(x.device, x.data_ptr(),
                    *(w[s].data_ptr() for s in self.streams),
                    out.data_ptr(), m, k, n, split_k(k, n),
                    where=f"M={m} K={k} N={n}")
        return out
