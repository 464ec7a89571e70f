"""Build and bind the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/lib<name>.so`` at the repository
root, then loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). A library is rebuilt when it is older than any source under
``csrc``. :func:`build` starts one ``nvcc`` per stale source, all at once,
and waits for them; a kernel builds itself at first launch otherwise.

:class:`CudaKernel` is the launcher every kernel module wraps: it checks
device, dtype, shape and contiguity, allocates the f32 output, launches on
PyTorch's current stream, raises if the C call reports a CUDA error, and
counts its launches (``launches``) so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "KERNEL_NAMES", "nvcc", "build", "CudaKernel"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_NAMES = ("m2xfp_matmul", "mxfp4_matmul")
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


class CudaKernel:
    """ctypes binding of one ``csrc/<name>.cu`` dequant-GEMM.

    The C entry point is ``int <name>(x, <streams>..., out, M, K, N,
    stream)`` returning a ``cudaError_t``; ``streams`` names the packed
    u8 streams it reads, in order, with their row divisor along K
    (codes: K/2 rows, scales and meta: K/32 rows)."""

    ROW_DIV = {"codes": 2, "scales": 32, "meta": 32}

    def __init__(self, name: str, streams: tuple):
        self.name = name
        self.streams = streams
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
            fn.argtypes = ([ctypes.c_void_p] * (2 + len(self.streams))
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        """x (M, K) bf16 on a CUDA device @ packed W (K, N) -> f32 (M, N)."""
        if not x.is_cuda:
            raise ValueError(f"{self.name}: x must be a CUDA tensor, got "
                             f"{x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{self.name}: x must be bfloat16, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{self.name}: x must be a contiguous (M, K) "
                             f"matrix, got shape {tuple(x.shape)} strides "
                             f"{x.stride()}")
        m, k = x.shape
        if k % 32:
            raise ValueError(f"{self.name}: K={k} is not a multiple of the "
                             f"32-element quantization group")
        n = w["codes"].shape[1]
        for s in self.streams:
            t = w[s]
            want = (k // self.ROW_DIV[s], n)
            if t.dtype != torch.uint8 or tuple(t.shape) != want:
                raise ValueError(f"{self.name}: stream {s!r} must be uint8 "
                                 f"{want}, got {t.dtype} {tuple(t.shape)}")
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{self.name}: stream {s!r} must be "
                                 f"contiguous on {x.device}")
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return out
        fn = self._bind()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), *(w[s].data_ptr() for s in self.streams),
                out.data_ptr(), m, k, n, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} "
                               f"({self._err(rc).decode()}) at launch with "
                               f"M={m} K={k} N={n}")
        self.launches += 1
        return out
