"""Forward flash attention on Hopper (port of the reference's
``repro/kernels/flash_attention.py``).

``flash_attention_kernel`` is the entry point, named after the reference's:
q (BH, Sq, hd), k/v (BH, Skv, hd), positions pos_q (BH, Sq) / pos_k
(BH, Skv) int32 with ``pos_k = -1`` an invalid key, causal and
sliding-window masking, an optional tanh softcap -> f32 (BH, Sq, hd).
A CUDA tensor launches ``KERNEL`` (hand-written CUDA C++ for ``sm_90a``,
``csrc/flash_attention.cu``) or raises; a CPU tensor runs the plain version
``repro_torch.kernels.ref.flash_attention_ref``. Both run the reference's
online-softmax recurrence over KV blocks of ``block_k`` keys, which fixes
where the probabilities are rounded to bf16, so they take the same
``block_k``. Unlike the reference it takes any Sq and Skv (the reference
drops tail rows); the query block ``bq`` and ``interpret`` have no
counterpart.

``KERNEL.launches`` counts the launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import Binding, check_cuda

__all__ = ["KERNEL", "MAX_HEAD_DIM", "MAX_BLOCK_K", "flash_attention_kernel"]

MAX_HEAD_DIM = 256
MAX_BLOCK_K = 1024


class FlashKernel(Binding):
    """``int flash_attention(q, k, v, pos_q, pos_k, o, is_f32, BH, Sq, Skv,
    hd, block_k, scale, use_softcap, softcap, window, stream)``."""

    def __init__(self):
        c_int, c_float = ctypes.c_int, ctypes.c_float
        super().__init__("flash_attention",
                         [ctypes.c_void_p] * 6 + [c_int] * 6
                         + [c_float, c_int, c_float, c_int])

    def __call__(self, q, k, v, pos_q, pos_k, *, softcap, window: int,
                 block_k: int) -> torch.Tensor:
        name = self.name
        check_cuda(name, "q", q, (torch.bfloat16, torch.float32), 3)
        for what, t in (("k", k), ("v", v)):
            check_cuda(name, what, t, (q.dtype,), 3)
        for what, t in (("pos_q", pos_q), ("pos_k", pos_k)):
            check_cuda(name, what, t, (torch.int32,), 2)
        bh, sq, hd = q.shape
        skv = k.shape[1]
        if (k.shape != (bh, skv, hd) or v.shape != k.shape
                or pos_q.shape != (bh, sq) or pos_k.shape != (bh, skv)):
            raise ValueError(
                f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)}, pos_q {tuple(pos_q.shape)}, pos_k "
                f"{tuple(pos_k.shape)} do not fit (BH, Sq, hd), (BH, Skv, hd)")
        if any(t.device != q.device for t in (k, v, pos_q, pos_k)):
            raise ValueError(f"{name}: operands must lie on one device")
        if not 1 <= hd <= MAX_HEAD_DIM:
            raise ValueError(f"{name}: head dim {hd} outside 1..{MAX_HEAD_DIM}")
        if not 1 <= block_k <= MAX_BLOCK_K:
            raise ValueError(f"{name}: block_k {block_k} outside "
                             f"1..{MAX_BLOCK_K}")
        if bh > 65535:
            raise ValueError(f"{name}: BH={bh} exceeds 65535 heads")
        out = torch.empty((bh, sq, hd), dtype=torch.float32, device=q.device)
        if bh == 0 or sq == 0:
            return out
        window = min(int(window), 2 ** 31 - 1)
        self.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    pos_q.data_ptr(), pos_k.data_ptr(), out.data_ptr(),
                    int(q.dtype == torch.float32), bh, sq, skv, hd, block_k,
                    hd ** -0.5, int(softcap is not None),
                    0.0 if softcap is None else softcap, window,
                    where=f"BH={bh} Sq={sq} Skv={skv} hd={hd} "
                          f"block_k={block_k}")
        return out


KERNEL = FlashKernel()


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos_q: torch.Tensor, pos_k: torch.Tensor, *,
                           softcap: float | None = None,
                           window: int = 1 << 30,
                           block_k: int = ref.FLASH_BLOCK_K) -> torch.Tensor:
    """Forward attention -> f32 (BH, Sq, hd); see the module docstring."""
    if q.is_cuda:
        return KERNEL(q, k, v, pos_q, pos_k, softcap=softcap, window=window,
                      block_k=block_k)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, pos_q, pos_k, softcap=softcap,
                                       window=window, block_k=block_k)
    raise ValueError(f"no flash attention for device {q.device}")
