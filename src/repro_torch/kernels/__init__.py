"""Kernels of the port: packed layouts, plain versions and the hand-written
CUDA kernels (built from ``csrc`` at first use). Layout helpers, constants
and the public entry points are exported as ``repro.kernels`` exports them;
flash attention has its own module, ``kernels.flash_attention``."""
from .layout import (  # noqa: F401
    GROUP, N_SUB, SUBGROUP, interleave_pack, interleave_unpack, pack_w_mxfp4,
    pack_w_nvfp4, pack_w_sgem, pack_x_elem_em,
)
from .ops import (  # noqa: F401
    m2xfp_matmul, m2xfp_qmatmul, m2xfp_quantize, mxfp4_matmul,
)

__all__ = [
    "GROUP", "N_SUB", "SUBGROUP", "interleave_pack", "interleave_unpack",
    "m2xfp_matmul", "m2xfp_qmatmul", "m2xfp_quantize", "mxfp4_matmul",
    "pack_w_mxfp4", "pack_w_nvfp4", "pack_w_sgem", "pack_x_elem_em",
]
