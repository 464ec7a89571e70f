"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

The module tree mirrors ``src/repro/`` (``core``, ``kernels``, ``models``,
``serve``, ``checkpoint``, ``configs``); ``csrc`` holds the hand-written CUDA kernels. The
package imports ``torch`` and never JAX or ``repro``. Entry points take an
explicit ``device`` and default to ``"cuda"``.
"""
