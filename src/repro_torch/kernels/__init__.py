"""Serve GEMMs of the port: packed layouts, plain versions and the
hand-written CUDA kernels (built from ``csrc`` at first use)."""
