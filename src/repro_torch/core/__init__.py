"""Format cores of the port: grids, E8M0 and E4M3 scales, the MX-family
formats (MXFP4, NVFP4, SMX4, FP4), the M2XFP and M2-NVFP4 encoders, EBW
accounting and the codec registry."""
