"""Format cores of the port: grids, E8M0 scales, M2XFP and MXFP4
encoders, and the codec registry."""
