"""Launch surface of the port (port of repro.launch): meshes, the per-rank
dry-run of every (arch x shape x mesh) cell, and its report."""
