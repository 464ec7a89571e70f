"""The §Dry-run table from the port's dry-run JSONs (port of
repro.launch.report).

    PYTHONPATH=src python -m repro_torch.launch.report

One row per arch x applicable shape: OK/FAIL and the bytes per rank on the
256- and 512-rank meshes (parameters, optimizer state, caches, inputs).
There is no §Roofline table: its compute, memory and collective times come
from XLA's compiled HLO (``analysis/hlo.py``, ``analysis/roofline.py``),
which the port does not have; the port's roofline is ROADMAP A3.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable_shapes
from repro_torch.launch.dryrun import DRYRUN_ARCHS, RESULTS_DIR

NO_ROOFLINE = ("No §Roofline table: its times come from XLA's compiled HLO "
               "(analysis/hlo.py, analysis/roofline.py), which the port does "
               "not have; the port's roofline is ROADMAP A3.")


def load(mesh: str, directory: str = RESULTS_DIR) -> dict:
    out = {}
    for f in glob.glob(os.path.join(directory, mesh, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"])] = r
    return out


def _gib(r: dict, part: str) -> str:
    if not (r and r.get("ok")):
        return "-"
    return f"{r['bytes_per_rank'][part] / 2 ** 30:.3f}"


def dryrun_table(cells256: dict, cells512: dict) -> str:
    lines = [
        "| arch | shape | pod256 | pod512 | params GiB/rank 256 / 512 | "
        "opt state 256 / 512 | caches 256 / 512 | inputs 256 / 512 | "
        "total 256 / 512 |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    n_ok = 0
    for arch in DRYRUN_ARCHS:
        for shape in applicable_shapes(get_config(arch)):
            a, b = cells256.get((arch, shape)), cells512.get((arch, shape))
            ok = ["OK" if r and r.get("ok") else "FAIL" for r in (a, b)]
            n_ok += ok.count("OK")
            parts = " | ".join(f"{_gib(a, p)} / {_gib(b, p)}" for p in
                               ("params", "opt_state", "caches", "inputs",
                                "total"))
            lines.append(f"| {arch} | {shape} | {ok[0]} | {ok[1]} | "
                         f"{parts} |")
    lines.append(f"\n{n_ok} cells passed.")
    return "\n".join(lines)


def main():
    print("## §Dry-run (bytes per rank on the meta device, 16x16 and "
          "2x16x16 logical meshes)\n")
    print(dryrun_table(load("pod256"), load("pod512")))
    print("\n" + NO_ROOFLINE)


if __name__ == "__main__":
    main()
