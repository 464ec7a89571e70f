"""The §Dry-run and §Roofline tables from the port's dry-run JSONs (port of
repro.launch.report).

    PYTHONPATH=src python -m repro_torch.launch.report

§Dry-run: one row per arch x applicable shape, OK/FAIL and the bytes per
rank on the 256- and 512-rank meshes (parameters, optimizer state,
caches, inputs). §Roofline: per cell on the 256-rank mesh, the compute,
memory and collective times of the counted step on H100s
(``analysis/step_cost.py``, ``analysis/roofline.py``), the dominant term,
MODEL_FLOPS and the shares the reference's table gives. The reference's
peak bytes per device come from XLA's memory analysis, which the port
does not have.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.launch.dryrun import DRYRUN_ARCHS, RESULTS_DIR


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


def _fmt_s(x: float) -> str:
    return f"{x:.2f}s" if x >= 1 else f"{x * 1e3:.3g}ms"


def roofline_table(cells: dict) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful ratio | roofline frac | count s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in DRYRUN_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape not in applicable_shapes(cfg):
                lines.append(f"| {arch} | {shape} |" + " — |" * 7
                             + " skipped: full-attention arch at 500k |")
                continue
            r = cells.get((arch, shape))
            if r is None or not r.get("ok") or "roofline" not in r:
                err = (r or {}).get("error", "missing")
                lines.append(f"| {arch} | {shape} | FAILED: {err[:60]} |"
                             + " — |" * 7)
                continue
            rt = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {_fmt_s(rt['compute_s'])} | "
                f"{_fmt_s(rt['memory_s'])} | {_fmt_s(rt['collective_s'])} | "
                f"**{rt['dominant']}** | {rt['model_flops']:.2e} | "
                f"{rt['useful_ratio']:.3f} | {rt['roofline_fraction']:.4f} | "
                f"{r['step_cost']['seconds']:.1f} |")
    return "\n".join(lines)


def main():
    print("## §Dry-run (bytes per rank on the meta device, 16x16 and "
          "2x16x16 logical meshes)\n")
    print(dryrun_table(load("pod256"), load("pod512")))
    print("\n## §Roofline (single pod, 256 H100s: analysis/roofline.py's "
          "constants)\n")
    print(roofline_table(load("pod256")))


if __name__ == "__main__":
    main()
