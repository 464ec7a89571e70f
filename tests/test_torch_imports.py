"""The port stands alone: nothing under ``src/repro_torch/``, nothing in
``chip_smoke.py`` and nothing in ``examples/train_lm_torch.py`` imports JAX, the reference package ``repro`` or
``ml_dtypes`` (the card's machine has none of them; bf16 checkpoint leaves
restore by bit view)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "train_lm_torch.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_port_module_is_scanned():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in FILES if "repro_torch" in p.parts}
    assert {"serve/engine.py", "kernels/ops.py", "core/codecs.py",
            "convert.py", "models/model.py", "kernels/m2xfp_quantize.py",
            "kernels/m2xfp_matmul.py", "kernels/flash_attention.py",
            "models/kvquant.py", "checkpoint/checkpoint.py",
            "serve/prequant.py", "serve/guard.py", "testing/faults.py",
            "testing/__init__.py", "data/pipeline.py",
            "distributed/straggler.py", "train/optimizer.py",
            "train/compression.py", "train/trainer.py"} <= names
