"""The port stands alone: nothing under ``src/repro_torch/``, nothing in
``chip_smoke.py`` and nothing in the port's example programs
(``examples/*_torch.py``) imports JAX, the reference package ``repro`` or
``ml_dtypes`` (the card's machine has none of them; bf16 checkpoint leaves
restore by bit view), and none of them reads a ``REPRO_*`` flag through
``os.environ`` but ``repro_torch.core.envflags``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "train_lm_torch.py",
     ROOT / "examples" / "quickstart_torch.py",
     ROOT / "examples" / "serve_quantized_torch.py"]


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
            "train/compression.py", "train/trainer.py", "core/envflags.py",
            "core/dse.py", "obs/__init__.py", "obs/registry.py",
            "obs/tracing.py", "obs/quant_health.py", "models/xlstm.py",
            "models/mamba2.py", "configs/xlstm_125m.py",
            "configs/zamba2_7b.py", "analysis/lint/core.py",
            "analysis/lint/rules_torch.py", "analysis/lint/cli.py"} <= names


def _environ_reads(path: Path) -> list:
    """``REPRO_*`` names read through ``os.environ`` or ``os.getenv``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        target = None
        if isinstance(node, ast.Subscript):
            target, args = node.value, [node.slice]
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            target, args = node.func.value, node.args[:1]
            if node.func.attr == "getenv":
                target = ast.Attribute(value=target, attr="environ")
        if isinstance(target, ast.Attribute) and target.attr == "environ":
            found += [a.value for a in args if isinstance(a, ast.Constant)
                      and str(a.value).startswith("REPRO_")]
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_flags_read_through_envflags(path):
    """No ``REPRO_*`` flag is read by name through ``os.environ``: the port
    reads its flags through ``core/envflags.py``'s accessors."""
    assert _environ_reads(path) == [], path.relative_to(ROOT)


def test_environ_reads_are_found():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        probe = Path(d) / "probe.py"
        probe.write_text('import os\nos.environ.get("REPRO_OBS")\n'
                         'os.environ["REPRO_OBS_DIR"]\nos.getenv("REPRO_X")\n')
        assert _environ_reads(probe) == ["REPRO_OBS", "REPRO_OBS_DIR",
                                         "REPRO_X"]
