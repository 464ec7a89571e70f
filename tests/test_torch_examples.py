"""The port's example programs ``examples/quickstart_torch.py`` and
``examples/serve_quantized_torch.py`` (the twins of the reference's
``quickstart.py`` and ``serve_quantized.py``): each one's ``main`` on
``--device cpu`` at a tiny size within BUDGET_S, where every kernel call
runs its plain version; on the card chip_smoke's ``examples`` line runs
both on the CUDA kernels."""
import importlib.util
import math
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BUDGET_S = 10.0
SERVE_ARGS = ["--device", "cpu", "--tokens", "4", "--requests", "3",
              "--slots", "2", "--d-model", "64", "--layers", "1",
              "--prompt-len", "8"]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def test_quickstart_on_cpu(capsys):
    """The MSE table of the five formats (m2xfp's weight and activation
    codecs below MXFP4's, SMX4's the largest), the packed layout at 4.50
    bits/elem, the four DSE strategies at EBW 4.5, and the two kernels'
    plain versions: the dequant-GEMM's (32, 128) f32 output equal to
    itself held as the card's is (0 of the tolerance), the quantize
    engine's K-major streams."""
    out, dt = _timed(_example("quickstart_torch").main,
                     ["--device", "cpu", "--rows", "32"])
    assert dt <= BUDGET_S, dt
    text = capsys.readouterr().out
    assert "= 4.50 bits/elem" in text
    assert out["bits_per_elem"] == 4.5
    mse = out["mse"]
    assert all(math.isfinite(v) and v > 0 for v in mse.values())
    assert max(mse, key=mse.get).startswith("smx4")
    assert mse["m2xfp-W (EBW 4.50)"] < mse["mxfp4   (EBW 4.25)"]
    assert mse["m2xfp-A (EBW 4.50)"] < mse["mxfp4   (EBW 4.25)"]
    assert {s: e for s, (e, _) in out["dse"].items()} == {
        "elem_em_top1": 4.5, "sg_em_2bit": 4.5, "sg_em_2bit_adaptive": 4.5,
        "sg_ee_2bit": 4.5}
    # the adaptive Sg-EM strategy is the m2xfp weight codec
    assert out["dse"]["sg_em_2bit_adaptive"][1] == mse["m2xfp-W (EBW 4.50)"]
    assert out["gemm"] == {"max_abs_err": 0.0, "max_ratio_to_tolerance": 0.0,
                           "shape": (32, 128)}
    assert out["quantize_shapes"] == {"codes": (256, 32),
                                      "scales": (16, 32), "meta": (16, 32)}


@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4"])
def test_serve_quantized_on_cpu(capsys, fmt):
    """Prequantize, round-trip the packed checkpoint and serve: fewer MiB
    packed than bf16, every request's tokens, a tok/s line, and the tokens
    of an engine on the packed weights themselves (the checkpoint changed
    no byte the engine reads)."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine, prequantize_params
    mod = _example("serve_quantized_torch")
    out, dt = _timed(mod.main, SERVE_ARGS + ["--fmt", fmt])
    assert dt <= BUDGET_S, dt
    text = capsys.readouterr().out
    assert f"MiB packed {fmt}" in text and "tok/s on cpu" in text
    assert out["packed_mib"] < out["bf16_mib"]
    assert [len(o) for o in out["outputs"]] == [4, 4, 4]
    cfg = ModelConfig(name="serve-lm", family="dense", n_layers=1,
                      d_model=64, n_heads=2, n_kv_heads=1, d_ff=192,
                      vocab_size=4096, remat=False, quant="serve",
                      quant_format=fmt)
    packed = prequantize_params(init_params(
        torch.Generator("cpu").manual_seed(0), cfg, "cpu"), cfg)
    import numpy as np
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in rng.integers(4, 9, 3)]
    eng = ServeEngine(packed, cfg, n_slots=2, max_len=12, device="cpu")
    assert eng.generate(prompts, max_new_tokens=4) == out["outputs"]


def test_examples_refuse_a_missing_card():
    """``--device cuda`` (the default) where no CUDA device is present
    raises, naming ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name, argv in (("quickstart_torch", []),
                       ("serve_quantized_torch", SERVE_ARGS[2:])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            _example(name).main(argv)
