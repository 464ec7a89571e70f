"""The port's static analysis, ``repro_torch.analysis.lint`` (the
counterpart of ``repro.analysis.lint``), against the reference's.

The reference's lint needs no JAX: it is imported here, in this process,
and run on the same fixtures as the port's. The directly ported rules
(env-hygiene, codec-contract, bare-except, mutable-default, missing-all)
give the reference's (rule, line, message) sets, a missing-all fixture at
the port's path (``src/repro_torch/...``) where the reference's sits at
its own, and env-hygiene's message naming the port's flag module. The
port's counterparts (kernel-contract over the CUDA launch wrappers,
host-sync for the reference's tracer-leak) have fixtures that hit, that
are suppressed and that are clean. Then the baseline, the command line's
exit codes, ``--list-env`` and the live tree.
"""
import importlib.util
import json
import os
import re
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint
from repro_torch.analysis.lint import rules_codec, rules_kernel

ROOT = Path(__file__).resolve().parents[1]
REF_ENV, PORT_ENV = "repro.core.envflags", "repro_torch.core.envflags"
# the reference's flags with no counterpart (core/envflags.py says why)
NO_COUNTERPART = {"REPRO_SERVE_KERNEL", "REPRO_FAITHFUL_DOTS"}

# (rule, fixture source, the path it is linted at)
DIRECT = [
    ("env-hygiene", """import os
a = os.environ.get("REPRO_OBS")
b = os.getenv("REPRO_KV_QUANT", "none")
c = os.environ["REPRO_MOE_GROUP"]
d = "REPRO_OBS_DIR" in os.environ
os.environ["REPRO_OBS"] = "1"
e = os.environ.get("HOME")
f = os.environ.get("REPRO_X")  # reprolint: disable=env-hygiene -- test
""", "pkg/mod.py"),
    ("codec-contract", """from x import Codec
Codec(name="a", group=32, ebw=4.25, fake_quant_weight=f,
      fake_quant_act=f)
Codec(name="b", group=24, ebw=4.5, fake_quant_weight=f,
      fake_quant_act=f, encode=e, kernel=k, scale_kind="e9")
Codec(name="c", group=32, ebw=4.5, fake_quant_act=f,
      encode=e, decode=d, scale_kind="e8m0", scale_sat_bounds=(0, 255))
Codec(name="d", group=32, ebw=4.5, fake_quant_weight=f,
      fake_quant_act=f, encode=e, decode=d, kv_encode=k,
      scale_kind="e8m0")
Codec(name="e", group=16, ebw=4.75, fake_quant_weight=f,
      fake_quant_act=f, has_meta=True)
Codec(name="f", group=32, ebw=4.5, fake_quant_weight=f,
      fake_quant_act=f, has_meta=True)
""", "pkg/codecs.py"),
    ("bare-except", """try:
    pass
except:
    pass
try:
    pass
except Exception:
    pass
try:
    pass
except:  # reprolint: disable=bare-except -- test
    pass
""", "pkg/mod.py"),
    ("mutable-default", """def f(a=[], b={}, c=set(), d=None, *, e=dict()):
    pass
g = lambda x=[]: x
def h(a=(), b=0, c="x"):
    pass
""", "pkg/mod.py"),
    ("missing-all", """from .a import b, c
from .d import _e
def f():
    pass
""", "{pkg}/sub/__init__.py"),
    ("missing-all", """from .a import b
__all__ = ["b"]
""", "{pkg}/sub/__init__.py"),
]


def _triples(violations, swap=None):
    out = set()
    for v in violations:
        msg = v.message if swap is None else v.message.replace(*swap)
        out.add((v.rule, v.line, msg))
    return out


@pytest.mark.parametrize("case", range(len(DIRECT)))
def test_direct_rules_equal_reference(case):
    """A directly ported rule gives the reference's (rule, line, message)
    set on the same fixture (a missing-all fixture at each package's own
    path); none is empty, and an unflagged line stays unflagged."""
    rule, source, path = DIRECT[case]
    got = lint.lint_source(source, path.format(pkg="src/repro_torch"),
                           only=[rule])
    want = ref_lint.lint_source(source, path.format(pkg="src/repro"),
                                only=[rule])
    swap = (REF_ENV, PORT_ENV) if rule == "env-hygiene" else None
    assert _triples(got) == _triples(want, swap)
    if "__all__" not in source:
        assert got


def test_missing_all_scopes_each_package():
    """The port's missing-all reads ``src/repro_torch`` package inits only,
    the reference's ``src/repro`` ones only."""
    source = DIRECT[4][1]
    assert not lint.lint_source(source, "src/repro/sub/__init__.py",
                                only=["missing-all"])
    assert not ref_lint.lint_source(source, "src/repro_torch/sub/__init__.py",
                                    only=["missing-all"])


def test_codec_rule_resolves_splats_and_port_constants():
    """A ``**name`` splat of a module-level dict counts as given (the
    port's ``_SGEM``); the packing constants are the port's."""
    src = """SG = dict(encode=e, decode=d, scale_kind="e8m0",
          scale_sat_bounds=(1, 254), has_meta=True)
Codec(name="m", group=32, ebw=4.5, fake_quant_weight=f,
      fake_quant_act=f, **SG)
BAD = {"encode": e, "scale_kind": "e8m0"}
Codec(name="n", group=32, ebw=4.5, fake_quant_weight=f,
      fake_quant_act=f, **BAD)
"""
    got = lint.lint_source(src, "src/repro_torch/core/codecs.py",
                           only=["codec-contract"])
    assert {v.line for v in got} == {6}
    assert any("encode given without decode" in v.message for v in got)
    from repro_torch.kernels import layout
    assert rules_codec.SUBGROUP == layout.SUBGROUP
    assert layout.GROUP in rules_codec._GROUPS and 16 in rules_codec._GROUPS


# kernel-contract ------------------------------------------------------------

WRAPPER = """class K(Binding):
    def __init__(self):
        super().__init__("nosuchkernel", [])

    def __call__(self, x, w):
        m, k = x.shape
        {guard}
        rows = k // 32{suppress}
        self.launch(x.device, x.data_ptr(), m, rows, where="")
"""


@pytest.mark.parametrize("guard,suppress,hits", [
    ("pass", "", 1),
    ("pass", "  # reprolint: disable=kernel-contract -- test", 0),
    ("check_k(self.name, k)", "", 0),
    ("if k % 32:\n            raise ValueError(k)", "", 0),
    ("if k % 32:\n            print(k)", "", 1),       # checks, no raise
    ("assert k % 32 == 0", "", 0),
])
def test_kernel_contract_launch_wrappers(guard, suppress, hits):
    """A launch wrapper sizing with plain floordiv needs a remainder check
    that raises (or asserts), or ``check_k``; a ceil-div is fine."""
    src = WRAPPER.format(guard=guard, suppress=suppress)
    got = lint.lint_source(src, "src/repro_torch/kernels/fake.py",
                           only=["kernel-contract"])
    assert len(got) == hits, got
    ceil = WRAPPER.format(guard="pass", suppress="").replace(
        "k // 32", "-(-k // 32)")
    assert not lint.lint_source(ceil, "src/repro_torch/kernels/fake.py",
                                only=["kernel-contract"])
    # outside src/repro_torch/kernels the rule has no subject
    assert not lint.lint_source(src, "src/repro_torch/models/fake.py",
                                only=["kernel-contract"])


GOOD_CU = """int launch(int M, int N) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBlockN - 1) / kBlockN, 1, (M + 63) / 64);
  cfg.blockDim = dim3(kThreads);
  const int tiles = (M + TM - 1) / TM;
  k<<<tiles, 128, 0, st>>>(M);
}
"""


@pytest.mark.parametrize("cu,hits", [
    (GOOD_CU, 0),
    (GOOD_CU.replace("  cfg.blockDim = dim3(kThreads);\n", ""), 1),
    (GOOD_CU.replace("(M + TM - 1) / TM", "M / TM"), 1),
    (GOOD_CU.replace("(M + 63) / 64", "M / 64"), 1),
    (GOOD_CU.replace("(M + 63) / 64", "(M + 62) / 64"), 1),
], ids=["clean", "no_block", "floor_launch_arg", "floor_grid_dim",
        "not_ceil"])
def test_kernel_contract_bound_source(monkeypatch, cu, hits):
    """The csrc source a wrapper binds sets grid and block of every launch
    config, and its grid expressions ceil-divide (the wrapper here guards
    no remainder)."""
    monkeypatch.setattr(rules_kernel, "_source_text",
                        lambda name: cu if name == "k1" else None)
    src = 'KERNEL = CudaKernel("k1", ("codes",))\n'
    got = lint.lint_source(src, "src/repro_torch/kernels/fake.py",
                           only=["kernel-contract"])
    assert len(got) == hits, got
    assert all(v.line == 1 and "csrc/k1.cu" in v.message for v in got)


def test_kernel_contract_reads_the_real_sources():
    """Every wrapper module of the port binds a source the rule reads
    (nothing skipped as missing), and the real sources pass."""
    names = {}
    for path in sorted((ROOT / "src" / "repro_torch" / "kernels")
                       .glob("*.py")):
        import ast
        for lit in rules_kernel._bound_sources(ast.parse(path.read_text())):
            names[lit.value] = rules_kernel._source_text(lit.value)
    assert set(names) == {"m2xfp_matmul", "m2xfp_qmatmul", "mxfp4_matmul",
                          "m2xfp_quantize", "flash_attention"}
    assert all(text and ("<<<" in text or "cudaLaunchKernelEx" in text)
               for text in names.values())


@pytest.mark.parametrize("expr,hits", [
    ("torch.matmul(p.to(bf16), v)", 1),
    ("torch.matmul(p.to(torch.bfloat16), v)", 1),
    ("p.half() @ v", 1),
    ("torch.einsum('ij,jk->ik', p, v.bfloat16())", 1),
    ("torch.matmul(p.to(bf16).to(f32), v)", 0),
    ("torch.matmul(p.to(torch.float64), v.double())", 0),
    ("torch.matmul(p.to(bf16), v)  # reprolint: disable=kernel-contract", 0),
])
def test_kernel_contract_plain_products(expr, hits):
    """A plain product in kernels/ref.py takes no bf16/f16 operand."""
    src = ("import torch\n\n\ndef plain(p, v):\n"
           "    f32, bf16 = torch.float32, torch.bfloat16\n"
           f"    return {expr}\n")
    got = lint.lint_source(src, "src/repro_torch/kernels/ref.py",
                           only=["kernel-contract"])
    assert len(got) == hits, got


# host-sync -----------------------------------------------------------------

SYNC = """import numpy as np
import torch


def step(x: torch.Tensor, n: int, cfg):
    y = torch.softmax(x, -1)
    z = y * 2
    {line}
    return z
"""


@pytest.mark.parametrize("line,hits", [
    ("a = z.item()", 1),
    ("a = z.sum().tolist()", 1),
    ("a = y.cpu().numpy()", 2),
    ("a = float(z.max())", 1),
    ("a = int(x)", 1),
    ("a = np.asarray(y)", 1),
    ("if (z > 0).any():\n        pass", 1),
    ("if torch.isnan(z).any():\n        pass", 1),
    ("while z.sum() > 1:\n        pass", 1),
    ("if z:\n        pass", 1),
    ("if n > 2 and not z:\n        pass", 1),
    ("a = z.item()  # reprolint: disable=host-sync -- a test", 0),
    ("a = int(x.shape[0]) + int(n) + len(x) + x.dim()", 0),
    ("if x.is_cuda and x.dtype == torch.bfloat16 and n > 2:\n        pass",
     0),
    ("if cfg.kv_quant == 'm2xfp' and x is not None:\n        pass", 0),
    ("a = float(cfg.scale) + bool(n)", 0),
    ("z = torch.where(z > 0, z, 0)", 0),
])
def test_host_sync_rule(line, hits):
    """host-sync in a models/ module: host reads of tensor values hit
    (once each, a ``.cpu().numpy()`` twice), a suppressed one does not,
    and metadata, config and host integers are clean."""
    src = SYNC.format(line=line)
    got = lint.lint_source(src, "src/repro_torch/models/fake.py",
                           only=["host-sync"])
    assert len(got) == hits, got


def test_host_sync_scope():
    """The rule reads models/, kernels/ops.py and ServeEngine's launch
    functions in serve/engine.py; elsewhere (the trainer, the engine's
    other methods) a sync is no finding."""
    src = SYNC.format(line="a = z.item()")
    for path, hits in (("src/repro_torch/kernels/ops.py", 1),
                       ("src/repro_torch/train/trainer.py", 0),
                       ("src/repro_torch/serve/guard.py", 0)):
        assert len(lint.lint_source(src, path, only=["host-sync"])) == hits
    engine = ("class ServeEngine:\n"
              "    def _fetch(self, rows):\n"
              "        return rows.cpu()\n"
              "    def guard_summary(self, t):\n"
              "        return t.cpu()\n")
    got = lint.lint_source(engine, "src/repro_torch/serve/engine.py",
                           only=["host-sync"])
    assert [v.line for v in got] == [3]


# the baseline and the command line -----------------------------------------

def _v(path="a.py", rule="bare-except", msg="m", line=1):
    return lint.Violation(rule, path, line, 1, msg)


def test_baseline_round_trip_counts_and_stale(tmp_path):
    """save/load round trip; an entry absorbs up to its count of the same
    identity (the rest are new); an entry with capacity left is stale."""
    path = str(tmp_path / "b.json")
    live = [_v(line=1), _v(line=9), _v(path="b.py")]
    entries = lint.save_baseline(path, live)
    assert lint.load_baseline(path) == entries
    assert {(e["path"], e["count"]) for e in entries} == {("a.py", 2),
                                                          ("b.py", 1)}
    new, stale = lint.diff_against_baseline(live, entries)
    assert new == [] and stale == []
    new, stale = lint.diff_against_baseline(live + [_v(line=20)], entries)
    assert [v.line for v in new] == [20] and stale == []
    new, stale = lint.diff_against_baseline([_v(line=1)], entries)
    assert new == [] and {e["path"] for e in stale} == {"a.py", "b.py"}
    (tmp_path / "bad.json").write_text(json.dumps({"version": 7}))
    with pytest.raises(ValueError, match="not a reprolint baseline"):
        lint.load_baseline(str(tmp_path / "bad.json"))


def test_cli_exit_codes(tmp_path, capsys):
    """0 clean, 1 a new violation (the text report names it) or, with
    --check-baseline, a stale entry, 2 an unknown rule; --json parses."""
    clean, dirty = tmp_path / "clean.py", tmp_path / "dirty.py"
    clean.write_text("x = 1\n")
    dirty.write_text("try:\n    pass\nexcept:\n    pass\n")
    base = str(tmp_path / "base.json")
    assert lint.main([str(clean), "--baseline", base]) == 0
    assert "reprolint: clean" in capsys.readouterr().out
    assert lint.main([str(dirty), "--baseline", base]) == 1
    assert "[bare-except]" in capsys.readouterr().out
    assert lint.main([str(dirty), "--baseline", base, "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["counts"] == {
        "bare-except": 1}
    assert lint.main([str(dirty), "--baseline", base,
                      "--update-baseline"]) == 0
    assert lint.main([str(dirty), "--baseline", base]) == 0
    assert lint.main([str(clean), "--baseline", base]) == 0
    assert lint.main([str(clean), "--baseline", base,
                      "--check-baseline"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    assert lint.main([str(clean), "--rule", "no-such-rule"]) == 2
    with pytest.raises(SystemExit) as e:
        lint.main(["--no-such-flag"])
    assert e.value.code == 2


def test_list_rules_and_env(capsys):
    """--list-rules lists the seven rules; --list-env renders the port's
    flag registry: the reference's flags but the two with no
    counterpart."""
    assert lint.main(["--list-rules"]) == 0
    rules = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
    assert rules == {"env-hygiene", "codec-contract", "kernel-contract",
                     "host-sync", "bare-except", "mutable-default",
                     "missing-all"}
    assert lint.main(["--list-env"]) == 0
    port = set(re.findall(r"^\| `(REPRO_\w+)`", capsys.readouterr().out,
                          re.M))
    spec = importlib.util.spec_from_file_location(
        "_reference_envflags", ROOT / "src" / "repro" / "core" /
        "envflags.py")
    ref_env = importlib.util.module_from_spec(spec)
    import sys
    sys.modules[spec.name] = ref_env
    spec.loader.exec_module(ref_env)
    ref = set(re.findall(r"^\| `(REPRO_\w+)`", ref_env.markdown_table(),
                         re.M))
    assert NO_COUNTERPART <= ref
    assert port == ref - NO_COUNTERPART


def test_live_tree_clean_modulo_baseline():
    """The port's default targets (src/repro_torch, chip_smoke.py, the
    port's example programs, scripts/recurrent_decode_ab.py) are clean
    modulo the port's baseline, which stays at most 5 entries; its
    examples are among the files linted."""
    root = lint.core.repo_root()
    assert os.path.samefile(root, ROOT)
    files = lint.core.iter_python_files(lint.DEFAULT_TARGETS, root)
    rel = {os.path.relpath(f, root) for f in files}
    assert {"chip_smoke.py", "examples/quickstart_torch.py",
            "examples/serve_quantized_torch.py", "examples/train_lm_torch.py",
            "scripts/recurrent_decode_ab.py",
            "src/repro_torch/serve/engine.py"} <= rel
    assert "examples/quickstart.py" not in rel
    entries = lint.load_baseline(lint.baseline_path(root))
    assert len(entries) <= 5, "baseline must stay small and justified"
    new, _ = lint.diff_against_baseline(lint.lint_paths(root=root), entries)
    assert new == [], "\n".join(v.format() for v in new)
