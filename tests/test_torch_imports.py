"""Import hygiene: the port never imports jax."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "webgraph_tpu_torch"
ROOT = PKG.parent


def _jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            if nm == "jax" or nm.startswith("jax."):
                yield f"{path.name}:{node.lineno} {nm}"
            if nm.startswith(("webgraph_tpu.ops.kdecode",
                              "webgraph_tpu.ops.kcompact",
                              "webgraph_tpu.algo")):
                yield f"{path.name}:{node.lineno} {nm}"


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    bad = [hit for f in files for hit in _jax_imports(f)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "pre = 'jax' in sys.modules\n"
        "import webgraph_tpu_torch, webgraph_tpu_torch.state\n"
        "from webgraph_tpu_torch.ops import (_build, bitstream, csr, "
        "kcompact, kdecode, kplan, resolve)\n"
        "from webgraph_tpu_torch.algo import hyperball\n"
        "import importlib, pkgutil, webgraph_tpu_torch.experiments as ex\n"
        "mods = [m.name for m in pkgutil.iter_modules(ex.__path__)]\n"
        "assert sum(m.startswith('probe') for m in mods) == 17, mods\n"
        "for m in mods:\n"
        "    importlib.import_module('webgraph_tpu_torch.experiments.' + m)\n"
        "print('PRE' if pre else ('JAX' if 'jax' in sys.modules else 'OK'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if out.stdout.strip() == "PRE":
        pytest.skip("this interpreter loads jax at start-up")
    assert out.stdout.strip() == "OK"
