"""Import hygiene: the port imports neither jax nor the JAX package.

The port and ``chip_smoke.py`` keep their own copies of what they need of
``webgraph_tpu`` (host library, settings, synthetic generator, word
packer); only the tests import both packages."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "webgraph_tpu_torch"
ROOT = PKG.parent


def _banned_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        if isinstance(node, ast.ImportFrom) and node.level:
            continue   # relative: inside the port
        for nm in names:
            if nm.split(".")[0] in ("jax", "webgraph_tpu"):
                yield f"{path.name}:{node.lineno} {nm}"


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    bad = [hit for f in files for hit in _banned_imports(f)]
    assert not bad, bad


@pytest.mark.parametrize("src,bad", [
    ("import webgraph_tpu", True),
    ("from webgraph_tpu import native", True),
    ("from webgraph_tpu.utils.synth import synthesize_webgraph", True),
    ("import jax.numpy as jnp", True),
    ("import webgraph_tpu_torch.native", False),
    ("from .. import native", False),
    ("from webgraph_tpu_torch.settings import BVGraphSettings", False)])
def test_the_check_sees_every_form(tmp_path, src, bad):
    f = tmp_path / "m.py"
    f.write_text(src + "\n")
    assert bool(list(_banned_imports(f))) == bad


def test_build_reads_nothing_of_the_jax_package():
    from webgraph_tpu_torch.ops import _build
    assert _build._WGNATIVE_SRC.startswith(str(PKG) + os.sep)
    assert os.path.exists(_build._WGNATIVE_SRC)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "pre = 'jax' in sys.modules or 'webgraph_tpu' in sys.modules\n"
        "import webgraph_tpu_torch, webgraph_tpu_torch.state\n"
        "from webgraph_tpu_torch.ops import (_build, bitio, bitstream, csr, "
        "ef_index, efdecode, kcompact, kdecode, kplan, labelcodec, longword, "
        "resolve, vencode)\n"
        "from webgraph_tpu_torch.labelling import graph, labels, triples\n"
        "from webgraph_tpu_torch.codecs import bvgraph, efgraph\n"
        "from webgraph_tpu_torch.utils import properties\n"
        "from webgraph_tpu_torch.algo import (bfs, cc, centrality, "
        "hyperball, scc)\n"
        "from webgraph_tpu_torch import algo, transform\n"
        "from webgraph_tpu_torch.transform import labelled, offline\n"
        "from webgraph_tpu_torch.core import graph\n"
        "from webgraph_tpu_torch.utils import stats\n"
        "from webgraph_tpu_torch import native, settings\n"
        "from webgraph_tpu_torch.utils import synth\n"
        "from webgraph_tpu_torch.tools import b1_sweep, b2_sweep\n"
        "from webgraph_tpu_torch.codecs import ascii, intlist, scattered\n"
        "from webgraph_tpu_torch.core import incremental, wrap, wrappers\n"
        "from webgraph_tpu_torch.utils import hostmap, progress\n"
        "from webgraph_tpu_torch.ops import bigdecode\n"
        "import webgraph_tpu_torch.typed, webgraph_tpu_torch.cli\n"
        "import webgraph_tpu_torch.cli.main\n"
        "import chip_smoke\n"
        "import importlib, pkgutil, webgraph_tpu_torch.experiments as ex\n"
        "mods = [m.name for m in pkgutil.iter_modules(ex.__path__)]\n"
        "assert sum(m.startswith('probe') for m in mods) == 17, mods\n"
        "for m in mods:\n"
        "    importlib.import_module('webgraph_tpu_torch.experiments.' + m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'webgraph_tpu'))\n"
        "print('PRE' if pre else (bad[:5] if bad else 'OK'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if out.stdout.strip() == "PRE":
        pytest.skip("this interpreter loads jax at start-up")
    assert out.stdout.strip() == "OK"


# the modules ported in the ninth slice: the host layer and the CLI, each
# with the JAX module's path and public names
HOST_LAYER = ("cli", "cli.main", "codecs.ascii", "codecs.intlist",
              "codecs.scattered", "core.incremental", "core.wrap",
              "core.wrappers", "typed", "utils.hostmap", "utils.progress",
              "ops.bigdecode")


@pytest.mark.parametrize("mod", HOST_LAYER)
def test_host_layer_module_mirrors_the_jax_one(mod):
    import importlib
    port = importlib.import_module("webgraph_tpu_torch." + mod)
    ref = importlib.import_module("webgraph_tpu." + mod)
    assert sorted(getattr(port, "__all__", [])) == sorted(
        getattr(ref, "__all__", []))
    for name in getattr(ref, "__all__", []):
        assert hasattr(port, name), name


def test_dunder_main_exists():
    assert (PKG / "__main__.py").exists()
    assert "from .cli import main" in (PKG / "__main__.py").read_text()
