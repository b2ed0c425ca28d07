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
        "from webgraph_tpu_torch.parallel import multihost, sharded\n"
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
# the modules ported in the tenth slice: multi-host and multi-device
PARALLEL = ("parallel", "parallel.multihost", "parallel.sharded")


@pytest.mark.parametrize("mod", HOST_LAYER + PARALLEL)
def test_host_layer_module_mirrors_the_jax_one(mod):
    import importlib
    port = importlib.import_module("webgraph_tpu_torch." + mod)
    ref = importlib.import_module("webgraph_tpu." + mod)
    assert sorted(getattr(port, "__all__", [])) == sorted(
        getattr(ref, "__all__", []))
    for name in getattr(ref, "__all__", []):
        assert hasattr(port, name), name


# every module of the JAX package, by its dotted path below the package,
# found on disk; those the port leaves out, with the reason (ROADMAP A12)
JAX_PKG = ROOT / "webgraph_tpu"
NOT_PORTED = {
    "__main__": "runs the CLI when imported; test_dunder_main_exists",
    "native": "the port builds its own host library (webgraph_tpu_torch/"
              "native, held to the original by test_torch_native.py)",
    "ops.vdecode": "struck: an XLA decoder that B1 supersedes",
    "ops.vdecode2": "struck: an XLA decoder that B1 supersedes",
    "ops.vparse2": "struck: an XLA decoder that B1 supersedes",
    "ops.packed": "moved: ops.bitstream.pack_words_u32 and "
                  "native.decode_offset_stream",
}


def _jax_modules():
    out = []
    for f in sorted(JAX_PKG.rglob("*.py")):
        parts = list(f.relative_to(JAX_PKG).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


ALL_MODULES = [m for m in _jax_modules() if m not in NOT_PORTED]


def test_every_jax_module_is_ported_or_struck():
    mods = _jax_modules()
    assert len(mods) > 40
    assert set(NOT_PORTED) <= set(mods)
    assert len(ALL_MODULES) == len(mods) - len(NOT_PORTED)


@pytest.mark.parametrize("mod", ALL_MODULES)
def test_every_ported_module_has_the_jax_names(mod):
    """The port's module at the JAX module's path exists and holds every
    name of the JAX ``__all__`` (a subset: the port adds names such as
    ``load_csr`` and ``device_round``)."""
    import importlib
    port = importlib.import_module("webgraph_tpu_torch" + (
        "." + mod if mod else ""))
    ref = importlib.import_module("webgraph_tpu" + ("." + mod if mod else ""))
    missing = [n for n in getattr(ref, "__all__", []) if not hasattr(port, n)]
    assert not missing, missing


def test_compression_flags_importable_from_the_bvgraph_path():
    from webgraph_tpu_torch import settings
    from webgraph_tpu_torch.codecs.bvgraph import CompressionFlags
    assert CompressionFlags is settings.CompressionFlags
    from webgraph_tpu.codecs.bvgraph import CompressionFlags as J
    for name in ("GAMMA", "DELTA", "ZETA", "NIBBLE", "UNARY"):
        assert getattr(CompressionFlags, name) == getattr(J, name)


# the JAX kdecode driver's public names (the module has no __all__): where
# each lives in the port, or None where ROADMAP A12 struck it
KDECODE_NAMES = {
    "PreparedDecode": "ops.kdecode.LanePlan",
    "plan_kernel_decode": "ops.kplan.plan_kernel_decode",
    "resolve_halos": "ops.resolve.resolve_halos",
    "decode_full": "ops.resolve.resolve_halos",     # then decode_to_csr
    "chunked_to_csr": "ops.csr.decode_to_csr",
    "decode_to_csr": "ops.csr.decode_to_csr",
    "fill_lanes": "ops.csr.fill_lanes",
    "hub_fallback_nodes": "ops.kdecode.check_diag",  # then fill_lanes
    "plan_csr_index": "ops.csr.plan_csr_index",
    "fill_csr_device": "ops.csr.fill_csr_device",
    "HubPlan": None,         # lanes are sized exactly: no hub split
    "assemble_hubs": None,
    "finalize_hub": None,
}


@pytest.mark.parametrize("name", sorted(KDECODE_NAMES))
def test_kdecode_driver_names_are_placed(name):
    import importlib
    assert hasattr(importlib.import_module("webgraph_tpu.ops.kdecode"), name)
    where = KDECODE_NAMES[name]
    if where is None:
        assert not hasattr(importlib.import_module(
            "webgraph_tpu_torch.ops.kdecode"), name)
        return
    mod, attr = where.rsplit(".", 1)
    assert hasattr(importlib.import_module("webgraph_tpu_torch." + mod),
                   attr), where


def test_dunder_main_exists():
    assert (PKG / "__main__.py").exists()
    assert "from .cli import main" in (PKG / "__main__.py").read_text()
