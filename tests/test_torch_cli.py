"""The port's command line against the JAX package's.

Every subcommand and every ``transform`` verb runs through
``webgraph_tpu_torch.cli.main([..., "--device", "cpu"])`` beside
``webgraph_tpu.cli.main([...])`` on copies of the same basenames, each in
its own directory.  The printed lines must be equal (HyperBall's
neighbourhood function to ``rtol=1e-12``; speedtest's timings by format),
and so must every file the two write: bytes equal, ``.properties`` bar its
date line, the harmonic sums to ``rtol=1e-12``.  Without ``--device`` a
command runs on the GPU and raises where there is none; ``--help`` loads
neither jax nor the JAX package, and builds nothing.
"""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from webgraph_tpu import transform as JT
from webgraph_tpu.cli import main as jmain
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.codecs.bvgraph import CompressionFlags as JC
from webgraph_tpu_torch.cli import main as pmain

from .graphs import erdos_renyi
from .torch_file_cases import props_lines

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def srcdir(tmp_path_factory):
    """The module's basenames, written once by the JAX package: ``g`` (a
    directed graph with loops), ``sym`` (its symmetrization), ``other`` (a
    second graph for union/compose), ``golomb`` (residuals outside the
    decode kernel's envelope), plus an arc list with ids out of order, a
    node map and a ``.graph-txt``."""
    d = tmp_path_factory.mktemp("cli_src")
    g = erdos_renyi(150, 0.06, seed=2, loops=True)
    JBV.store(g, str(d / "g"))
    JBV.store(JT.symmetrize(g), str(d / "sym"))
    JBV.store(erdos_renyi(150, 0.04, seed=7), str(d / "other"))
    JBV.store(g, str(d / "golomb"),
              settings=JSettings(residual_coding=JC.GOLOMB))
    rng = np.random.default_rng(3)
    src = rng.integers(0, 1 << 40, 600)
    tgt = rng.choice(src, 600)
    with open(d / "arcs.txt", "w") as f:
        f.write("# an arc list\n")
        for s, t in zip(src, tgt):
            f.write(f"{s}\t{t}\n")
    rng.permutation(150).astype(">i8").tofile(d / "map")
    from webgraph_tpu.codecs.ascii import ASCIIGraph
    ASCIIGraph.store(g, str(d / "txt"))
    return d


def _copy_sources(srcdir, d):
    d.mkdir(exist_ok=True)
    for name in os.listdir(srcdir):
        with open(srcdir / name, "rb") as a, open(d / name, "wb") as b:
            b.write(a.read())


def _run(capsys, srcdir, tmp_path, argv, stdin_text=None, monkeypatch=None):
    """Run ``argv(d)`` in both packages, each in a fresh copy of the
    sources; returns {name: (rc, printed lines, directory)}."""
    out = {}
    for name, main, extra in (("jax", jmain, []),
                              ("port", pmain, ["--device", "cpu"])):
        d = tmp_path / name
        _copy_sources(srcdir, d)
        if stdin_text is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
        rc = main(argv(str(d)) + extra)
        text = capsys.readouterr().out.replace(str(d), "<dir>")
        out[name] = (rc, text, d)
    assert out["jax"][0] == out["port"][0] == 0
    return out


def _same_files(out, floats=()):
    """Every file of the two directories equal: bytes, ``.properties`` bar
    the date line, the files named in ``floats`` as float64 to 1e-12."""
    a, b = out["jax"][2], out["port"][2]
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for nm in names:
        if nm.endswith(".properties"):
            assert props_lines(a / nm) == props_lines(b / nm), nm
        elif nm in floats:
            np.testing.assert_allclose(np.fromfile(b / nm),
                                       np.fromfile(a / nm), rtol=1e-12,
                                       atol=0)
        else:
            assert (a / nm).read_bytes() == (b / nm).read_bytes(), nm
    return names


def _same_lines(out):
    assert out["jax"][1] == out["port"][1]


@pytest.mark.parametrize("extra", [[], ["-w", "3", "-m", "2"],
                                   ["-i", "0", "-k", "2"], ["-o"],
                                   ["-w", "9"]])
def test_bvgraph_recompress(capsys, srcdir, tmp_path, extra):
    """Re-encodes in one stream: the device encoder, or past its window
    envelope (w > 7) the native encoder on one thread."""
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["bvgraph", d + "/g", d + "/re"] + extra)
    _same_lines(out)
    assert "re.graph" in _same_files(out)


@pytest.mark.parametrize("flag,made", [("-O", "g.offsets"),
                                       ("-d", "g.outdegrees"),
                                       ("-L", "g.obl")])
def test_bvgraph_files(capsys, srcdir, tmp_path, flag, made):
    out = _run(capsys, srcdir, tmp_path, lambda d: ["bvgraph", d + "/g", flag])
    _same_lines(out)
    assert made in _same_files(out)


def test_bvgraph_in_place_outside_the_kernel(capsys, srcdir, tmp_path):
    """A basename with Golomb-coded residuals (outside the decode kernel's
    envelope) takes the host route to the device, then re-encodes."""
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["bvgraph", d + "/golomb", d + "/re", "-w", "2"])
    assert "re.graph" in _same_files(out)


@pytest.mark.parametrize("extra", [[], ["-q", "3"], ["-u", "400"]])
def test_efgraph(capsys, srcdir, tmp_path, extra):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["efgraph", d + "/g", d + "/ef"] + extra)
    assert "ef.graph" in _same_files(out)


VERBS = ["identity", "transpose", "transposeOffline", "symmetrize",
         "symmetrizeOffline", "simplify", "simplifyOffline", "mapOffline",
         "union", "compose", "gray", "grayPerm", "lex", "lexPerm", "random",
         "arcfilter"]


@pytest.mark.parametrize("verb", VERBS)
def test_transform(capsys, srcdir, tmp_path, verb):
    def argv(d):
        a = ["transform", verb, d + "/g", d + "/out"]
        if verb == "mapOffline":
            a += ["--map-file", d + "/map"]
        if verb in ("union", "compose"):
            a += ["--other", d + "/other"]
        if verb == "random":
            a += ["--seed", "5"]
        return a

    out = _run(capsys, srcdir, tmp_path, argv)
    _same_lines(out)
    names = _same_files(out)
    assert ("out" if verb.endswith("Perm") else "out.graph") in names


def test_transform_unknown_filter(capsys, srcdir, tmp_path):
    d = tmp_path / "port"
    _copy_sources(srcdir, d)
    with pytest.raises(SystemExit, match="unknown filter"):
        pmain(["transform", "arcfilter", str(d / "g"), str(d / "out"),
               "--filter", "NOPE", "--device", "cpu"])


@pytest.mark.parametrize("direction", ["to_ascii", "from_ascii"])
def test_ascii(capsys, srcdir, tmp_path, direction):
    if direction == "to_ascii":
        def argv(d):
            return ["ascii", d + "/g", d + "/out", "--to-ascii"]
        made = "out.graph-txt"
    else:
        def argv(d):
            return ["ascii", d + "/txt", d + "/out"]
        made = "out.graph"
    out = _run(capsys, srcdir, tmp_path, argv)
    assert made in _same_files(out)


@pytest.mark.parametrize("flags", [[], ["--symmetrize"], ["--no-loops"],
                                   ["--symmetrize", "--no-loops"]])
def test_scattered(capsys, srcdir, tmp_path, flags):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["scattered", d + "/arcs.txt", d + "/sc"] + flags)
    names = _same_files(out)
    assert "sc.ids" in names and "sc.graph" in names


def test_scattered_stdin(capsys, srcdir, tmp_path, monkeypatch):
    text = (srcdir / "arcs.txt").read_text()
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["scattered", "-", d + "/sc"], stdin_text=text,
               monkeypatch=monkeypatch)
    assert "sc.ids" in _same_files(out)


@pytest.mark.parametrize("flags", [[], ["--scc"], ["-o"]])
def test_stats(capsys, srcdir, tmp_path, flags):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["stats", d + "/g", d + "/st"] + flags)
    _same_lines(out)
    assert "st.stats" in _same_files(out)


@pytest.mark.parametrize("flags", [["-l", "4"], ["-l", "5", "-s", "3",
                                                 "--harmonic"],
                                   ["-l", "4", "-u", "2"],
                                   ["-l", "4", "-t", "0.01",
                                    "--sum-of-distances"]])
def test_hyperball(capsys, srcdir, tmp_path, flags):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["hyperball", d + "/g", d + "/hc"] + flags)
    rows = {k: [line.split("\t") for line in v[1].splitlines()]
            for k, v in out.items()}
    assert [r[0] for r in rows["jax"]] == [r[0] for r in rows["port"]]
    np.testing.assert_allclose([float(r[1]) for r in rows["port"]],
                               [float(r[1]) for r in rows["jax"]],
                               rtol=1e-12, atol=0)
    names = _same_files(out, floats=("hc",))
    assert ("hc" in names) == ("--harmonic" in flags)


@pytest.mark.parametrize("start", [0, 3, 149])
def test_bfs(capsys, srcdir, tmp_path, start):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["bfs", d + "/g", d + "/dist", "-s", str(start)])
    _same_lines(out)
    assert "dist" in _same_files(out)


@pytest.mark.parametrize("flags", [[], ["--sort-by-size"]])
def test_cc(capsys, srcdir, tmp_path, flags):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["cc", d + "/sym", d + "/comp"] + flags)
    _same_lines(out)
    assert "comp" in _same_files(out)


@pytest.mark.parametrize("source", ["g", "other"])
def test_scc(capsys, srcdir, tmp_path, source):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["scc", d + "/" + source, d + "/comp"])
    _same_lines(out)
    assert "comp" in _same_files(out)


SEQUENTIAL = r"^\d+\.\d\d ns/link  \(\d+\.\d M links/s\)\n$"


@pytest.mark.parametrize("flags,pattern", [
    ([], SEQUENTIAL),
    (["-r", "40", "-R", "2"], r"^\d+\.\d\d ns/link\n$"),
    (["--mapped", "-R", "1"], SEQUENTIAL)])
def test_speedtest(capsys, srcdir, tmp_path, flags, pattern):
    out = _run(capsys, srcdir, tmp_path,
               lambda d: ["speedtest", d + "/g"] + flags)
    for name in ("jax", "port"):
        assert re.match(pattern, out[name][1]), (name, out[name][1])


def test_speedtest_outside_the_kernel(capsys, srcdir, tmp_path):
    """Outside the decode kernel's envelope the sequential mode times the
    whole ``to_device`` (the host route)."""
    d = tmp_path / "port"
    _copy_sources(srcdir, d)
    assert pmain(["speedtest", str(d / "golomb"), "-R", "1", "--device",
                  "cpu"]) == 0
    assert re.match(r"^\d+\.\d\d ns/link  \(", capsys.readouterr().out)


@pytest.mark.parametrize("argv", [["bfs", "X"], ["stats", "X"],
                                  ["bvgraph", "X", "-O"],
                                  ["speedtest", "X"]])
def test_no_device_needs_the_card(monkeypatch, argv):
    """Without ``--device`` every command runs on the GPU: where there is
    none it raises ``require_cuda``'s error before touching its input."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain(argv)


def test_help_loads_no_jax_and_builds_nothing():
    code = (
        "import runpy, sys\n"
        "pre = 'jax' in sys.modules or 'webgraph_tpu' in sys.modules\n"
        "sys.argv = ['webgraph_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('webgraph_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'webgraph_tpu'))\n"
        "built = [m for m in ('webgraph_tpu_torch.ops._build',\n"
        "                     'webgraph_tpu_torch.native')\n"
        "         if m in sys.modules]\n"
        "print('PRE' if pre else repr((bad[:5], built)), file=sys.stderr)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "speedtest" in out.stdout and "transform" in out.stdout
    if out.stderr.strip().endswith("PRE"):
        pytest.skip("this interpreter loads jax at start-up")
    assert out.stderr.strip().splitlines()[-1] == "([], [])"


def test_python_dash_m_help():
    out = subprocess.run([sys.executable, "-m", "webgraph_tpu_torch",
                          "bfs", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--start" in out.stdout
