"""The port's import formats against the JAX package's.

``codecs/ascii.py``, ``codecs/intlist.py``, ``codecs/scattered.py`` and the
native arc parser, on the same inputs through both packages (the port on
``device="cpu"``): the cases of ``tests/test_misc.py`` that touch them,
files written by each package and read by the other (``.graph-txt``, plain
and gzipped; arc lists with shift 0 and -1; int lists), ``.ids`` files
byte-identical, and the parser's chunk protocol and error offsets equal.
Every comparison is exact.
"""

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from webgraph_tpu import native as JN
from webgraph_tpu.codecs import ascii as JA
from webgraph_tpu.codecs import intlist as JI
from webgraph_tpu.codecs import scattered as JS
from webgraph_tpu.core import graph as jcore
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs import ascii as PA
from webgraph_tpu_torch.codecs import intlist as PI
from webgraph_tpu_torch.codecs import scattered as PS
from webgraph_tpu_torch.core import graph as pcore
from webgraph_tpu_torch.core.graph import CSRGraph, host_csr

from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph
from .torch_file_cases import edge_graphs, props_lines

torch.set_num_threads(1)
CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lists(g):
    """(node, list) pairs of any graph of either package, as int lists."""
    if isinstance(g, CSRGraph):
        co, su = host_csr(g)
        return [(x, su[co[x]:co[x + 1]].tolist()) for x in range(len(co) - 1)]
    return [(x, np.asarray(s).tolist()) for x, s in g.iter_nodes()]


def _graphs():
    g = {"er": erdos_renyi(60, 0.1, seed=4), "cycle": cycle_graph(9),
         "star": star_graph(7), "complete": complete_graph(5),
         "er_loops": erdos_renyi(40, 0.2, seed=1, loops=True)}
    g.update(edge_graphs())
    return g


GRAPHS = _graphs()


# -- test_misc.py's scattered cases, through both packages -----------------

def _both_scattered(text, **kw):
    j = JS.ScatteredArcsASCIIGraph(io.StringIO(text), **kw)
    p = PS.ScatteredArcsASCIIGraph(io.StringIO(text), device=CPU, **kw)
    try:
        np.testing.assert_array_equal(p.ids, j.ids)
        assert p.ids.dtype == j.ids.dtype
        assert (p.num_nodes, p.num_arcs) == (j.num_nodes, j.num_arcs)
        assert _lists(p) == _lists(j)
        return j.ids, _lists(p)
    finally:
        j.batch_graph.cleanup()
        p.batch_graph.cleanup()


def test_scattered_numeric_remap():
    ids, lists = _both_scattered("100 300\n300 100\n200 100\n100 200\n")
    np.testing.assert_array_equal(ids, [100, 300, 200])
    assert lists == [(0, [1, 2]), (1, [0]), (2, [0])]


@pytest.mark.parametrize("sym,noloops", [(True, True), (True, False),
                                         (False, True)])
def test_scattered_symmetrize_noloops(sym, noloops):
    _both_scattered("5 5\n5 7\n7 9\n", symmetrize=sym, no_loops=noloops)


def test_scattered_id_function():
    _, lists = _both_scattered("a b\nb c\n", id_function=lambda s: ord(s))
    assert lists == [(0, [1]), (1, [2]), (2, [])]


@pytest.mark.parametrize("batch", [700, 5000, 1 << 20])
def test_scattered_bulk(tmp_path, batch):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 1 << 40, 5000)
    tgt = rng.integers(0, 1 << 40, 5000)
    jg, jids = JS.scattered_arcs_to_batches(src, tgt, batch_size=batch,
                                            temp_dir=str(tmp_path))
    pg, pids = PS.scattered_arcs_to_batches(src, tgt, batch_size=batch,
                                            temp_dir=str(tmp_path),
                                            device=CPU)
    np.testing.assert_array_equal(pids, jids)
    assert (pg.num_nodes, pg.num_arcs, len(pg.batches)) == (
        jg.num_nodes, jg.num_arcs, len(jg.batches))
    for a, b in zip(jg.batches, pg.batches):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    assert _lists(pg) == _lists(jg)
    jg.cleanup()
    pg.cleanup()


def test_idremap_blocks():
    """The appearance-order map, block by block, in both packages."""
    rng = np.random.default_rng(2)
    j, p = JS.IdRemap(), PS.IdRemap()
    for _ in range(6):
        vals = rng.integers(-50, 200, rng.integers(0, 300))
        np.testing.assert_array_equal(p.remap(vals), j.remap(vals))
        assert p.count == j.count
    np.testing.assert_array_equal(p.ids(), j.ids())


def test_scattered_streaming_bounded(tmp_path):
    """The memory contract (ScatteredArcsASCIIGraph.java:142-240): buffered
    pairs never exceed ~batch_size + one chunk, in both packages."""
    rng = np.random.default_rng(1)
    n_arcs = 20000
    src = rng.integers(0, 1 << 32, n_arcs)
    tgt = rng.integers(0, 1 << 32, n_arcs)
    path = tmp_path / "arcs.txt"
    with open(path, "w") as f:
        for s, t in zip(src, tgt):
            f.write(f"{s} {t}\n")
    batch = 1000
    kw = dict(batch_size=batch, temp_dir=str(tmp_path), chunk_bytes=4096)
    j = JS.ScatteredArcsASCIIGraph(str(path), **kw)
    p = PS.ScatteredArcsASCIIGraph(str(path), device=CPU, **kw)
    assert p.ingest_stats == j.ingest_stats
    assert p.ingest_stats["max_buffered"] <= batch + 500
    assert p.ingest_stats["num_batches"] >= n_arcs // batch - 1
    np.testing.assert_array_equal(p.ids, j.ids)
    assert _lists(p) == _lists(j)
    j.batch_graph.cleanup()
    p.batch_graph.cleanup()


def test_scattered_python_reader_matches_native(tmp_path):
    """The line loop (``id_function``) and the native chunked parse give the
    same graph on numeric ids."""
    text = "# c\n10 20\n\n  30\t40 \n-5 6\n20 10\n"
    a = PS.ScatteredArcsASCIIGraph(io.StringIO(text), device=CPU)
    b = PS.ScatteredArcsASCIIGraph(io.StringIO(text), id_function=int,
                                   device=CPU)
    np.testing.assert_array_equal(a.ids, b.ids)
    assert _lists(a) == _lists(b)
    a.batch_graph.cleanup()
    b.batch_graph.cleanup()


@pytest.mark.parametrize("sym", [False, True])
def test_ids_file_byte_identical(tmp_path, sym):
    rng = np.random.default_rng(5)
    text = "".join(f"{s} {t}\n" for s, t in rng.integers(
        0, 1 << 62, (300, 2)))
    j = JS.ScatteredArcsASCIIGraph(io.StringIO(text), symmetrize=sym)
    p = PS.ScatteredArcsASCIIGraph(io.StringIO(text), symmetrize=sym,
                                   device=CPU)
    j.save_ids(str(tmp_path / "j.ids"))
    p.save_ids(str(tmp_path / "p.ids"))
    assert (tmp_path / "j.ids").read_bytes() == (tmp_path / "p.ids"
                                                 ).read_bytes()
    j.batch_graph.cleanup()
    p.batch_graph.cleanup()


def test_scattered_needs_a_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.ScatteredArcsASCIIGraph(io.StringIO("1 2\n"))


# -- the native parser: the port's copy against the original ---------------

PARSE_CASES = {
    "plain": b"1 2\n3 4\n",
    "comments_blanks": b"# c\n10 20\n\n  30\t40 \n-5 6\n",
    "crlf": b"1 2\r\n3\t4\r\n",
    "signs": b"+7 -8\n-0 +0\n",
    "no_final_newline": b"1 2\n3 4",
    "only_comment": b"# nothing\n",
    "empty": b"",
    "big": b"9223372036854775807 1\n",
}


@pytest.mark.parametrize("name", sorted(PARSE_CASES))
@pytest.mark.parametrize("eof", [False, True])
def test_parse_arcs_equal(name, eof):
    buf = PARSE_CASES[name]
    js, jt, ju = JN.parse_arcs(buf, eof=eof)
    ps, pt, pu = PN.parse_arcs(buf, eof=eof)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pt, jt)
    assert pu == ju


@pytest.mark.parametrize("buf", [b"1 2\n3\n", b"1 2\nx 3\n", b"1 2 3\n",
                                 b"1 2\n\n4 5 junk\n", b"7"])
def test_parse_arcs_malformed_offset(buf):
    with pytest.raises(ValueError) as je:
        JN.parse_arcs(buf, eof=True)
    with pytest.raises(ValueError) as pe:
        PN.parse_arcs(buf, eof=True)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_parse_arcs_chunk_edges(chunk):
    """The streaming protocol over every chunk edge: the carry of an
    incomplete last line, chunk by chunk, in both libraries."""
    rng = np.random.default_rng(chunk)
    text = "".join(f"{a} {b}\n" if a % 5 else "# x\n"
                   for a, b in rng.integers(0, 10 ** 6, (40, 2))).encode()
    got = {}
    for name, lib in (("jax", JN), ("port", PN)):
        carry, out, used_all = b"", [], []
        for i in range(0, len(text) + chunk, chunk):
            block = text[i:i + chunk]
            eof = not block
            buf = carry + block
            if buf:
                s, t, used = lib.parse_arcs(buf, eof=eof)
                carry = buf[used:]
                used_all.append(used)
                out += list(zip(s.tolist(), t.tolist()))
            if eof:
                break
        got[name] = (out, used_all)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == sum(1 for line in text.split(b"\n")
                                      if line and not line.startswith(b"#"))


def test_parse_arcs_available():
    assert PN.parse_arcs_available()


# -- files written by each package, read by the other ----------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_txt_both_ways(tmp_path, name):
    g = GRAPHS[name]
    JA.ASCIIGraph.store(g, str(tmp_path / "j"))
    PA.ASCIIGraph.store(CSRGraph(g.offsets, g.succ, device=CPU),
                        str(tmp_path / "p"))
    assert (tmp_path / "j.graph-txt").read_bytes() == (
        tmp_path / "p.graph-txt").read_bytes()
    want = _lists(g)
    for mode in ("offline", "standard"):
        assert _lists(PA.ASCIIGraph.load(str(tmp_path / "j"), mode=mode)
                      ) == want
    assert _lists(JA.ASCIIGraph.load(str(tmp_path / "p"))) == want
    got = PA.ASCIIGraph.load(str(tmp_path / "j")).to_device(CPU)
    assert got.report["route"] == "scan" and _lists(got) == want


def test_graph_txt_gz_and_random_access(tmp_path):
    g = GRAPHS["er"]
    JA.ASCIIGraph.store(g, str(tmp_path / "j"))
    raw = (tmp_path / "j.graph-txt").read_bytes()
    with gzip.open(tmp_path / "z.graph-txt.gz", "wb") as f:
        f.write(raw)
    off = PA.ASCIIGraph.load(str(tmp_path / "z"))
    assert off.path.endswith(".gz") and not off.random_access
    with pytest.raises(RuntimeError):
        off.successors(0)
    std = PA.ASCIIGraph.load(str(tmp_path / "z"), mode="standard")
    assert std.random_access and std.num_arcs == g.num_arcs
    for x in range(g.num_nodes):
        np.testing.assert_array_equal(std.successors(x), g.successors(x))
    assert _lists(off) == _lists(JA.ASCIIGraph.load(str(tmp_path / "z")))
    assert list(PA.ASCIIGraph.load_once(io.StringIO(raw.decode()))
                )[3][1].tolist() == g.successors(3).tolist()


@pytest.mark.parametrize("name", ["er", "cycle", "star", "isolated",
                                  "one_loop"])
@pytest.mark.parametrize("cls", ["ArcListASCIIGraph",
                                 "ShiftedByOneArcListASCIIGraph"])
def test_arc_list_both_ways(tmp_path, name, cls):
    g = GRAPHS[name]
    j, p = getattr(JA, cls), getattr(PA, cls)
    j.store(g, str(tmp_path / "j"))
    p.store(CSRGraph(g.offsets, g.succ, device=CPU), str(tmp_path / "p"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "p").read_bytes()
    jg = j.load(str(tmp_path / "p"))
    pg = p.load(str(tmp_path / "j"), device=CPU)
    assert isinstance(pg, CSRGraph) and pg.device == torch.device(CPU)
    assert _lists(pg) == _lists(jg)
    lazy = p.load(str(tmp_path / "j"), mode="offline", device=CPU)
    assert _lists(lazy) == _lists(jg) and lazy.num_arcs == jg.num_arcs
    assert lazy.to_device(CPU).report["route"] == "scan"


def test_arc_list_shift_and_order(tmp_path):
    (tmp_path / "a").write_text("# x\n1\t2\n1 3\n\n2\t1\n")
    for shift in (0, 5, -1):
        jg = JA.ArcListASCIIGraph.load(str(tmp_path / "a"), shift=shift)
        pg = PA.ArcListASCIIGraph.load(str(tmp_path / "a"), shift=shift,
                                       device=CPU)
        assert _lists(pg) == _lists(jg)
    (tmp_path / "b").write_text("2 1\n1 2\n")
    for mod, kw in ((JA, {}), (PA, dict(device=CPU))):
        with pytest.raises(ValueError, match="nondecreasing"):
            mod.ArcListASCIIGraph.load(str(tmp_path / "b"), **kw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_intlist_both_ways(tmp_path, name):
    g = GRAPHS[name]
    JI.IntegerListImmutableGraph.store(g, str(tmp_path / "j"))
    PI.IntegerListImmutableGraph.store(CSRGraph(g.offsets, g.succ,
                                                device=CPU),
                                       str(tmp_path / "p"))
    assert (tmp_path / "j.intlist").read_bytes() == (
        tmp_path / "p.intlist").read_bytes()
    assert props_lines(tmp_path / "j.properties") == props_lines(
        tmp_path / "p.properties")
    want = _lists(g)
    assert _lists(pcore.load(str(tmp_path / "j"))) == want
    assert _lists(jcore.load(str(tmp_path / "p")).to_csr()) == want
    got = pcore.load_csr(str(tmp_path / "j"), device=CPU)
    assert got.report["route"] == "scan" and _lists(got) == want


def test_load_finds_the_host_formats(tmp_path):
    """``load`` finds the ASCII and int-list classes without the caller
    importing them (a fresh interpreter), and ``load_csr`` scans them on
    the host."""
    g = GRAPHS["er"]
    JI.IntegerListImmutableGraph.store(g, str(tmp_path / "il"))
    code = ("import sys\n"
            "from webgraph_tpu_torch.core import graph as core\n"
            "g = core.load(sys.argv[1])\n"
            "c = core.load_csr(sys.argv[1], device='cpu')\n"
            "print(type(g).__name__, g.num_arcs, c.report['route'])\n"
            "print('it.unimi.dsi.big.webgraph.ASCIIGraph' in "
            "core.GRAPH_CLASS_REGISTRY)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "il")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["IntegerListImmutableGraph",
                                  str(g.num_arcs), "scan", "True"]
