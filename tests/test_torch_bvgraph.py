"""The port's BVGraph files against the JAX package's.

The sweeps of ``tests/test_bvgraph.py`` and the streaming tests of
``tests/test_bigbv.py``, run through both packages on the same graphs:

- the port's ``.graph``/``.offsets`` bytes equal the JAX ``BVGraph.store``'s
  and ``.properties`` equals it bar the date comment line;
- the port's host decoders (random access, sequential scans, sliced scans)
  give the original lists;
- ``load_csr(basename, device="cpu")`` equals ``native.bv_decode_all`` and
  the JAX ``load(basename).to_csr()``, on the kernel route (B1 and B2's
  plain versions on the CPU) and on the host route (codes outside the
  kernel's envelope), and n = 0 gives an empty ``CSRGraph``.

Every comparison is exact.
"""

import os
import time

import numpy as np
import pytest
import torch

from webgraph_tpu import native as JN
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.core import graph as jcore
from webgraph_tpu.ops.ef_index import EliasFanoMonotoneList as JEFList
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core import graph as core
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops.ef_index import EliasFanoMonotoneList
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C

from .graphs import (complete_binary_intree, complete_binary_outtree,
                     complete_graph, cycle_graph, erdos_renyi, star_graph)
from .test_bigbv import BigGraph
from .torch_file_cases import edge_graphs, props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")
EXTS = (".graph", ".offsets")


@pytest.fixture(scope="module")
def graphs():
    """The module's graphs, built once (JAX host CSRs)."""
    g = {"complete8": complete_graph(8),
         "intree4": complete_binary_intree(4),
         "outtree4": complete_binary_outtree(4),
         "cycle17": cycle_graph(17), "star13": star_graph(13),
         "er_60_05_0": erdos_renyi(60, 0.05, seed=0),
         "er_60_05_1": erdos_renyi(60, 0.05, seed=1),
         "er_60_3_0": erdos_renyi(60, 0.3, seed=0),
         "er_60_3_1": erdos_renyi(60, 0.3, seed=1),
         "er_50_15_3": erdos_renyi(50, 0.15, seed=3),
         "er_40_2_9": erdos_renyi(40, 0.2, seed=9),
         "er_80_1_5": erdos_renyi(80, 0.1, seed=5),
         "er_500_03_9": erdos_renyi(500, 0.03, seed=9)}
    g.update(edge_graphs())
    return g


def _port(g) -> CSRGraph:
    return CSRGraph(g.offsets, g.succ, num_nodes=g.num_nodes, device=CPU)


def _same_files(a, b, exts=EXTS):
    for ext in exts:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    assert props_lines(a + ".properties") == props_lines(b + ".properties")


def _jax_settings(s):
    return JSettings(**vars(s))


def both(g, tmp_path, settings=None, **kw):
    """Store ``g`` with both packages; the port's basename."""
    j, p = str(tmp_path / "j"), str(tmp_path / "p")
    JBV.store(g, j, settings=settings and _jax_settings(settings), **kw)
    BVGraph.store(_port(g), p, settings=settings, **kw)
    _same_files(j, p)
    return p, j


def check_decodes(g, p, j, route=None):
    """The port's host decoders and ``load_csr`` on the CPU against the
    graph, the native decoder and the JAX package's decode."""
    bv = BVGraph.load(p)
    assert (bv.num_nodes, bv.num_arcs) == (g.num_nodes, g.num_arcs)
    for (x, a), (y, b) in zip(bv.iter_nodes(), g.iter_nodes()):
        assert x == y
        np.testing.assert_array_equal(a, b, err_msg=f"node {x}")
    for x in range(g.num_nodes):
        np.testing.assert_array_equal(bv.successors(x), g.successors(x))
    csr = core.load_csr(p, device="cpu")
    assert csr.device == CPU and csr.num_nodes == g.num_nodes
    co, su = PN.bv_decode_all(bv.data, bv.num_nodes, bv.num_arcs,
                              bv.settings)
    np.testing.assert_array_equal(csr.offsets.numpy(), co)
    np.testing.assert_array_equal(csr.succ.numpy(), su)
    jc = jcore.load(j).to_csr()
    np.testing.assert_array_equal(csr.offsets.numpy(), jc.offsets)
    np.testing.assert_array_equal(csr.succ.numpy(), jc.succ)
    if route is not None:
        assert csr.report["route"] == route
    return csr


@pytest.mark.parametrize("window", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("min_interval", [0, 2, 4])
def test_compression_sweep_complete_graph(graphs, tmp_path, window,
                                          min_interval):
    g = graphs["complete8"]
    p, j = both(g, tmp_path, window_size=window, max_ref_count=3,
                min_interval_length=min_interval)
    check_decodes(g, p, j, route="kernel")


@pytest.mark.parametrize("name", ["intree4", "outtree4", "cycle17",
                                  "star13"])
@pytest.mark.parametrize("window", [0, 2])
def test_compression_sweep_structured(graphs, tmp_path, name, window):
    g = graphs[name]
    p, j = both(g, tmp_path, window_size=window, max_ref_count=1,
                min_interval_length=2)
    check_decodes(g, p, j, route="kernel")


@pytest.mark.parametrize("name", ["er_60_05_0", "er_60_05_1", "er_60_3_0",
                                  "er_60_3_1"])
def test_compression_erdos_renyi(graphs, tmp_path, name):
    g = graphs[name]
    p, j = both(g, tmp_path)
    check_decodes(g, p, j, route="kernel")


@pytest.mark.parametrize("coding,route", [
    (C.GAMMA, "kernel"), (C.DELTA, "kernel"), (C.ZETA, "kernel"),
    (C.GOLOMB, "host"), (C.NIBBLE, "host")])
def test_residual_codings(graphs, tmp_path, coding, route):
    """Golomb and nibble residuals lie outside the kernel's envelope: the
    entry decodes them on the host, as the reference does."""
    g = graphs["er_50_15_3"]
    s = BVGraphSettings(residual_coding=coding)
    p, j = both(g, tmp_path, settings=s)
    assert BVGraph.load(p).settings.residual_coding == coding
    check_decodes(g, p, j, route=route)


def test_wide_window_takes_the_host_route(graphs, tmp_path):
    g = graphs["er_80_1_5"]
    p, j = both(g, tmp_path, window_size=9, max_ref_count=2)
    check_decodes(g, p, j, route="host")


def test_skewed_golomb_is_refused_by_both(graphs, tmp_path):
    s = BVGraphSettings(residual_coding=C.SKEWED_GOLOMB)
    g = graphs["er_40_2_9"]
    with pytest.raises(NotImplementedError):
        JBV.store(g, str(tmp_path / "j"), settings=_jax_settings(s),
                  backend="python")
    with pytest.raises(NotImplementedError):
        BVGraph.store(_port(g), str(tmp_path / "p"), settings=s,
                      backend="python")


@pytest.mark.parametrize("attrs", [
    dict(outdegree_coding=C.DELTA), dict(reference_coding=C.GAMMA),
    dict(block_count_coding=C.UNARY), dict(block_coding=C.DELTA),
    dict(offset_coding=C.DELTA)])
def test_component_codings(graphs, tmp_path, attrs):
    g = graphs["er_40_2_9"]
    s = BVGraphSettings(**attrs)
    p, j = both(g, tmp_path, settings=s)
    loaded = BVGraph.load(p)
    assert loaded.settings.flags() == s.flags()
    assert vars(loaded.settings) == vars(JBV.load(j).settings)
    check_decodes(g, p, j, route="kernel")


@pytest.mark.parametrize("attrs", [
    dict(), dict(residual_coding=C.GAMMA, outdegree_coding=C.DELTA),
    dict(reference_coding=C.DELTA, block_coding=C.UNARY,
         block_count_coding=C.DELTA, offset_coding=C.DELTA),
    dict(residual_coding=C.NIBBLE), dict(residual_coding=C.GOLOMB)])
def test_flags_string_roundtrip(attrs):
    s = BVGraphSettings(**attrs)
    js = JSettings(**attrs)
    assert s.flags() == js.flags() and s.flags_string() == js.flags_string()
    rt = BVGraphSettings.from_flags_string(s.flags_string())
    assert vars(rt) == vars(s)
    assert BVGraphSettings.from_flags_string("").flags() == 0
    for mod in (BVGraphSettings, JSettings):   # an unknown flag
        with pytest.raises(IOError):
            mod.from_flags_string("RESIDUALS_GAMMA | SPEED_FAST")


def test_python_backend_is_byte_identical(graphs, tmp_path):
    """The port's scalar oracle encoder equals the native encoder."""
    for name in ("er_60_3_1", "cycle17", "isolated", "n0"):
        g = graphs[name]
        a, b = str(tmp_path / f"{name}_n"), str(tmp_path / f"{name}_py")
        BVGraph.store(_port(g), a, backend="native")
        BVGraph.store(_port(g), b, backend="python")
        _same_files(a, b)


def test_iter_from_start(graphs, tmp_path):
    g = graphs["er_80_1_5"]
    p, _j = both(g, tmp_path)
    loaded = BVGraph.load(p)
    for start in [0, 1, 7, 40, 79]:
        pairs = list(zip(loaded.iter_nodes(start), g.iter_nodes(start)))
        assert len(pairs) == g.num_nodes - start
        for (x, a), (y, b) in pairs:
            assert x == y
            np.testing.assert_array_equal(a, b)


def test_load_dispatch(graphs, tmp_path):
    g = graphs["er_40_2_9"]
    p, _j = both(g, tmp_path)
    loaded = core.load(p)
    assert isinstance(loaded, BVGraph)
    assert loaded.equals(g) and loaded.equals(_port(g))
    assert core.GRAPH_CLASS_REGISTRY["it.unimi.dsi.webgraph.BVGraph"] \
        is BVGraph
    props = str(tmp_path / "x.properties")
    with open(props, "w") as f:
        f.write("graphclass=no.such.Graph\n")
    with pytest.raises(IOError):
        core.load(str(tmp_path / "x"))


def test_host_graph_contract(graphs, tmp_path):
    """``to_csr`` and ``split_ranges`` of the host graph, as the JAX
    package's."""
    g = graphs["er_80_1_5"]
    p, j = both(g, tmp_path)
    bv, jbv = BVGraph.load(p), JBV.load(j)
    for lo, hi in ((0, None), (7, 40), (79, 80)):
        got, want = bv.to_csr(lo, hi, device=CPU), jbv.to_csr(lo, hi)
        assert got.num_nodes == want.num_nodes
        np.testing.assert_array_equal(got.offsets.numpy(), want.offsets)
        np.testing.assert_array_equal(got.succ.numpy(), want.succ)
    for pieces in (1, 3, 7):
        assert bv.split_ranges(pieces) == jbv.split_ranges(pieces)
    with pytest.raises(ValueError):
        bv.split_ranges(0)


def test_core_store_defaults_to_bvgraph(graphs, tmp_path):
    g = graphs["star13"]
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    core.store(_port(g), p)
    jcore.store(g, j)
    _same_files(j, p)


def test_offsets_regeneration(graphs, tmp_path):
    g = graphs["er_50_15_3"]
    p, _j = both(g, tmp_path)
    loaded = BVGraph.load(p)
    regen = loaded.decode_offsets_from_stream()
    np.testing.assert_array_equal(regen, loaded.offsets)
    np.testing.assert_array_equal(regen, JBV.load(p).offsets)


def test_write_outdegrees(graphs, tmp_path):
    g = graphs["er_60_05_1"]
    p, j = both(g, tmp_path)
    BVGraph.load(p).write_outdegrees(p + ".outdegrees")
    JBV.load(j).write_outdegrees(j + ".outdegrees")
    _same_files(j, p, exts=(".outdegrees",))


@pytest.mark.parametrize("mode", ["mapped", "offline"])
def test_load_modes(graphs, tmp_path, mode):
    g = graphs["er_60_3_0"]
    p, _j = both(g, tmp_path)
    bv = BVGraph.load(p, mode=mode)
    assert bv.equals(g)
    if mode == "mapped":
        assert isinstance(bv.data, np.memmap)
        csr = bv.to_device("cpu")
        np.testing.assert_array_equal(csr.succ.numpy(), g.succ)
    else:
        assert bv.offsets is None and not bv.random_access
        with pytest.raises(RuntimeError):
            bv.to_device("cpu")


@pytest.mark.parametrize("name", sorted(edge_graphs()))
def test_edge_graphs(graphs, tmp_path, name):
    g = graphs[name]
    p, j = both(g, tmp_path)
    csr = check_decodes(g, p, j)
    assert csr.report["route"] == ("empty" if g.num_nodes == 0 else "kernel")
    if g.num_nodes == 0:   # never reaches the planner (ROADMAP C3)
        assert csr.offsets.tolist() == [0] and csr.num_arcs == 0


def test_entries_default_to_the_card(graphs, tmp_path, monkeypatch):
    """Without a device argument the entries ask for the GPU: with none
    present they raise instead of running on the CPU."""
    p, _j = both(graphs["cycle17"], tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.load_csr(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        BVGraph.load(p).to_device()


def test_load_csr_report(graphs, tmp_path):
    g = graphs["er_500_03_9"]
    p, j = both(g, tmp_path)
    csr = check_decodes(g, p, j, route="kernel")
    r = csr.report
    assert r["format"] == "BVGraph" and r["fallback_arcs"] == 0
    assert r["resolve_passes"] >= 1
    for k in ("load_s", "plan_s", "resolve_s", "decode_to_csr_s"):
        assert r[k] >= 0


# -- the offsets cache (.obl) -------------------------------------------------


def test_obl_cache_crosses_packages(graphs, tmp_path):
    g = graphs["er_500_03_9"]
    p, j = both(g, tmp_path)
    pp = BVGraph.load(p).write_offsets_cache()
    jp = JBV.load(j).write_offsets_cache()
    assert pp == p + ".obl"
    _same_files(j, p, exts=(".obl",))
    later = time.time() + 10
    for path in (pp, jp):
        os.utime(path, (later, later))
    want = JBV.load(j).offsets
    # each package loads the other's cache
    os.replace(jp, p + ".obl")
    np.testing.assert_array_equal(BVGraph.load(p).offsets, want)
    os.replace(p + ".obl", j + ".obl")
    BVGraph.load(p, offsets="ef").write_offsets_cache(j)
    os.utime(j + ".obl", (later, later))
    assert isinstance(JBV.load(j, offsets="ef").offsets, JEFList)
    np.testing.assert_array_equal(JBV.load(j).offsets, want)
    ef = BVGraph.load(j, offsets="ef")
    assert isinstance(ef.offsets, EliasFanoMonotoneList)
    np.testing.assert_array_equal(ef.offsets.to_array(), want)
    for x in (0, 7, 123, 499):
        np.testing.assert_array_equal(ef.successors(x), g.successors(x))
    csr = ef.to_device("cpu")
    np.testing.assert_array_equal(csr.succ.numpy(), g.succ)


@pytest.mark.parametrize("what", ["stale", "foreign", "wrong_length",
                                  "truncated"])
def test_bad_obl_falls_back_to_offsets(graphs, tmp_path, what):
    g = graphs["er_60_3_1"]
    p, _j = both(g, tmp_path)
    bv = BVGraph.load(p)
    want = np.asarray(bv.offsets)
    obl = p + ".obl"
    if what == "foreign":
        # a Java serialisation stream header and junk
        with open(obl, "wb") as f:
            f.write(b"\xac\xed\x00\x05" + b"\x00" * 64)
    elif what == "wrong_length":
        from webgraph_tpu_torch.ops.ef_index import build_ef
        build_ef(want[:-3]).dump(obl)
    elif what == "truncated":
        bv.write_offsets_cache()
        with open(obl, "r+b") as f:
            f.truncate(os.path.getsize(obl) - 12)
    else:
        bv.write_offsets_cache()
        os.utime(obl, (1, 1))   # older than .offsets
    if what != "stale":
        later = time.time() + 10
        os.utime(obl, (later, later))
    np.testing.assert_array_equal(BVGraph.load(p).offsets, want)
    if what == "truncated":   # the reference's load fails (ROADMAP C4)
        with pytest.raises(ValueError):
            JBV.load(p)
    else:
        np.testing.assert_array_equal(JBV.load(p).offsets, want)


# -- streaming encode and sliced decode (tests/test_bigbv.py) ----------------


class _SeqOnly:
    """Sequential-only view: ``store`` takes its streaming branch."""

    def __init__(self, g):
        self._g = g
        self.num_nodes = g.num_nodes

    def iter_nodes(self, start=0):
        return self._g.iter_nodes(start)


@pytest.mark.parametrize("s", [BVGraphSettings(),
                               BVGraphSettings(window_size=0),
                               BVGraphSettings(min_interval_length=0)])
def test_stream_encoder_byte_identity(s):
    g = erdos_renyi(400, 0.04, seed=int(s.window_size + s.min_interval_length))
    co, su = g.offsets, g.succ
    one = PN.bv_encode(co, su, s, threads=1)
    encs = [PN.StreamEncoder(s), JN.StreamEncoder(_jax_settings(s))]
    for lo in range(0, 400, 37):
        hi = min(lo + 37, 400)
        for enc in encs:
            enc.push(co[lo:hi + 1] - co[lo], su[co[lo]:co[hi]])
    got, exp = (enc.finish() for enc in encs)
    for a, b, c in zip(got, exp, one):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(RuntimeError):
        encs[0].push(co[:2], su[:co[1]])


def test_store_streams_sequential_graphs(graphs, tmp_path):
    g = graphs["er_500_03_9"]
    a, b, j = (str(tmp_path / x) for x in ("csr", "seq", "j"))
    BVGraph.store(_port(g), a, backend="native", num_threads=1)
    BVGraph.store(_SeqOnly(g), b, backend="native")
    JBV.store(_SeqOnly(g), j, backend="native")
    _same_files(a, b)
    _same_files(a, j)


@pytest.mark.parametrize("slice_nodes", [22, 23, 50, 9_999])
def test_store_slices_roundtrip(tmp_path, slice_nodes):
    bg = BigGraph(50_000, 1000, 4)
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    props = BVGraph.store_slices(bg.slices(7_000), p)
    JBV.store_slices(bg.slices(7_000), j)
    _same_files(j, p)
    assert int(props["nodes"]) == 50_000
    assert int(props["arcs"]) == bg.num_arcs
    bv = BVGraph.load(p, mode="offline")
    np.testing.assert_array_equal(BVGraph.load(p).successors(777),
                                  [775, 776])
    # slices just above the halo (W * maxref = 21) and a wide one
    jparts = list(JBV.load(j, mode="offline").iter_csr_slices(
        slice_nodes=slice_nodes))
    x_at = 0
    for (lo, hi, co, su), (jlo, jhi, jco, jsu) in zip(
            bv.iter_csr_slices(slice_nodes=slice_nodes), jparts):
        assert (lo, hi) == (jlo, jhi) and lo == x_at
        eco, esu = bg.slice(lo, hi)
        np.testing.assert_array_equal(co, eco)
        np.testing.assert_array_equal(su, esu)
        np.testing.assert_array_equal(co, jco)
        np.testing.assert_array_equal(su, jsu)
        x_at = hi
    assert x_at == 50_000
    with pytest.raises(ValueError):
        next(bv.iter_csr_slices(slice_nodes=21))


def test_iter_csr_slices_cnr2000(cnr2000_basename):
    bv = BVGraph.load(cnr2000_basename)
    hco, hsu = PN.bv_decode_all(np.asarray(bv.data), bv.num_nodes,
                                bv.num_arcs, bv.settings)
    got = []
    x_at = 0
    for lo, hi, co, su in bv.iter_csr_slices(slice_nodes=50_021):
        assert lo == x_at
        np.testing.assert_array_equal(co, hco[lo:hi + 1] - hco[lo])
        got.append(su)
        x_at = hi
    assert x_at == bv.num_nodes
    np.testing.assert_array_equal(np.concatenate(got), hsu)
