"""The port's own host layer against the JAX package's.

The port keeps copies of what it needs of the JAX package's host layer: the
native library (``webgraph_tpu_torch/native``), the settings, the synthetic
generator and the word packer.  Each copy must give the same bytes and
arrays as the original on the same inputs; every comparison is exact.
"""

import os

import numpy as np
import pytest

from webgraph_tpu import native as JN
from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.codecs.bvgraph import CompressionFlags as JC
from webgraph_tpu.ops.packed import pack_words_u32 as j_pack
from webgraph_tpu.utils.synth import synthesize_webgraph as j_synth
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.ops.bitstream import pack_words_u32 as p_pack
from webgraph_tpu_torch.settings import BVGraphSettings, CompressionFlags
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .graphs import (complete_binary_intree, complete_graph, cycle_graph,
                     erdos_renyi, star_graph)

C = CompressionFlags
# the four stream formats of chip_smoke.py's kernel phase
CHECK_SETTINGS = {
    "default": BVGraphSettings(),
    "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
    "delta_w4_int2": BVGraphSettings(outdegree_coding=C.DELTA, window_size=4,
                                     min_interval_length=2),
    "gamma_res": BVGraphSettings(residual_coding=C.GAMMA),
}
GRAPHS = {
    "synth": lambda: synthesize_webgraph(3000, seed=5),
    "erdos_renyi": lambda: _csr(erdos_renyi(300, 0.05, seed=4)),
    "complete": lambda: _csr(complete_graph(12)),
    "star": lambda: _csr(star_graph(50)),
    "cycle": lambda: _csr(cycle_graph(64)),
    "intree": lambda: _csr(complete_binary_intree(6)),
}


def _csr(g):
    c = g.to_csr()
    return np.asarray(c.offsets, dtype=np.int64), np.asarray(c.succ,
                                                             dtype=np.int64)


def test_settings_match_the_jax_package():
    assert vars(BVGraphSettings()) == vars(JSettings())
    for name in ("NONE", "DELTA", "GAMMA", "GOLOMB", "SKEWED_GOLOMB",
                 "UNARY", "ZETA", "NIBBLE"):
        assert getattr(C, name) == getattr(JC, name)


@pytest.mark.parametrize("seed,n", [(0, 1000), (3, 5000), (11, 20_000)])
def test_synthesize_webgraph_equal(seed, n):
    co, su = synthesize_webgraph(n, seed=seed)
    jco, jsu = j_synth(n, seed=seed)
    np.testing.assert_array_equal(co, jco)
    np.testing.assert_array_equal(su, jsu)


@pytest.mark.parametrize("nbytes", [0, 1, 3, 4, 5, 17, 1000])
def test_pack_words_equal(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    got, exp = p_pack(data), j_pack(data)
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("sname", sorted(CHECK_SETTINGS))
def test_host_library_equal(gname, sname):
    """Encode byte-identically, then decode every way the port does, in
    both libraries."""
    s = CHECK_SETTINGS[sname]
    co, su = GRAPHS[gname]()
    if gname == "synth":
        co, su = E.simple(co, su)
    n, m = len(co) - 1, int(co[-1])
    for threads in (1, 3):
        got = PN.bv_encode(co, su, s, threads=threads)
        exp = JN.bv_encode(co, su, s, threads=threads)
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)
    graph, gbits, offs, _obits, _st = got
    offsets = PN.decode_offset_stream(offs, n, s.offset_coding)
    np.testing.assert_array_equal(
        offsets, JN.decode_offset_stream(offs, n, s.offset_coding))
    assert offsets[-1] == gbits
    outd = PN.decode_outdegrees(graph, offsets, s.outdegree_coding)
    np.testing.assert_array_equal(
        outd, JN.decode_outdegrees(graph, offsets, s.outdegree_coding))
    np.testing.assert_array_equal(outd, np.diff(co))
    pco, psu = PN.bv_decode_all(graph, n, m, s)
    jco, jsu = JN.bv_decode_all(graph, n, m, s)
    np.testing.assert_array_equal(pco, jco)
    np.testing.assert_array_equal(psu, jsu)
    np.testing.assert_array_equal(psu, su)
    refs = PN.bv_scan_refs(graph, offsets, s, threads=2)
    np.testing.assert_array_equal(refs,
                                  JN.bv_scan_refs(graph, offsets, s,
                                                  threads=2))
    # ranges of 1..40 nodes from every halo start, as the host fill asks
    W = s.window_size
    rng = np.random.default_rng(n)
    x0 = np.sort(rng.integers(0, n, 12))
    x1 = np.minimum(x0 + rng.integers(1, 40, 12), n)
    p = np.maximum(x0 - W * max(s.max_ref_count, 1), 0)
    init = np.zeros((len(p), max(W, 1)), dtype=np.int64)
    if W:
        yj = p[:, None] - 1 - np.arange(W)[None, :]
        init[yj >= 0] = outd[yj[yj >= 0]]
    arcs = co[x1] - co[x0]
    dst = np.cumsum(arcs) - arcs
    outs = []
    for lib in (PN, JN):
        out = np.full(max(int(arcs.sum()), 1), -1, dtype=np.int64)
        lib.bv_fill_ranges(graph, s, p, x0, x1, offsets[p], init, dst, arcs,
                           out, threads=2)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    exp = np.concatenate([su[co[a]:co[b]] for a, b in zip(x0, x1)])
    np.testing.assert_array_equal(outs[0][:len(exp)], exp)


@pytest.mark.parametrize("bounds", [None, [0, 40, 41, 180, 300]])
@pytest.mark.parametrize("window,maxref", [(0, 3), (3, 1), (7, 3)])
def test_select_refs_equal(bounds, window, maxref):
    """The greedy reference selection over random cost matrices with
    unavailable entries (< 0), empty lists and window resets at the chunk
    bounds."""
    rng = np.random.default_rng(window * 10 + maxref)
    n = 300
    costs = rng.integers(-2, 60, size=(n, window + 1))
    outd = rng.integers(0, 4, size=n)
    cb = np.asarray([0, n] if bounds is None else bounds, dtype=np.int64)
    got = PN.select_refs(costs, outd, window, maxref, cb)
    exp = JN.select_refs(costs, outd, window, maxref, cb)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[0][outd == 0] == 0).all() and (got[1] <= maxref).all()
    with pytest.raises(ValueError):
        PN.select_refs(costs[:, :window], outd, window, maxref, cb)


def test_jax_settings_drive_the_port_library():
    """The port's functions take any object with the settings' fields."""
    co, su = _csr(erdos_renyi(120, 0.08, seed=2))
    s = JSettings(window_size=3, min_interval_length=2)
    got = PN.bv_encode(co, su, s)
    exp = JN.bv_encode(co, su, s)
    np.testing.assert_array_equal(got[0], exp[0])


def test_library_is_built_from_the_port_sources():
    path = PN.lib_path()
    assert "webgraph_tpu_torch" in path and "/build/" in path


def _c_function(path, name):
    """The text of C function ``name`` in ``path``: from its signature to
    the closing brace at column 0."""
    src = open(path).read()
    start = src.index(f"int64_t {name}(")
    return src[start:src.index("\n}\n", start) + 3]


def test_parse_arcs_source_is_the_original():
    """``wg_parse_arcs`` is copied, not rewritten: the port's function text
    equals the JAX package's."""
    import webgraph_tpu.native as jn
    import webgraph_tpu_torch.native as pn
    here = [os.path.join(os.path.dirname(m.__file__), "wgnative.cpp")
            for m in (jn, pn)]
    assert _c_function(here[0], "wg_parse_arcs") == _c_function(
        here[1], "wg_parse_arcs")


@pytest.mark.parametrize("seed", range(4))
def test_parse_arcs_fuzz_equal(seed):
    """Random text of numbers, signs, blanks, comments and junk: both
    libraries parse the same pairs and consume the same bytes, or raise the
    same error, with and without ``eof``."""
    rng = np.random.default_rng(seed)
    pieces = [b"1", b"23", b"-4", b"+5", b" ", b"\t", b"\r", b"\n", b"#",
              b"x", b"9999999999"]
    buf = b"".join(pieces[i] for i in rng.integers(0, len(pieces), 400))
    for eof in (False, True):
        outs = []
        for lib in (JN, PN):
            try:
                s, t, used = lib.parse_arcs(buf, eof=eof)
                outs.append((s.tolist(), t.tolist(), used))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]


def test_hub_parse_source_is_the_original():
    """``wg_bv_hub_parse`` is copied, not rewritten."""
    import webgraph_tpu.native as jn
    import webgraph_tpu_torch.native as pn
    here = [os.path.join(os.path.dirname(m.__file__), "wgnative.cpp")
            for m in (jn, pn)]
    assert _c_function(here[0], "wg_bv_hub_parse") == _c_function(
        here[1], "wg_bv_hub_parse")


_HUB_GRAPHS = {}


def _hub_graph_encoded(res: int, window: int, minint: int):
    """A star (one list of 4,999 arcs) and a dense Erdos-Renyi graph (lists
    of ~1,400 arcs), each encoded once per format: (settings, stream,
    offsets, outdegrees) per graph."""
    key = (res, window, minint)
    if key not in _HUB_GRAPHS:
        s = BVGraphSettings(residual_coding=res, window_size=window,
                            min_interval_length=minint)
        out = []
        for g in (star_graph(5000), erdos_renyi(1200, 0.6, seed=6)):
            co, su = _csr(g)
            graph, _gb, offs, _ob, _st = PN.bv_encode(co, su, s, threads=4)
            offsets = PN.decode_offset_stream(offs, len(co) - 1,
                                              s.offset_coding)
            out.append((s, graph, offsets, np.diff(co)))
        _HUB_GRAPHS[key] = out
    return _HUB_GRAPHS[key]


@pytest.mark.parametrize("arc_q,bit_q", [(64, 1 << 28), (1000, 1 << 28),
                                         (1 << 20, 200)])
@pytest.mark.parametrize("minint", [0, 4])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("res", [C.ZETA, C.GAMMA, C.DELTA])
def test_hub_parse_equal(res, window, minint, arc_q, bit_q):
    """The checkpoint parse of long lists: every field equal to the JAX
    package's, on the longest lists and a run of empty and short ones."""
    segments = 0
    for s, graph, offsets, outd in _hub_graph_encoded(res, window, minint):
        nodes = np.unique(np.concatenate([np.argsort(-outd)[:40],
                                          np.arange(1, 30)]))
        got = PN.hub_parse(graph, nodes, offsets[nodes], outd, s, arc_q,
                           bit_q)
        exp = JN.hub_parse(graph, nodes, offsets[nodes], outd, s, arc_q,
                           bit_q)
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            np.testing.assert_array_equal(got[k], exp[k])
        assert got["res_cnt"].sum() == got["cps"][:, 2].sum()
        segments += len(got["cps"])
    assert segments > 0
