"""The port's labelling against ``webgraph_tpu/labelling``.

Every case of ``tests/test_labelling.py`` runs through both packages on the
same input (``tests/graphs.py`` generators, labels from a seeded numpy
generator or a formula): the files are byte-identical (``.labels``,
``.labeloffsets``, ``.graph``, ``.offsets``; ``.properties`` bar the date
line), the decoded values and the lists are equal, and every combinator
gives the JAX result arc for arc.  Then the traps: outdegree-0 nodes,
n = 0, the boundary values 2**31 - 1 (gamma) and 2**63 - 1 (a 63-bit list
entry), a truncated ``.labelobl`` and a ``.labeloffsets`` that disagrees
with ``.labels``.  Every comparison is exact.
"""

import io
import os

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as JA
from webgraph_tpu import labelling as JL
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.labelling.graph import filter_labelled as j_filter
from webgraph_tpu.labelling.graph import integer_label_filter as j_ilf
from webgraph_tpu_torch import algo as PA
from webgraph_tpu_torch import labelling as PL
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core import graph as core
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.labelling.graph import filter_labelled
from webgraph_tpu_torch.ops import labelcodec

from .graphs import cycle_graph, erdos_renyi
from .torch_file_cases import edge_graphs, props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (JAX class, port class, extra args): the scalar prototypes
SCALAR = {
    "fixed10": (JL.FixedWidthIntLabel, PL.FixedWidthIntLabel, (10,)),
    "gamma": (JL.GammaCodedIntLabel, PL.GammaCodedIntLabel, ()),
}
LISTS = {
    "int12": (JL.FixedWidthIntListLabel, PL.FixedWidthIntListLabel, 12),
    "long63": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 63),
}


def _pair(g: JCSR, kind: str, vals):
    """The same labelled graph in both packages: scalar ``vals`` per arc
    under the prototype ``kind``."""
    jc, pc, extra = SCALAR[kind]
    jl = [jc("W", *extra, int(v)) for v in vals]
    j = JL.ArcLabelledGraph(g, jl, jc("W", *extra))
    p = PL.ArcLabelledGraph(CSRGraph(g.offsets, g.succ, num_nodes=g.num_nodes,
                                     device=CPU),
                            torch.as_tensor(np.asarray(vals, np.int64)),
                            pc("W", *extra))
    return j, p


def _arc_values(g: JCSR, fn):
    src = np.repeat(np.arange(g.num_nodes), np.diff(g.offsets))
    return fn(src, np.asarray(g.succ, np.int64))


def _same(p, j):
    """A port ArcLabelledGraph equals a JAX one: lists and label values."""
    assert p.num_nodes == j.num_nodes
    np.testing.assert_array_equal(p.graph.offsets.numpy(), j.graph.offsets)
    np.testing.assert_array_equal(p.graph.succ.numpy(), j.graph.succ)
    np.testing.assert_array_equal(p.label_values().numpy(),
                                  [l.value for l in j.labels])


def _same_files(a, b, exts):
    for ext in exts:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    assert props_lines(a + ".properties") == props_lines(b + ".properties")


def _store_both(tmp_path, j, p, name="g"):
    """Underlying graph and label family written by both packages; returns
    the two label basenames."""
    jb, pb = str(tmp_path / ("j" + name)), str(tmp_path / ("p" + name))
    JBV.store(j.graph, jb)
    BVGraph.store(p.graph, pb)
    JL.BitStreamArcLabelledGraph.store(j, jb + "-label", "j" + name)
    PL.BitStreamArcLabelledGraph.store(p, pb + "-label", "j" + name)
    _same_files(jb, pb, (".graph", ".offsets"))
    _same_files(jb + "-label", pb + "-label", (".labels", ".labeloffsets"))
    return jb + "-label", pb + "-label"


@pytest.mark.parametrize("kind", sorted(SCALAR))
def test_bitstream_roundtrip(tmp_path, kind):
    g = erdos_renyi(60, 0.1, seed=0)
    vals = _arc_values(g, lambda x, t: (x * 7 + t) % 1000)
    j, p = _pair(g, kind, vals)
    jb, pb = _store_both(tmp_path, j, p)
    loaded = PL.BitStreamArcLabelledGraph.load(pb)
    assert loaded.num_nodes == g.num_nodes
    for x, succ, labs in loaded.iter_labelled():
        np.testing.assert_array_equal(succ, g.successors(x))
        assert [l.value for l in labs] == [(x * 7 + t) % 1000
                                           for t in succ.tolist()]
    on = loaded.to_device(CPU)
    assert on.equals_labelled(p)
    np.testing.assert_array_equal(
        np.asarray(JL.BitStreamArcLabelledGraph.load(jb).label_offsets),
        loaded.label_offsets)
    # generic dispatch through core.load
    assert isinstance(core.load(pb), PL.BitStreamArcLabelledGraph)
    assert isinstance(core.load(jb), PL.BitStreamArcLabelledGraph)


def _list_pair(g: JCSR, kind: str, entries_of):
    jc, pc, w = LISTS[kind]
    jl, pl = [], []
    for x, succ in g.iter_nodes():
        for t in succ.tolist():
            e = entries_of(x, t)
            jl.append(jc("L", w, e))
            pl.append(pc("L", w, e))
    j = JL.ArcLabelledGraph(g, jl, jc("L", w))
    p = PL.ArcLabelledGraph(CSRGraph(g.offsets, g.succ, device=CPU), pl,
                            pc("L", w))
    return j, p


@pytest.mark.parametrize("kind", sorted(LISTS))
def test_list_labels_roundtrip(tmp_path, kind):
    """[x, t, x + t] per arc, as the JAX case; the 63-bit one also carries
    2**63 - 1 and a list of length 0 on every third arc."""
    g = cycle_graph(10)
    if kind == "long63":
        def entries(x, t):
            return [] if (x + t) % 3 == 0 else [x, (1 << 63) - 1, x + t]
    else:
        def entries(x, t):
            return [x, t, x + t]
    j, p = _list_pair(g, kind, entries)
    _jb, pb = _store_both(tmp_path, j, p)
    loaded = PL.BitStreamArcLabelledGraph.load(pb)
    for x, succ, labs in loaded.iter_labelled():
        for t, l in zip(succ.tolist(), labs):
            np.testing.assert_array_equal(l.value, entries(x, t))
    on = loaded.to_device(CPU)
    assert on.equals_labelled(p)
    for x, succ, labs in on.iter_labelled():
        for t, l in zip(succ.tolist(), labs):
            np.testing.assert_array_equal(l.value, entries(x, t))


def test_label_spec_roundtrip():
    l = PL.FixedWidthIntLabel("FOO", 10)
    assert l.to_spec() == JL.FixedWidthIntLabel("FOO", 10).to_spec()
    l2 = PL.label_from_spec(l.to_spec())
    assert isinstance(l2, PL.FixedWidthIntLabel)
    assert l2.width == 10 and l2.key == "FOO"
    g = PL.label_from_spec(
        "it.unimi.dsi.big.webgraph.labelling.GammaCodedIntLabel(BAR)")
    assert isinstance(g, PL.GammaCodedIntLabel)
    for spec in ("it.unimi.dsi.webgraph.labelling.FixedWidthLongListLabel"
                 "(L,63)",
                 "it.unimi.dsi.big.webgraph.labelling.FixedWidthIntListLabel"
                 "(L,31)"):
        assert PL.label_from_spec(spec).to_spec() == \
            JL.label_from_spec(spec).to_spec()
    with pytest.raises(IOError):
        PL.label_from_spec("com.example.Nope(X)")
    for bad in (lambda: PL.FixedWidthIntLabel("A", 32),
                lambda: PL.FixedWidthIntLabel("A", 3, 8),
                lambda: PL.FixedWidthIntListLabel("A", 32)):
        with pytest.raises(ValueError):
            bad()


def test_fixed_width_detection():
    assert PL.FixedWidthIntLabel("A", 7).fixed_width() == 7
    assert PL.GammaCodedIntLabel("A").fixed_width() == -1
    assert PL.FixedWidthLongListLabel("A", 33).fixed_width() == -1


# -- combinators ---------------------------------------------------------------


def _jax_merge(fn):
    return lambda a, b: JL.GammaCodedIntLabel("W", fn(a.value, b.value))


UNIONS = {
    # the JAX case: both cycles, labels 1 and 2, merged by a sum
    "cycles_sum": (lambda: cycle_graph(6), lambda: cycle_graph(6),
                   lambda x, t: x * 0 + 1, lambda x, t: x * 0 + 2,
                   lambda a, b: a + b),
    # overlapping random graphs of two sizes, a merge whose operands
    # cannot be swapped
    "er_noncommutative": (lambda: erdos_renyi(40, 0.15, seed=1),
                          lambda: erdos_renyi(50, 0.12, seed=2),
                          lambda x, t: (x + 3 * t) % 17,
                          lambda x, t: (5 * x + t) % 13,
                          lambda a, b: a - 2 * b + 100),
}


@pytest.mark.parametrize("name", sorted(UNIONS))
def test_union_labelled(name):
    f0, f1, l0, l1, merge = UNIONS[name]
    g0, g1 = f0(), f1()
    j0, p0 = _pair(g0, "gamma", _arc_values(g0, l0))
    j1, p1 = _pair(g1, "gamma", _arc_values(g1, l1))
    got = PL.union_labelled(p0, p1, merge)
    _same(got, JL.union_labelled(j0, j1, _jax_merge(merge)))
    if name == "cycles_sum":
        assert bool((got.label_values() == 3).all())
    with pytest.raises(ValueError):   # an arc twice in one graph
        dup = CSRGraph([0, 2], [0, 0], device=CPU)
        PL.union_labelled(PL.ArcLabelledGraph(dup, torch.tensor([1, 2]),
                                              p0.prototype),
                          p1, merge)


def test_relabel_and_filter():
    g = erdos_renyi(40, 0.1, seed=1)
    j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: (x + t) % 4))
    doubled = PL.relabel(p, lambda v, x, t: 2 * v + (x < t),
                         PL.GammaCodedIntLabel("W"))
    jd = JL.relabel(j, lambda l, x, t: JL.GammaCodedIntLabel(
        "W", 2 * l.value + (x < t)), JL.GammaCodedIntLabel("W"))
    _same(doubled, jd)
    kept = filter_labelled(p, PL.integer_label_filter(0, 1))
    _same(kept, j_filter(j, j_ilf(0, 1)))
    assert kept.num_arcs == int(np.isin(j.label_values(), [0, 1]).sum())
    for x, succ, labs in kept.iter_labelled():
        assert all(l.value in (0, 1) for l in labs)
    # a predicate on the endpoints too
    kept = filter_labelled(p, lambda v, x, t: (v > 0) & (x != t + 1))
    _same(kept, j_filter(j, lambda l, x, t: l.value > 0 and x != t + 1))


SCC_CASES = {
    # the JAX case: a 3-cycle whose closing arc is filtered away
    "cycle_cut": (lambda: JCSR.from_lists([np.asarray(l, dtype=np.int64)
                                           for l in [[1], [2], [0]]]),
                  lambda x, t: ((x == 2) & (t == 0)).astype(np.int64)),
    "er": (lambda: erdos_renyi(80, 0.05, seed=4),
           lambda x, t: (x * 3 + t) % 3),
}


@pytest.mark.parametrize("name", sorted(SCC_CASES))
def test_scc_labelled_filter(name):
    fg, fl = SCC_CASES[name]
    g = fg()
    j, p = _pair(g, "gamma", _arc_values(g, fl))
    for keep in ((0,), (0, 1), (0, 1, 2)):
        k, comp = PA.strongly_connected_components_labelled(
            p, PL.integer_label_filter(*keep))
        jk, jcomp = JA.strongly_connected_components_labelled(j, j_ilf(*keep))
        assert k == jk
        np.testing.assert_array_equal(comp.numpy(), jcomp)
    if name == "cycle_cut":
        k_all, _ = PA.strongly_connected_components_labelled(
            p, lambda v, x, t: torch.ones_like(v, dtype=torch.bool))
        assert k_all == 1
        k_cut, comp = PA.strongly_connected_components_labelled(
            p, PL.integer_label_filter(0))
        assert k_cut == 3 and len(np.unique(comp.numpy())) == 3


# -- stores --------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["python", "native", "cuda"])
def test_fused_store_labelled_matches_two_pass(tmp_path, backend):
    """BVGraph.store_labelled (the fused pass, BVGraph.java:1735-1853)
    writes byte-identical graph AND label files vs the separate-pass store
    and vs the JAX fused store, in every backend ("cuda" runs its torch
    ops on the CPU here)."""
    g = erdos_renyi(80, 0.08, seed=5)
    j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: (x * 3 + t) % 500))
    for d in ("two", "jax", "port"):
        (tmp_path / d).mkdir()
    a, jb, b = (str(tmp_path / d / "one") for d in ("two", "jax", "port"))
    BVGraph.store(p.graph, a, backend="python")
    PL.BitStreamArcLabelledGraph.store(p, a + "-label", "one")
    jprops = JBV.store_labelled(j, jb, jb + "-label")
    props = BVGraph.store_labelled(p, b, b + "-label", backend=backend,
                                   device=CPU)
    assert props[1] == jprops[1] and props[1]["underlyinggraph"] == "one"
    for other in (a, jb):
        _same_files(other, b, (".graph", ".offsets"))
        _same_files(other + "-label", b + "-label",
                    (".labels", ".labeloffsets"))
    loaded = PL.BitStreamArcLabelledGraph.load(b + "-label")
    for x, succ, labs in loaded.iter_labelled():
        np.testing.assert_array_equal(succ, g.successors(x))
        for t, l in zip(succ.tolist(), labs):
            assert l.value == (x * 3 + t) % 500
    assert loaded.to_device(CPU).equals_labelled(p)


def test_store_labelled_takes_a_sequential_source(tmp_path):
    """Every backend takes a labelled source that is not in memory: the
    fused pass scans it once, the others bring it to the device first."""
    g = erdos_renyi(50, 0.1, seed=3)
    j, p = _pair(g, "fixed10", _arc_values(g, lambda x, t: (x ^ t) % 1000))
    _jb, pb = _store_both(tmp_path, j, p)
    src = PL.BitStreamArcLabelledGraph.load(pb)
    (tmp_path / "jax").mkdir()
    jo = str(tmp_path / "jax" / "out")
    JBV.store_labelled(j, jo)
    for backend in ("python", "native"):
        (tmp_path / backend).mkdir()
        out = str(tmp_path / backend / "out")
        BVGraph.store_labelled(src, out, backend=backend)
        _same_files(jo, out, (".graph", ".offsets"))
        _same_files(jo + "-labelled", out + "-labelled",
                    (".labels", ".labeloffsets"))


def test_labelobl_cache(tmp_path):
    """.labelobl Elias-Fano cache round-trips and is preferred when
    fresh; a truncated one stops the JAX load but the port's falls back to
    .labeloffsets (ROADMAP C4)."""
    g = erdos_renyi(50, 0.1, seed=2)
    j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: x + t))
    jb, pb = _store_both(tmp_path, j, p)
    first = PL.BitStreamArcLabelledGraph.load(pb)
    first.write_label_obl(pb)
    JL.BitStreamArcLabelledGraph.load(jb).write_label_obl(jb)
    with open(pb + ".labelobl", "rb") as a, open(jb + ".labelobl", "rb") as b:
        assert a.read() == b.read()
    again = PL.BitStreamArcLabelledGraph.load(pb)
    np.testing.assert_array_equal(first.label_offsets, again.label_offsets)
    for x, succ, labs in again.iter_labelled():
        for t, l in zip(succ.tolist(), labs):
            assert l.value == x + t
    for path in (pb, jb):
        with open(path + ".labelobl", "r+b") as f:
            f.truncate(os.path.getsize(path + ".labelobl") - 12)
    cut = PL.BitStreamArcLabelledGraph.load(pb)
    np.testing.assert_array_equal(cut.label_offsets, first.label_offsets)
    with pytest.raises((ValueError, IOError)):
        JL.BitStreamArcLabelledGraph.load(jb)
    os.unlink(pb + ".labeloffsets")   # no stream to fall back on: it raises
    with pytest.raises(IOError):
        PL.BitStreamArcLabelledGraph.load(pb)


def test_integer_triples_graph(tmp_path):
    """The reference's worked example (examples/
    IntegerTriplesArcLabelledImmutableGraph.java): triples -> labelled
    graph -> BVGraph + BitStreamArcLabelledImmutableGraph roundtrip."""
    triples = [(0, 2, 5), (2, 1, 0), (0, 1, 7)]
    g = PL.integer_triples_graph(triples, device=CPU)
    _same(g, JL.integer_triples_graph(triples))
    assert g.num_nodes == 3 and g.num_arcs == 3
    assert g.successors(0).tolist() == [1, 2]
    assert [l.value for l in g.labels_of(0)] == [7, 5]
    rng = np.random.default_rng(8)
    t = np.unique(rng.integers(0, 30, size=(200, 2)), axis=0)
    t = np.concatenate([t, rng.integers(0, 1000, (len(t), 1))], 1)
    t = t[rng.permutation(len(t))]
    _same(PL.integer_triples_graph(t, device=CPU),
          JL.integer_triples_graph(t))
    assert PL.integer_triples_graph([], device=CPU).num_nodes == 0
    for bad in ([(0, 1, 1), (0, 1, 2)], [(0, 1, -1)]):
        with pytest.raises(ValueError):
            PL.integer_triples_graph(bad, device=CPU)
        with pytest.raises(ValueError):
            JL.integer_triples_graph(bad)

    text = "0\t2\t5\n2\t1\t0\n0\t1\t7\n"
    base, jbase = str(tmp_path / "tr"), str(tmp_path / "jtr")
    PL.store_integer_triples(io.StringIO(text), base, device=CPU)
    JL.store_integer_triples(io.StringIO(text), jbase)
    _same_files(base + "-underlying", jbase + "-underlying",
                (".graph", ".offsets"))
    for ext in (".labels", ".labeloffsets"):
        with open(base + ext, "rb") as a, open(jbase + ext, "rb") as b:
            assert a.read() == b.read()
    loaded = core.load(base)
    assert loaded.num_nodes == 3
    assert loaded.successors(0).tolist() == [1, 2]
    assert [l.value for l in loaded.labels_of(0)] == [7, 5]


# -- the traps -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(edge_graphs()))
@pytest.mark.parametrize("kind", sorted(SCALAR))
def test_edge_graphs_roundtrip(tmp_path, name, kind):
    """n = 0, a lone node with and without a loop, outdegree-0 nodes
    between others: the same files, a gap of 0 per empty node."""
    g = edge_graphs()[name]
    j, p = _pair(g, kind, _arc_values(g, lambda x, t: (x + 2 * t) % 7))
    _jb, pb = _store_both(tmp_path, j, p)
    back = PL.BitStreamArcLabelledGraph.load(pb).to_device(CPU)
    assert back.equals_labelled(p)
    for backend in ("python", "native", "cuda"):
        b = str(tmp_path / backend)
        BVGraph.store_labelled(p, b, backend=backend, device=CPU)
        with open(pb + ".labeloffsets", "rb") as f, \
                open(b + "-labelled.labeloffsets", "rb") as h:
            assert f.read() == h.read()


def test_boundary_values_roundtrip(tmp_path):
    """Gamma labels up to 2**31 - 1 and beyond 2**32 round-trip through the
    device pack and the native flat decode, equal to the JAX files."""
    g = erdos_renyi(30, 0.2, seed=6)
    m = g.num_arcs
    vals = np.arange(m, dtype=np.int64) % 5
    vals[::3] = (1 << 31) - 1
    vals[1::7] = (1 << 40) + 3
    j, p = _pair(g, "gamma", vals)
    _jb, pb = _store_both(tmp_path, j, p)
    back = PL.BitStreamArcLabelledGraph.load(pb).to_device(CPU)
    np.testing.assert_array_equal(back.label_values().numpy(), vals)


BAD_VALUES = {
    "fixed_too_wide": (PL.FixedWidthIntLabel("A", 4), torch.tensor([3, 16])),
    "fixed_negative": (PL.FixedWidthIntLabel("A", 4), torch.tensor([-1, 1])),
    "gamma_negative": (PL.GammaCodedIntLabel("A"), torch.tensor([0, -2])),
    "list_entry_too_wide": (PL.FixedWidthIntListLabel("A", 3),
                            (torch.tensor([1, 1]), torch.tensor([7, 8]))),
}


@pytest.mark.parametrize("name", sorted(BAD_VALUES))
def test_pack_rejects_values_outside_the_type(name):
    proto, values = BAD_VALUES[name]
    with pytest.raises(ValueError):
        labelcodec.pack_labels(values, torch.tensor([0, 2]), proto)


MISMATCHES = {
    # .labeloffsets of another label stream than .labels
    "fixed_other_width": ("fixed10", lambda d, lo: (d, lo * 11 // 10)),
    "gamma_shifted": ("gamma", lambda d, lo: (d, lo + (lo > 0))),
    "gamma_cut": ("gamma", lambda d, lo: (d[:len(d) // 2], lo)),
    "fixed_cut": ("fixed10", lambda d, lo: (d[:len(d) // 2], lo)),
}


@pytest.mark.parametrize("name", sorted(MISMATCHES))
def test_labeloffsets_disagreeing_with_labels_raise(tmp_path, name):
    kind, spoil = MISMATCHES[name]
    g = erdos_renyi(40, 0.15, seed=9)
    _j, p = _pair(g, kind, _arc_values(g, lambda x, t: (x * t) % 900))
    b = str(tmp_path / "g")
    BVGraph.store(p.graph, b)
    PL.BitStreamArcLabelledGraph.store(p, b + "-label", "g")
    lg = PL.BitStreamArcLabelledGraph.load(b + "-label")
    lg.label_data, lg.label_offsets = spoil(lg.label_data, lg.label_offsets)
    with pytest.raises(ValueError):
        lg.to_device(CPU)


def test_list_labels_disagreeing_with_labeloffsets_raise(tmp_path):
    g = cycle_graph(8)
    _j, p = _list_pair(g, "int12", lambda x, t: [x, t])
    b = str(tmp_path / "g")
    BVGraph.store(p.graph, b)
    PL.BitStreamArcLabelledGraph.store(p, b + "-label", "g")
    lg = PL.BitStreamArcLabelledGraph.load(b + "-label")
    lg.label_offsets = lg.label_offsets + (lg.label_offsets > 30)
    with pytest.raises(ValueError):
        lg.to_device(CPU)


def test_to_device_without_a_card_raises(tmp_path):
    """The entries run on the card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g = cycle_graph(5)
    _j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: x))
    b = str(tmp_path / "g")
    BVGraph.store(p.graph, b)
    PL.BitStreamArcLabelledGraph.store(p, b + "-label", "g")
    with pytest.raises(RuntimeError):
        PL.BitStreamArcLabelledGraph.load(b + "-label").to_device()
    with pytest.raises(RuntimeError):
        BVGraph.store_labelled(p, b, backend="cuda")
    with pytest.raises(RuntimeError):
        PL.integer_triples_graph([(0, 1, 1)])
