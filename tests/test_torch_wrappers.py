"""The port's views, adapters, builder, typed graphs and host helpers
against the JAX package's.

``core/wrappers.py``, ``core/wrap.py``, ``core/incremental.py``,
``typed/__init__.py``, ``utils/hostmap.py``, ``utils/progress.py`` and the
int-list format: the cases of ``tests/test_wrappers.py`` and of
``tests/test_misc.py`` that touch them, run through both packages on the
same inputs (the port on ``device="cpu"``).  Lists, arrays and files are
exactly equal (``.properties`` bar the date line).
"""

import logging

import numpy as np
import pytest
import torch

from webgraph_tpu import transform as JT
from webgraph_tpu import typed as JTY
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.intlist import IntegerListImmutableGraph as JIL
from webgraph_tpu.core import graph as jcore
from webgraph_tpu.core import wrap as JW
from webgraph_tpu.core import wrappers as JWR
from webgraph_tpu.core.incremental import IncrementalGraphBuilder as JInc
from webgraph_tpu.utils import hostmap as JH
from webgraph_tpu.utils import progress as JP
from webgraph_tpu_torch import transform as T
from webgraph_tpu_torch import typed as PTY
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.codecs.intlist import IntegerListImmutableGraph
from webgraph_tpu_torch.core import graph as core
from webgraph_tpu_torch.core import wrap as W
from webgraph_tpu_torch.core import wrappers as WR
from webgraph_tpu_torch.core.graph import CSRGraph, host_csr
from webgraph_tpu_torch.core.incremental import IncrementalGraphBuilder
from webgraph_tpu_torch.utils import hostmap as H
from webgraph_tpu_torch.utils import progress as P

from .graphs import cycle_graph, erdos_renyi, star_graph
from .torch_file_cases import edge_graphs, props_lines

torch.set_num_threads(1)
CPU = "cpu"


def _p(g):
    """The JAX host CSR ``g`` as the port's ``CSRGraph`` on the CPU."""
    return CSRGraph(g.offsets, g.succ, device=CPU)


def _lists(g):
    if isinstance(g, CSRGraph):
        co, su = host_csr(g)
        return [(x, su[co[x]:co[x + 1]].tolist()) for x in range(len(co) - 1)]
    return [(x, np.asarray(s).tolist()) for x, s in g.iter_nodes()]


# -- tests/test_wrappers.py ------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 2), (4, 3), (5, 7)])
def test_induced_subgraph(seed, step):
    g = erdos_renyi(50, 0.2, seed=seed, loops=True)
    nodes = np.arange(0, 50, step)
    want = JWR.induced_subgraph(g, nodes)
    got = WR.induced_subgraph(_p(g), nodes)
    assert got.device == torch.device(CPU)
    assert _lists(got) == _lists(want)
    # unsorted, repeated subsets are a set, as in the JAX function
    shuffled = np.concatenate([nodes[::-1], nodes[:3]])
    assert _lists(WR.induced_subgraph(_p(g), shuffled)) == _lists(want)


def test_induced_subgraph_of_a_file_graph(tmp_path):
    """A host graph goes to the device through its ``to_device``."""
    g = erdos_renyi(60, 0.1, seed=2)
    BVGraph.store(_p(g), str(tmp_path / "g"))
    nodes = np.arange(1, 60, 4)
    got = WR.induced_subgraph(core.load(str(tmp_path / "g")), nodes,
                              device=CPU)
    assert _lists(got) == _lists(JWR.induced_subgraph(g, nodes))


@pytest.mark.parametrize("k", [0, 1, 50])
def test_induced_subgraph_sizes(k):
    g = erdos_renyi(50, 0.2, seed=9)
    nodes = np.arange(k)
    assert _lists(WR.induced_subgraph(_p(g), nodes)) == _lists(
        JWR.induced_subgraph(g, nodes))


def test_subgraph_view_and_mapping():
    g = erdos_renyi(40, 0.2, seed=1)
    nodes = np.asarray([1, 5, 9, 13, 17, 21], dtype=np.int64)
    sub = WR.ImmutableSubgraph(_p(g), nodes)
    jsub = JWR.ImmutableSubgraph(g, nodes)
    assert sub.to_supergraph_node(2) == 9
    assert sub.from_supergraph_node(13) == 3
    with pytest.raises(ValueError):
        sub.from_supergraph_node(2)
    assert sub.num_arcs == jsub.num_arcs
    assert _lists(sub) == _lists(jsub)
    assert _lists(sub.to_device(CPU)) == _lists(
        JWR.induced_subgraph(g, nodes))


def test_subgraph_files(tmp_path):
    g = erdos_renyi(60, 0.1, seed=2)
    JBV.store(g, str(tmp_path / "g"))
    nodes = np.arange(0, 60, 5)
    JWR.ImmutableSubgraph.store("g", nodes, str(tmp_path / "jsub"))
    WR.ImmutableSubgraph.store("g", nodes, str(tmp_path / "psub"))
    assert (tmp_path / "jsub.subgraphnodes").read_bytes() == (
        tmp_path / "psub.subgraphnodes").read_bytes()
    jl, pl = (props_lines(tmp_path / f"{k}sub.properties")
              for k in "jp")
    assert [x.replace("psub", "jsub") for x in pl] == jl
    loaded = core.load(str(tmp_path / "jsub"))
    assert isinstance(loaded, WR.ImmutableSubgraph)
    assert loaded.num_nodes == len(nodes)
    want = _lists(JWR.induced_subgraph(g, nodes))
    assert _lists(loaded) == want
    got = core.load_csr(str(tmp_path / "psub"), device=CPU)
    assert got.report["route"] == "induced"
    assert got.report["supergraph"]["route"] == "kernel"
    assert _lists(got) == want
    assert _lists(jcore.load(str(tmp_path / "psub")).to_csr()) == want


@pytest.mark.parametrize("pair", ["cycle_star", "er_er", "short_long"])
def test_union_view(pair):
    g0, g1 = {"cycle_star": (cycle_graph(8), star_graph(8)),
              "er_er": (erdos_renyi(30, 0.1, seed=1),
                        erdos_renyi(30, 0.1, seed=2)),
              "short_long": (cycle_graph(5), star_graph(9))}[pair]
    u = WR.UnionImmutableGraph(_p(g0), _p(g1))
    ju = JWR.UnionImmutableGraph(g0, g1)
    assert u.num_nodes == ju.num_nodes and u.num_arcs == ju.num_arcs
    assert _lists(u) == _lists(ju)
    assert _lists(u.to_device(CPU)) == _lists(T.union(_p(g0), _p(g1)))


def test_bidirectional():
    g = erdos_renyi(30, 0.15, seed=3)
    bd = WR.BidirectionalImmutableGraph(_p(g), T.transpose(_p(g)))
    jbd = JWR.BidirectionalImmutableGraph(g, JT.transpose(g))
    for x in range(30):
        np.testing.assert_array_equal(bd.successors(x), jbd.successors(x))
        np.testing.assert_array_equal(bd.predecessors(x),
                                      jbd.predecessors(x))
        assert bd.indegree(x) == jbd.indegree(x)
        assert bd.outdegree(x) == jbd.outdegree(x)
    assert bd.num_arcs == jbd.num_arcs
    assert _lists(bd) == _lists(jbd)
    assert list(bd.iter_nodes(7))[0][0] == 7
    assert _lists(bd.symmetrized()) == _lists(jbd.symmetrized())
    assert _lists(bd.symmetrized().to_device(CPU)) == _lists(
        T.symmetrize(_p(g)))


def test_wrap_adapters_roundtrip():
    g = erdos_renyi(60, 0.1, seed=1)
    pg = _p(g)
    sp = W.to_scipy(pg)
    jsp = JW.to_scipy(g)
    assert (sp != jsp).nnz == 0 and sp.dtype == jsp.dtype
    assert _lists(W.from_scipy(sp, device=CPU)) == _lists(g)
    assert _lists(W.wrap(sp, device=CPU)) == _lists(g)
    nxg = W.to_networkx(pg)
    assert sorted(nxg.edges()) == sorted(JW.to_networkx(g).edges())
    assert _lists(W.from_networkx(nxg, device=CPU)) == _lists(
        JW.from_networkx(nxg))
    assert _lists(W.wrap(nxg, device=CPU)) == _lists(g)
    src = np.repeat(np.arange(60), np.diff(g.offsets))
    e = np.stack([src, g.succ], axis=1)
    assert _lists(W.wrap(e, 60, device=CPU)) == _lists(g)
    assert _lists(W.from_edges(e, device=CPU)) == _lists(JW.from_edges(e))
    assert W.wrap(pg) is pg


def test_wrap_undirected_and_rectangular():
    import networkx as nx
    from scipy import sparse
    und = nx.Graph([(3, 7), (7, 9), (9, 3), (1, 1)])
    assert _lists(W.from_networkx(und, device=CPU)) == _lists(
        JW.from_networkx(und))
    rect = sparse.coo_matrix((np.ones(4), ([0, 0, 1, 2], [5, 1, 1, 0])),
                             shape=(3, 6))
    assert _lists(W.from_scipy(rect, device=CPU)) == _lists(
        JW.from_scipy(rect))


def test_wrap_of_a_host_graph(tmp_path):
    g = erdos_renyi(40, 0.1, seed=6)
    BVGraph.store(_p(g), str(tmp_path / "g"))
    got = W.wrap(core.load(str(tmp_path / "g")), device=CPU)
    assert got.report["route"] == "kernel" and _lists(got) == _lists(g)


def test_adapters_need_a_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.from_edges([[0, 1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalGraphBuilder().build()


# -- tests/test_misc.py: incremental, typed, host map, int list ------------

def test_incremental_builder():
    for cls, kw in ((JInc, {}), (IncrementalGraphBuilder,
                                 dict(device=CPU))):
        b = cls()
        b.add([1, 2])
        b.add([])
        b.add([0])
        g = b.build(**kw)
        assert g.num_nodes == 3 and g.num_arcs == 3
        assert _lists(g) == [(0, [1, 2]), (1, []), (2, [0])]
        with pytest.raises(RuntimeError):
            b.add([1])
        b2 = cls()
        b2.add([1])
        g2 = b2.build(num_nodes=5, **kw)
        assert g2.num_nodes == 5 and g2.outdegree(4) == 0
        with pytest.raises(ValueError):
            cls().add([3, 1])


def test_incremental_builder_grows():
    rng = np.random.default_rng(4)
    j, p = JInc(expected_arcs=4), IncrementalGraphBuilder(expected_arcs=4)
    for _ in range(300):
        s = np.unique(rng.integers(0, 500, rng.integers(0, 40)))
        j.add(s)
        p.add(s)
    assert _lists(p.build(device=CPU)) == _lists(j.build())


def _typed_files(base):
    import glob
    import os
    return sorted(os.path.basename(f) for f in glob.glob(base + "*"))


@pytest.mark.parametrize("n,p,k,seed", [(40, 0.15, 3, 0), (60, 0.1, 5, 2),
                                        (30, 0.3, 1, 4)])
def test_typed_graph_files_and_roundtrip(tmp_path, n, p, k, seed):
    g = erdos_renyi(n, p, seed=seed, loops=True)
    types = np.random.default_rng(seed).integers(0, k, n).astype(np.int64)
    types[-1] = k - 1
    jp = JTY.convert_to_typed(g, types, str(tmp_path / "j"))
    pp = PTY.convert_to_typed(_p(g), types, str(tmp_path / "p"))
    assert pp == jp
    jf, pf = _typed_files(str(tmp_path / "j")), _typed_files(
        str(tmp_path / "p"))
    assert [f[1:] for f in jf] == [f[1:] for f in pf]
    for a, b in zip(jf, pf):
        if a.endswith(".properties"):
            assert props_lines(tmp_path / a) == props_lines(tmp_path / b)
        else:
            assert (tmp_path / a).read_bytes() == (tmp_path / b
                                                   ).read_bytes(), a
    tg = PTY.BVTypedGraph(str(tmp_path / "j"), device=CPU)
    jtg = JTY.BVTypedGraph(str(tmp_path / "p"))
    assert (tg.num_nodes, tg.num_arcs, tg.num_types) == (
        jtg.num_nodes, jtg.num_arcs, jtg.num_types)
    assert _lists(tg.type_graph()) == _lists(jtg.type_graph())
    assert tg.type_graph().device == torch.device(CPU)
    local = np.zeros(n, dtype=np.int64)
    counts = np.zeros(k, dtype=np.int64)
    for x in range(n):
        local[x] = counts[types[x]]
        counts[types[x]] += 1
    for x in range(n):
        tx = PTY.node(int(types[x]), int(local[x]))
        np.testing.assert_array_equal(tg.successors(tx), jtg.successors(tx))
        assert tg.outdegree(tx) == g.outdegree(x)
        got = sorted(tg.original_node(int(s)) for s in tg.successors(tx))
        assert got == sorted(g.successors(x).tolist())
    assert [tg.num_nodes_of_type(t) for t in range(k)] == counts.tolist()


def test_typed_packing_helpers():
    for t, i in ((5, 99), (0, 0), (65535, (1 << 48) - 1)):
        x = PTY.node(t, i)
        assert x == JTY.node(t, i)
        assert (PTY.node_type(x), PTY.node_id(x)) == (t, i)
    assert PTY.ID_BITS == JTY.ID_BITS == 48


@pytest.mark.parametrize("seed,k", [(1, 2), (3, 4)])
def test_estimate_typed_size(seed, k):
    g = erdos_renyi(30, 0.2, seed=seed)
    types = (np.arange(30) % k).astype(np.int64)
    est = PTY.estimate_typed_graph_size(_p(g), types)
    jest = JTY.estimate_typed_graph_size(g, types)
    assert est["total_bits"] == jest["total_bits"] > 0
    np.testing.assert_array_equal(est["bits_per_type"],
                                  jest["bits_per_type"])
    np.testing.assert_array_equal(est["nodes_per_type"],
                                  jest["nodes_per_type"])


def test_host_map(tmp_path):
    urls = ["http://example.com/a", "http://example.com/b",
            "https://other.org:8080/x", "http://user@example.com/c", "",
            "ftp://Third.NET/", "no-scheme.org/path"]
    m, hosts = H.build_host_map(urls)
    jm, jhosts = JH.build_host_map(urls)
    assert hosts == jhosts == ["example.com", "other.org", "third.net",
                               "no-scheme.org"]
    np.testing.assert_array_equal(m, jm)
    assert H.host_of("https://Foo.COM:443/bar") == "foo.com"
    H.write_host_map(str(tmp_path / "pm"), str(tmp_path / "ph"), m, hosts)
    JH.write_host_map(str(tmp_path / "jm"), str(tmp_path / "jh"), jm, jhosts)
    for a, b in (("pm", "jm"), ("ph", "jh")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_integer_list_graph(tmp_path):
    g = erdos_renyi(30, 0.15, seed=5)
    IntegerListImmutableGraph.store(_p(g), str(tmp_path / "il"))
    loaded = core.load(str(tmp_path / "il"))
    assert _lists(loaded) == _lists(g)
    assert _lists(loaded.to_device(CPU)) == _lists(g)
    assert _lists(JIL.load(str(tmp_path / "il")).to_csr()) == _lists(g)


@pytest.mark.parametrize("name", ["n0", "one", "one_loop", "isolated"])
def test_views_of_edge_graphs(name):
    g = edge_graphs()[name]
    nodes = np.arange(0, g.num_nodes, 2)
    assert _lists(WR.induced_subgraph(_p(g), nodes)) == _lists(
        JWR.induced_subgraph(g, nodes))
    assert _lists(WR.UnionImmutableGraph(_p(g), _p(g))) == _lists(g)


# -- utils/progress.py -----------------------------------------------------

def test_phase_timer_report_keys():
    for mod in (JP, P):
        t = mod.PhaseTimer()
        with t.phase("plan"):
            pass
        with t.phase("decode"):
            pass
        t.add("plan", 1.5)
        rep = t.report()
        assert list(rep) == ["plan", "decode"]
        assert rep["plan"] >= 1.5 and rep["decode"] >= 0


def test_progress_logger(caplog):
    pl = P.ProgressLogger("nodes", expected_updates=10, log_interval=0.0)
    with caplog.at_level(logging.INFO, logger="webgraph_tpu_torch.progress"):
        pl.start("go")
        pl.update(4)
        pl.light_update()
        pl.done()
    text = caplog.text
    assert "go" in text and "5 nodes" in text and "50.0%" in text
    assert "done: 5 nodes" in text
    quiet = P.null_progress()
    quiet.start("x")
    quiet.update()
    assert quiet.count == 1
    assert sorted(P.__all__) == sorted(JP.__all__)


def test_views_check_their_inputs():
    g = _p(erdos_renyi(10, 0.3, seed=1))
    with pytest.raises(ValueError, match="sorted"):
        WR.ImmutableSubgraph(g, np.asarray([3, 1]))
    with pytest.raises(ValueError, match="node count"):
        WR.BidirectionalImmutableGraph(g, _p(cycle_graph(4)))
    with pytest.raises(ValueError, match="entries"):
        PTY.convert_to_typed(g, np.zeros(3, np.int64), "unused")
