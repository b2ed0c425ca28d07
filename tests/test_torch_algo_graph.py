"""The port's CSR graph, transforms and statistics against the JAX package.

The same graph (``tests/graphs.py`` generators, seeded) goes through
``webgraph_tpu`` on the host and through ``webgraph_tpu_torch`` on CPU
tensors.  Every value is an integer or a ratio of two: exact equality, and
byte-identical stats files.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import transform as T
from webgraph_tpu.algo import scc as JS
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.utils import stats as JST
from webgraph_tpu_torch import state
from webgraph_tpu_torch import transform as PT
from webgraph_tpu_torch.core.graph import CSRGraph, expand_ranges
from webgraph_tpu_torch.utils import stats as PST

from .graphs import (complete_binary_intree, cycle_graph, erdos_renyi,
                     star_graph)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def port(g) -> CSRGraph:
    return state.csr_from_numpy(g.offsets, g.succ, CPU)


def assert_same_graph(p: CSRGraph, j: JCSR):
    assert p.num_nodes == j.num_nodes and p.num_arcs == j.num_arcs
    assert p.offsets.dtype == torch.int64 and p.succ.dtype == torch.int32
    np.testing.assert_array_equal(p.offsets.numpy(), j.offsets)
    np.testing.assert_array_equal(p.succ.numpy(), j.succ)


GRAPHS = {
    "er_sparse": lambda: erdos_renyi(200, 0.02, seed=1),
    "er_loops": lambda: erdos_renyi(120, 0.05, seed=2, loops=True),
    "cycle": lambda: cycle_graph(30),
    "star": lambda: star_graph(40),
    "intree": lambda: complete_binary_intree(5),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("op", ["transpose", "symmetrize", "simplify"])
def test_transform_matches_jax(name, op):
    g = GRAPHS[name]()
    assert_same_graph(getattr(PT, op)(port(g)), getattr(T, op)(g))


@pytest.mark.parametrize("seeds", [(0, 1), (3, 4)])
def test_union_matches_jax(seeds):
    g0 = erdos_renyi(90, 0.04, seed=seeds[0])
    g1 = erdos_renyi(90, 0.04, seed=seeds[1])
    assert_same_graph(PT.union(port(g0), port(g1)), T.union(g0, g1))


def test_union_of_unequal_sizes():
    g0, g1 = cycle_graph(7), star_graph(12)
    assert_same_graph(PT.union(port(g0), port(g1)), T.union(g0, g1))


@pytest.mark.parametrize("dedup", [True, False])
def test_from_arcs_matches_jax(dedup):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 50, 400)
    tgt = rng.integers(0, 50, 400)
    j = JCSR.from_arcs(src, tgt, 60, dedup=dedup)
    p = CSRGraph.from_arcs(torch.from_numpy(src), torch.from_numpy(tgt), 60,
                           dedup=dedup)
    assert_same_graph(p, j)
    assert (p.num_arcs < 400) == dedup


def test_from_arcs_rejects_out_of_range():
    with pytest.raises(ValueError):
        CSRGraph.from_arcs(np.asarray([0, 3]), np.asarray([1, 5]), 5,
                           device=CPU)


def test_host_arrays_name_their_device():
    co, su = np.asarray([0, 1, 1]), np.asarray([1])
    with pytest.raises(ValueError):
        CSRGraph(co, su)
    with pytest.raises(ValueError):
        CSRGraph.from_arcs(np.asarray([0]), np.asarray([1]), 2)
    assert CSRGraph(co, torch.from_numpy(su)).device == CPU
    assert CSRGraph(co, su, device="cpu").num_arcs == 1


def test_graph_contract_matches_jax():
    j = erdos_renyi(80, 0.06, seed=7)
    p = port(j)
    assert_same_graph(CSRGraph.from_lists(
        [j.successors(x) for x in range(80)], CPU), j)
    for x in (0, 17, 79):
        assert p.outdegree(x) == j.outdegree(x)
        np.testing.assert_array_equal(p.successors(x).numpy(),
                                      j.successors(x))
    for (x, a), (y, b) in zip(p.iter_nodes(5), j.iter_nodes(5)):
        assert x == y
        np.testing.assert_array_equal(a.numpy(), b)
    assert_same_graph(p.to_csr(10, 50), j.to_csr(10, 50))
    assert p.to_csr() is p
    for a, b in zip(p.arcs(), j.arcs()):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b)
    assert_same_graph(p.transpose(), j.transpose())


def test_from_decoded_keeps_the_successors():
    j = erdos_renyi(40, 0.1, seed=1)
    succ = torch.from_numpy(j.succ.astype(np.int32))
    p = CSRGraph.from_decoded(j.offsets, succ)
    assert p.succ.data_ptr() == succ.data_ptr()
    assert_same_graph(p, j)
    with pytest.raises(ValueError):
        CSRGraph.from_decoded(j.offsets[:-1], succ)


def test_expand_ranges():
    got = expand_ranges([5, 0, 9], [2, 0, 3], CPU)
    assert got.tolist() == [5, 6, 9, 10, 11]
    assert expand_ranges([], [], CPU).numel() == 0


def _stats_equal(p, j):
    assert list(p) == list(j)
    for k, v in j.items():
        if isinstance(v, np.ndarray):
            assert isinstance(p[k], torch.Tensor)
            np.testing.assert_array_equal(p[k].numpy(), v)
        else:
            assert type(p[k]) is type(v) and p[k] == v, k


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("with_scc", [False, True])
def test_stats_match_jax(tmp_path, name, with_scc):
    g = GRAPHS[name]()
    comp = JS.strongly_connected_components(g)[1] if with_scc else None
    j = JST.compute_stats(g, comp)
    p = PST.compute_stats(port(g), None if comp is None
                          else torch.from_numpy(comp))
    _stats_equal(p, j)
    JST.write_stats(j, str(tmp_path / "j"))
    PST.write_stats(p, str(tmp_path / "p"))
    for ext in (".stats", ".outdegrees", ".indegrees"):
        assert ((tmp_path / ("p" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes())
