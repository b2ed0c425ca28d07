"""The port's BFS, visits, connected and strongly connected components
against the JAX package, on the same seeded graphs (CPU tensors).  Every
value is an integer: exact equality."""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as J
from webgraph_tpu import transform as T
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu_torch import algo as P
from webgraph_tpu_torch import state
from webgraph_tpu_torch import transform as PT

from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph

torch.set_num_threads(1)
CPU = torch.device("cpu")


def port(g):
    return state.csr_from_numpy(g.offsets, g.succ, CPU)


def lists(*ls):
    return JCSR.from_lists([np.asarray(x, dtype=np.int64) for x in ls])


# -- BFS -------------------------------------------------------------------


@pytest.mark.parametrize("gfn,roots", [
    (lambda: erdos_renyi(80, 0.05, seed=0), [0]),
    (lambda: erdos_renyi(80, 0.05, seed=1), [0]),
    (lambda: erdos_renyi(80, 0.05, seed=2), [0]),
    (lambda: erdos_renyi(60, 0.04, seed=3), [0, 17, 42]),
    (lambda: erdos_renyi(300, 0.004, seed=4), [5, 5, 250]),
    (lambda: cycle_graph(25), [24]),
    (lambda: lists([], [0]), [0])])
def test_bfs_matches_jax(gfn, roots):
    g = gfn()
    jd, jr = J.bfs(g, roots)
    pd, pr = P.bfs(port(g), roots)
    assert pd.dtype == torch.int64 and pr == jr
    np.testing.assert_array_equal(pd.numpy(), jd)


def test_bfs_with_prior_dist_matches_jax():
    g = erdos_renyi(150, 0.02, seed=6)
    prior = np.full(150, -1, dtype=np.int64)
    prior[[3, 40, 41, 99]] = [0, 2, 7, 0]
    jd, jr = J.bfs(g, [10], dist=prior)
    pd, pr = P.bfs(port(g), [10], dist=torch.from_numpy(prior))
    assert pr == jr
    np.testing.assert_array_equal(pd.numpy(), jd)
    assert prior[10] == -1   # the caller's array is not written


@pytest.mark.parametrize("gfn,start", [
    (lambda: cycle_graph(10), 3),
    (lambda: erdos_renyi(100, 0.03, seed=8), 0),
    (lambda: star_graph(30), 7)])
def test_visit_matches_jax(gfn, start):
    g = gfn()
    jq, jc = J.visit(g, start)
    pq, pc = P.visit(port(g), start)
    np.testing.assert_array_equal(pq.numpy(), jq)
    np.testing.assert_array_equal(pc.numpy(), jc)


@pytest.mark.parametrize("gfn", [
    lambda: lists([1], [], [3], []),
    lambda: erdos_renyi(70, 0.01, seed=9),
    lambda: lists([], [], [1], [2, 0], [])])
def test_visit_all_matches_jax(gfn):
    g = gfn()
    np.testing.assert_array_equal(P.visit_all(port(g)).numpy(),
                                  J.visit_all(g))


@pytest.mark.parametrize("gfn,pieces", [
    (lambda: star_graph(100), 4),
    (lambda: erdos_renyi(200, 0.05, seed=1), 7),
    (lambda: cycle_graph(5), 1),
    (lambda: cycle_graph(3), 6)])
def test_arc_balanced_ranges_matches_jax(gfn, pieces):
    g = gfn()
    assert (P.arc_balanced_ranges(port(g).offsets, pieces)
            == J.arc_balanced_ranges(g.offsets, pieces))


# -- connected components ------------------------------------------------


@pytest.mark.parametrize("seed,p", [(0, 0.01), (1, 0.03), (2, 0.1)])
def test_connected_components_match_jax(seed, p):
    g = erdos_renyi(100, p, seed=seed)
    gs = T.symmetrize(g)
    jc = J.connected_components(gs)
    pc = P.connected_components(PT.symmetrize(port(g)))
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(P.compute_sizes(pc).numpy(),
                                  J.compute_sizes(jc))
    np.testing.assert_array_equal(P.sort_by_size(pc).numpy(),
                                  J.sort_by_size(jc))


def test_first_appearance_ids():
    from webgraph_tpu_torch.algo.cc import first_appearance_ids
    lab = torch.tensor([7, 3, 7, 0, 3, 9, 9, 1, 0, 3])
    assert (first_appearance_ids(lab).tolist()
            == [0, 1, 0, 2, 1, 3, 3, 4, 2, 1])


# -- strongly connected components ------------------------------------------


@pytest.mark.parametrize("seed,p", [(0, 0.02), (1, 0.05), (2, 0.1), (3, 0.3)])
def test_scc_matches_jax(seed, p):
    g = erdos_renyi(70, p, seed=seed)
    jk, jc = J.strongly_connected_components(g)
    stats = {}
    pk, pc = P.strongly_connected_components(port(g), stats=stats)
    assert pk == jk and stats["outer"] >= 1
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(P.scc_sizes(pc).numpy(), J.scc_sizes(jc))
    np.testing.assert_array_equal(P.scc_buckets(port(g), pc).numpy(),
                                  J.scc_buckets(g, jc))


@pytest.mark.parametrize("tail", [[], [6]])
def test_scc_structured_matches_jax(tail):
    g = lists([1], [2], [0, 3], [4], [5], [3, 6], tail)
    jk, jc = J.strongly_connected_components(g)
    pk, pc = P.strongly_connected_components(port(g))
    assert pk == jk == 3
    np.testing.assert_array_equal(pc.numpy(), jc)
    pb = P.scc_buckets(port(g), pc)
    np.testing.assert_array_equal(pb.numpy(), J.scc_buckets(g, jc))
    assert int(pb.sum()) == len(tail)


@pytest.mark.parametrize("gfn", [lambda: complete_graph(12),
                                 lambda: lists([0], [], [2, 1])])
def test_scc_loops_and_cliques_match_jax(gfn):
    g = gfn()
    jk, jc = J.strongly_connected_components(g)
    pk, pc = P.strongly_connected_components(port(g))
    assert pk == jk
    np.testing.assert_array_equal(pc.numpy(), jc)
    np.testing.assert_array_equal(P.scc_buckets(port(g), pc).numpy(),
                                  J.scc_buckets(g, jc))
