"""The port's geometric centralities against the JAX package, on the dense
and on the packed path (forced in both packages with ``DENSE_LIMIT = 1`` and
``PACKED_CHUNK = 97``, as ``tests/test_algo.py`` forces the JAX one).
Float64 sums of the same terms: ``rtol = 1e-12``."""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as J
from webgraph_tpu.algo import centrality as JC
from webgraph_tpu_torch import algo as P
from webgraph_tpu_torch import state
from webgraph_tpu_torch.algo import centrality as PC

from .graphs import cycle_graph, erdos_renyi, star_graph

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-12


def port(g):
    return state.csr_from_numpy(g.offsets, g.succ, CPU)


@pytest.fixture(params=["dense", "packed"])
def path(request, monkeypatch):
    if request.param == "packed":
        for mod in (JC, PC):
            monkeypatch.setattr(mod, "DENSE_LIMIT", 1)
            monkeypatch.setattr(mod, "PACKED_CHUNK", 97)
    return request.param


CASES = {
    "harmonic": (J.harmonic_centrality, P.harmonic_centrality, {}),
    "closeness": (J.closeness_centrality, P.closeness_centrality, {}),
    "exponential": (
        lambda g, **kw: J.linear_geometric_centrality(
            g, lambda d: 0.5 ** d, **kw),
        lambda g, **kw: P.linear_geometric_centrality(
            g, lambda d: 0.5 ** d, **kw),
        {}),
    "harmonic_max_dist": (J.harmonic_centrality, P.harmonic_centrality,
                          dict(max_dist=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gfn,batch", [
    (lambda: erdos_renyi(120, 0.05, seed=3), 32),
    (lambda: erdos_renyi(70, 0.03, seed=1), 256),
    (lambda: star_graph(9), 4),
    (lambda: cycle_graph(6), 4)])
def test_centrality_matches_jax(path, case, gfn, batch):
    jf, pf, kw = CASES[case]
    g = gfn()
    want = jf(g, batch=batch, **kw)
    got = pf(port(g), batch=batch, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_centrality_of_chosen_sources(path):
    g = erdos_renyi(200, 0.02, seed=5)
    sources = np.asarray([199, 3, 3, 77, 150])
    want = J.harmonic_centrality(g, sources=sources, batch=2)
    got = P.harmonic_centrality(port(g), sources=torch.from_numpy(sources),
                                batch=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_popcount():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x12345678])
    assert PC._popcount32(x).tolist() == [0, 1, 32, 2, 13]
