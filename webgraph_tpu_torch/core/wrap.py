"""Ecosystem adapters -- the analogue of the reference's standard<->big
wrappers (ImmutableGraph.wrap, ImmutableGraph.java:920/:1039, which bridge
the int-node and long-node webgraph worlds).

Counterpart of ``webgraph_tpu/core/wrap.py``: scipy.sparse adjacency
matrices, NetworkX digraphs and raw edge arrays wrap into a
:class:`~webgraph_tpu_torch.core.graph.CSRGraph` on a named device (the GPU
when None, the CPU only when the caller names it) and back, so any
workflow (compress / transform / analyze) can start or end outside the
framework.  ``networkx`` is imported only by its two adapters.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import CSRGraph, ImmutableGraph, host_csr, host_lists

__all__ = ["wrap", "from_scipy", "to_scipy", "from_networkx",
           "to_networkx", "from_edges"]


def _device(device) -> torch.device:
    from ..device import require_cuda

    return require_cuda() if device is None else torch.device(device)


def from_scipy(mat, device=None) -> CSRGraph:
    """Wrap a scipy.sparse matrix (any format) as a graph: nonzero (i, j)
    becomes the arc i -> j; successor lists come out sorted/deduped."""
    m = mat.tocsr()
    n = max(m.shape)
    indptr = np.asarray(m.indptr, dtype=np.int64)
    if m.shape[0] < n:
        indptr = np.concatenate([
            indptr, np.full(n - m.shape[0], indptr[-1], dtype=np.int64)])
    indices = np.asarray(m.indices, dtype=np.int64)
    # csr column indices are not guaranteed sorted; normalize via arc sort
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dev = _device(device)
    return CSRGraph.from_arcs(torch.from_numpy(src).to(dev),
                              torch.from_numpy(indices).to(dev), n,
                              device=dev)


def to_scipy(g):
    """The inverse adapter: graph -> scipy.sparse.csr_matrix of 1s."""
    from scipy import sparse

    co, su = host_csr(g)
    n = g.num_nodes
    return sparse.csr_matrix(
        (np.ones(len(su), dtype=np.int8), su, co), shape=(n, n))


def from_networkx(nxg, device=None) -> CSRGraph:
    """Wrap a NetworkX (Di)Graph with integer-labelable nodes; nodes are
    relabelled densely in sorted order."""
    nodes = sorted(nxg.nodes())
    idx = {v: i for i, v in enumerate(nodes)}
    src = np.asarray([idx[u] for u, _ in nxg.edges()], dtype=np.int64)
    tgt = np.asarray([idx[v] for _, v in nxg.edges()], dtype=np.int64)
    if not nxg.is_directed():
        src, tgt = np.concatenate([src, tgt]), np.concatenate([tgt, src])
    return CSRGraph.from_arcs(src, tgt, len(nodes), device=_device(device))


def to_networkx(g):
    """The inverse adapter: graph -> networkx.DiGraph."""
    import networkx as nx

    out = nx.DiGraph()
    out.add_nodes_from(range(g.num_nodes))
    for x, succ in host_lists(g):
        out.add_edges_from((x, int(t)) for t in succ)
    return out


def from_edges(edges, num_nodes: int = -1, device=None) -> CSRGraph:
    """Wrap an (m, 2) array-like of arcs."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if num_nodes < 0:
        num_nodes = int(e.max(initial=-1)) + 1
    return CSRGraph.from_arcs(np.ascontiguousarray(e[:, 0]),
                              np.ascontiguousarray(e[:, 1]), num_nodes,
                              device=_device(device))


def wrap(obj, num_nodes: int = -1, device=None) -> CSRGraph:
    """Polymorphic adapter (the ImmutableGraph.wrap analogue): accepts a
    ``CSRGraph`` (passed through), any other graph (through its
    ``to_device``), a scipy.sparse matrix, a NetworkX graph, or an (m, 2)
    edge array."""
    if isinstance(obj, CSRGraph):
        return obj
    if isinstance(obj, ImmutableGraph):
        return obj.to_device(device)
    if hasattr(obj, "tocsr"):
        return from_scipy(obj, device)
    if hasattr(obj, "edges") and hasattr(obj, "nodes"):
        return from_networkx(obj, device)
    return from_edges(obj, num_nodes, device)
