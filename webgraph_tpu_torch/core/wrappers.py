"""Graph wrappers / views (SURVEY §2.5).

Counterpart of ``webgraph_tpu/core/wrappers.py``, the same classes and
files:

- :func:`induced_subgraph` -- the materialized induced subgraph, built on
  the graph's device by a node mask, ``expand_ranges`` and one renumbering.
- :class:`ImmutableSubgraph` -- induced subgraph view over a sorted node
  subset with to/from-supergraph mapping and its own on-disk family
  (ImmutableSubgraph.java:49-95: ``.properties`` + ``.subgraphnodes``);
  ``to_device`` takes the supergraph to the device and calls
  :func:`induced_subgraph` there.
- :class:`UnionImmutableGraph` -- lazy arc union view of two graphs
  (UnionImmutableGraph.java:35).
- :class:`BidirectionalImmutableGraph` -- pairs a graph with its transpose
  for indegrees/predecessors/symmetric views
  (BidirectionalImmutableGraph.java:27).

The views keep the host contract (int64 numpy successor lists) over any
graph, a device ``CSRGraph`` included.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .graph import (CSRGraph, ImmutableGraph, expand_ranges, host_lists,
                    load as load_graph, register_graph_class)
from ..utils import properties as javaprops

__all__ = ["ImmutableSubgraph", "UnionImmutableGraph",
           "BidirectionalImmutableGraph", "induced_subgraph"]

SUBGRAPHNODES_EXTENSION = ".subgraphnodes"


def _host_successors(g, x: int) -> np.ndarray:
    """``g.successors(x)`` as int64 numpy, whatever ``g`` keeps."""
    s = g.successors(x)
    if isinstance(s, torch.Tensor):
        return s.cpu().numpy().astype(np.int64)
    return np.asarray(s, dtype=np.int64)


def _on_device(g, device) -> CSRGraph:
    """``g`` as a ``CSRGraph``: a device CSR as it is (or on ``device``
    when named), any other graph through its ``to_device``."""
    if isinstance(g, CSRGraph):
        if device is None or torch.device(device) == g.device:
            return g
        dev = torch.device(device)
        return CSRGraph(g.offsets.to(dev), g.succ.to(dev), device=dev)
    return g.to_device(device)


def induced_subgraph(g, nodes, device=None) -> CSRGraph:
    """Materialized induced subgraph with nodes renumbered 0..k-1, as a
    ``CSRGraph`` on the graph's device.

    ``g``: a ``CSRGraph`` (its device is used) or any graph with
    ``to_device`` (taken to ``device``: the GPU when None, the CPU only when
    the caller names it).  The subset's lists are gathered with one
    ``expand_ranges``, their members kept by a node mask that is also the
    renumbering (subset node -> its rank), in one pass on the device."""
    g = _on_device(g, device)
    dev = g.device
    nodes = torch.unique(torch.as_tensor(nodes, device=dev).to(torch.int64))
    k = nodes.numel()
    rank = torch.full((g.num_nodes,), -1, dtype=torch.int64, device=dev)
    rank[nodes] = torch.arange(k, dtype=torch.int64, device=dev)
    lo = g.offsets[nodes]
    cnt = g.offsets[nodes + 1] - lo
    new = rank[g.succ[expand_ranges(lo, cnt, dev)].to(torch.int64)]
    keep = new >= 0
    row = torch.repeat_interleave(torch.arange(k, device=dev), cnt)[keep]
    new_off = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(row, minlength=k), 0, out=new_off[1:])
    return CSRGraph(new_off, new[keep], num_nodes=k, device=dev)


@register_graph_class(
    "it.unimi.dsi.big.webgraph.ImmutableSubgraph",
    "it.unimi.dsi.webgraph.ImmutableSubgraph",
)
class ImmutableSubgraph(ImmutableGraph):
    """Induced-subgraph view over a sorted node subset.

    Node i of the subgraph is ``nodes[i]`` of the supergraph; successors are
    the supergraph successors that fall in the subset, renumbered."""

    def __init__(self, supergraph, nodes: np.ndarray,
                 properties: Optional[Dict[str, str]] = None):
        self.supergraph = supergraph
        self.nodes = np.asarray(nodes, dtype=np.int64)
        if np.any(np.diff(self.nodes) <= 0):
            raise ValueError("node subset must be sorted")
        self.properties = properties or {}

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_arcs(self) -> int:
        m = 0
        for _, succ in self.iter_nodes():
            m += len(succ)
        return m

    def to_supergraph_node(self, x: int) -> int:
        return int(self.nodes[x])

    def from_supergraph_node(self, y: int) -> int:
        i = int(np.searchsorted(self.nodes, y))
        if i >= len(self.nodes) or self.nodes[i] != y:
            raise ValueError(f"node {y} not in subgraph")
        return i

    def successors(self, x: int) -> np.ndarray:
        sup = _host_successors(self.supergraph, int(self.nodes[x]))
        idx = np.searchsorted(self.nodes, sup)
        idx = np.minimum(idx, len(self.nodes) - 1)
        keep = self.nodes[idx] == sup
        return idx[keep].astype(np.int64)

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        for x in range(start, len(self.nodes)):
            yield x, self.successors(x)

    def to_device(self, device=None) -> CSRGraph:
        """The subgraph on ``device`` (the GPU when None, the CPU only when
        the caller names it): the supergraph through its own device entry,
        then :func:`induced_subgraph` there.  ``report`` names the route
        "induced" and carries the supergraph's report."""
        from ..device import require_cuda

        dev = require_cuda() if device is None else torch.device(device)
        sup = _on_device(self.supergraph, dev)
        g = induced_subgraph(sup, self.nodes)
        g.report = dict(format=type(self).__name__, route="induced",
                        supergraph=sup.report)
        return g

    # -- persistence (ImmutableSubgraph.java:49-95 file family) ----------

    @classmethod
    def store(cls, supergraph_basename: str, nodes: np.ndarray,
              basename: str) -> None:
        nodes = np.asarray(nodes, dtype=np.int64)
        nodes.astype(">i8").tofile(basename + SUBGRAPHNODES_EXTENSION)
        javaprops.dump({
            "graphclass": "it.unimi.dsi.big.webgraph.ImmutableSubgraph",
            "supergraphbasename": supergraph_basename,
            "subgraphnodes": os.path.basename(basename)
                             + SUBGRAPHNODES_EXTENSION,
        }, basename + ".properties", "ImmutableSubgraph properties")

    @classmethod
    def load(cls, basename: str, mode: str = "standard"
             ) -> "ImmutableSubgraph":
        props = javaprops.load(basename + ".properties")
        super_name = props["supergraphbasename"]
        if not os.path.isabs(super_name):
            super_name = os.path.join(os.path.dirname(basename), super_name)
        supergraph = load_graph(super_name, mode=mode)
        nodes = np.fromfile(basename + SUBGRAPHNODES_EXTENSION,
                            dtype=">i8").astype(np.int64)
        return cls(supergraph, nodes, props)


class UnionImmutableGraph(ImmutableGraph):
    """Lazy arc-union view (UnionImmutableGraph.java:35)."""

    def __init__(self, g0, g1):
        self.g0 = g0
        self.g1 = g1
        self.properties = {}

    @property
    def num_nodes(self) -> int:
        return max(self.g0.num_nodes, self.g1.num_nodes)

    @property
    def num_arcs(self) -> int:
        m = 0
        for _, succ in self.iter_nodes():
            m += len(succ)
        return m

    def successors(self, x: int) -> np.ndarray:
        parts = []
        if x < self.g0.num_nodes:
            parts.append(_host_successors(self.g0, x))
        if x < self.g1.num_nodes:
            parts.append(_host_successors(self.g1, x))
        if not parts:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(parts))

    def iter_nodes(self, start: int = 0):
        for x in range(start, self.num_nodes):
            yield x, self.successors(x)


class BidirectionalImmutableGraph(ImmutableGraph):
    """A graph paired with its transpose (BidirectionalImmutableGraph.java:27)."""

    def __init__(self, graph, transpose):
        if graph.num_nodes != transpose.num_nodes:
            raise ValueError("a graph and its transpose have one node count")
        self.forward = graph
        self.backward = transpose
        self.properties = {}

    @property
    def num_nodes(self) -> int:
        return self.forward.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.forward.num_arcs

    def successors(self, x: int) -> np.ndarray:
        return _host_successors(self.forward, x)

    def predecessors(self, x: int) -> np.ndarray:
        return _host_successors(self.backward, x)

    def outdegree(self, x: int) -> int:
        return self.forward.outdegree(x)

    def indegree(self, x: int) -> int:
        return self.backward.outdegree(x)

    def iter_nodes(self, start: int = 0):
        for x, succ in host_lists(self.forward):
            if x >= start:
                yield x, succ

    def symmetrized(self) -> UnionImmutableGraph:
        """The union with the transpose (symmetric view)."""
        return UnionImmutableGraph(self.forward, self.backward)
