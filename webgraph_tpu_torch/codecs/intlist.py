"""IntegerListImmutableGraph -- the examples/ binary int-list format.

Counterpart of ``webgraph_tpu/codecs/intlist.py`` (examples/
IntegerListImmutableGraph, SURVEY §2.9): big-endian longs, n, then per node
its outdegree followed by its successor list.  An interchange and teaching
format with no device decoder: ``load`` parses it on the host into a
``CSRGraph`` on the CPU, and ``to_device`` moves that graph to the device
(``report["route"]`` "scan").  The files are byte-identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import (CSRGraph, ImmutableGraph, host_csr, host_lists,
                          register_graph_class)
from ..utils import properties as javaprops

__all__ = ["IntegerListImmutableGraph"]

GRAPH_EXTENSION = ".intlist"


@register_graph_class(
    "it.unimi.dsi.big.webgraph.examples.IntegerListImmutableGraph")
class IntegerListImmutableGraph(ImmutableGraph):
    """The graph of a ``CSRGraph`` on any device, with the host contract
    (``successors`` and ``iter_nodes`` give int64 numpy arrays)."""

    def __init__(self, csr: CSRGraph):
        self._csr = csr
        self._host = None
        self.properties = {}

    def _lists(self):
        if self._host is None:
            self._host = host_csr(self._csr)
        return self._host

    @property
    def num_nodes(self) -> int:
        return self._csr.num_nodes

    @property
    def num_arcs(self) -> int:
        return self._csr.num_arcs

    def successors(self, x: int) -> np.ndarray:
        co, su = self._lists()
        return su[co[x]:co[x + 1]]

    def iter_nodes(self, start: int = 0):
        co, su = self._lists()
        for x in range(start, len(co) - 1):
            yield x, su[co[x]:co[x + 1]]

    def to_device(self, device=None) -> CSRGraph:
        """The graph on ``device`` (the GPU when None, the CPU only when the
        caller names it), moved from where ``load`` parsed it."""
        from ..device import require_cuda

        dev = require_cuda() if device is None else torch.device(device)
        g = self._csr
        if g.device != dev:
            g = CSRGraph(g.offsets.to(dev), g.succ.to(dev), device=dev)
        g.report = dict(format=type(self).__name__, route="scan")
        return g

    @classmethod
    def load(cls, basename: str, mode: str = "standard"
             ) -> "IntegerListImmutableGraph":
        """Parse ``basename.intlist`` on the host into a ``CSRGraph`` on the
        CPU (``to_device`` takes it to a device)."""
        raw = np.fromfile(basename + GRAPH_EXTENSION, dtype=">i8")
        n = int(raw[0])
        offs = np.zeros(n + 1, dtype=np.int64)
        heads = np.zeros(n, dtype=np.int64)
        p = 1
        for x in range(n):   # each outdegree says where the next one is
            d = int(raw[p])
            heads[x] = p + 1
            offs[x + 1] = offs[x] + d
            p += d + 1
        cnt = offs[1:] - offs[:-1]
        within = (np.arange(int(offs[-1]), dtype=np.int64)
                  - np.repeat(offs[:-1], cnt))
        succ = raw[np.repeat(heads, cnt) + within].astype(np.int64)
        return cls(CSRGraph(offs, succ, num_nodes=n, device="cpu"))

    @classmethod
    def store(cls, graph, basename: str, **kw) -> None:
        """Write ``basename.intlist`` and its ``.properties`` from a
        ``CSRGraph`` on any device or any graph with ``iter_nodes``."""
        out = [np.asarray([graph.num_nodes], dtype=np.int64)]
        for _, succ in host_lists(graph):
            out.append(np.asarray([len(succ)], dtype=np.int64))
            out.append(np.asarray(succ, dtype=np.int64))
        np.concatenate(out).astype(">i8").tofile(basename + GRAPH_EXTENSION)
        javaprops.dump({
            "graphclass":
                "it.unimi.dsi.big.webgraph.examples.IntegerListImmutableGraph",
            "nodes": str(graph.num_nodes),
        }, basename + ".properties", "IntegerListImmutableGraph properties")
