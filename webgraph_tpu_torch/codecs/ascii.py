"""ASCII import/export formats.

Counterpart of ``webgraph_tpu/codecs/ascii.py``, the same classes and files:

- :class:`ASCIIGraph` -- ``basename.graph-txt`` (or ``.graph-txt.gz``):
  first line n, then one line of sorted successors per node (reference
  ASCIIGraph.java:55-70).  A host format: ``load`` reads it (sequentially in
  "offline" mode, into host arrays in "standard"), and ``to_device`` scans it
  and uploads the CSR (``report["route"]`` "scan").
- :class:`ArcListASCIIGraph` -- one arc per line, sources nondecreasing,
  optional shift (reference ArcListASCIIGraph.java:54-75).  The lines are
  read by the native arc parser, and the CSR is built by
  ``CSRGraph.from_arcs`` on the graph's device.
- :class:`ShiftedByOneArcListASCIIGraph` -- the arc list with ids from 1.
"""

from __future__ import annotations

import gzip
import os
from typing import IO, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from ..core.graph import (CSRGraph, ImmutableGraph, host_csr, host_lists,
                          register_graph_class)

__all__ = ["ASCIIGraph", "ArcListASCIIGraph", "ShiftedByOneArcListASCIIGraph"]

GRAPH_TXT_EXTENSION = ".graph-txt"


def _open_text(path: str) -> IO[str]:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _parse_line(line: str) -> np.ndarray:
    return (np.fromstring(line, dtype=np.int64, sep=" ")
            if line.strip() else np.zeros(0, dtype=np.int64))


@register_graph_class(
    "it.unimi.dsi.big.webgraph.ASCIIGraph",
    "it.unimi.dsi.webgraph.ASCIIGraph",
)
class ASCIIGraph(ImmutableGraph):
    """A ``.graph-txt`` graph: sequential access backed by the file, or
    random access once its lists are read into host arrays
    (``load(mode="standard")``)."""

    def __init__(self, path: str, num_nodes: int):
        self.path = path
        self._n = num_nodes
        self._csr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.properties = {"graphclass": "it.unimi.dsi.big.webgraph.ASCIIGraph",
                           "nodes": str(num_nodes)}

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        if self._csr is not None:
            return int(self._csr[0][-1])
        m = 0
        for _, succ in self.iter_nodes():
            m += len(succ)
        return m

    @property
    def random_access(self) -> bool:
        return self._csr is not None

    def successors(self, x: int) -> np.ndarray:
        if self._csr is None:
            raise RuntimeError("ASCIIGraph is sequential-only; use "
                               "load(mode='standard') or to_device()")
        co, su = self._csr
        return su[co[x]:co[x + 1]]

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        if self._csr is not None:
            co, su = self._csr
            for x in range(start, self._n):
                yield x, su[co[x]:co[x + 1]]
            return
        with _open_text(self.path) as f:
            if int(f.readline()) != self._n:
                raise IOError(f"{self.path} changed since it was loaded")
            n = self._n
            for x in range(n):
                line = f.readline()
                if x >= start:
                    yield x, _parse_line(line)

    def to_csr(self, lo: int = 0, hi: Optional[int] = None, *,
               device) -> CSRGraph:
        """Nodes [lo, hi) as a ``CSRGraph`` on ``device``: the host arrays
        when loaded, else one scan of the file."""
        co, su = self._csr if self._csr is not None else host_csr(self)
        hi = self._n if hi is None else hi
        return CSRGraph(co[lo:hi + 1] - co[lo], su[co[lo]:co[hi]],
                        num_nodes=hi - lo, device=device)

    @classmethod
    def load(cls, basename: str, mode: str = "offline") -> "ASCIIGraph":
        """The graph at ``basename.graph-txt`` (or ``.graph-txt.gz``):
        sequential over the file in "offline"/"once" mode; in "standard" or
        "mapped" mode its lists are read into host arrays (random access)."""
        path = basename + GRAPH_TXT_EXTENSION
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path += ".gz"
        with _open_text(path) as f:
            n = int(f.readline())
        g = cls(path, n)
        if mode in ("standard", "mapped"):
            g._csr = host_csr(g)
        return g

    @classmethod
    def load_once(cls, stream: IO[str]) -> Iterator[Tuple[int, np.ndarray]]:
        """Single-pass streaming parse from an open text stream."""
        n = int(stream.readline())
        for x in range(n):
            yield x, _parse_line(stream.readline())

    @classmethod
    def store(cls, graph, basename: str, **kwargs) -> None:
        """Write ``basename.graph-txt`` from a ``CSRGraph`` on any device
        (brought to the host once) or any graph with ``iter_nodes``."""
        with open(basename + GRAPH_TXT_EXTENSION, "w") as f:
            f.write(f"{graph.num_nodes}\n")
            for _, succ in host_lists(graph):
                f.write(" ".join(map(str, succ.tolist())))
                f.write("\n")


@register_graph_class(
    "it.unimi.dsi.big.webgraph.ArcListASCIIGraph",
    "it.unimi.dsi.webgraph.ArcListASCIIGraph",
)
class ArcListASCIIGraph(ImmutableGraph):
    """One arc per line ("source<TAB-or-space>target"), sources
    nondecreasing; blank and '#' lines are skipped.

    ``shift`` is added to every id on input (ArcListASCIIGraph.java:54-75).
    The number of nodes is one plus the largest id seen.  The CSR is built
    on ``device`` (the GPU when None, the CPU only when the caller names
    it); the host contract (``successors``, ``iter_nodes``) reads it back
    as int64 numpy arrays."""

    def __init__(self, path: str, shift: int = 0, device=None):
        from ..device import require_cuda

        self.path = path
        self.shift = shift
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self._csr: Optional[CSRGraph] = None
        self._host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.properties = {}

    def _materialize(self) -> CSRGraph:
        if self._csr is None:
            src, tgt, _ = _native.parse_arcs(_read_bytes(self.path), eof=True)
            src += self.shift
            tgt += self.shift
            if len(src) and np.any(np.diff(src) < 0):
                raise ValueError("sources must be nondecreasing")
            n = int(max(src.max(initial=-1), tgt.max(initial=-1))) + 1
            self._csr = CSRGraph.from_arcs(
                torch.from_numpy(src).to(self.device),
                torch.from_numpy(tgt).to(self.device), n, dedup=False,
                device=self.device)
        return self._csr

    def _lists(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._host is None:
            self._host = host_csr(self._materialize())
        return self._host

    @property
    def num_nodes(self) -> int:
        return self._materialize().num_nodes

    @property
    def num_arcs(self) -> int:
        return self._materialize().num_arcs

    def successors(self, x: int) -> np.ndarray:
        co, su = self._lists()
        return su[co[x]:co[x + 1]]

    def iter_nodes(self, start: int = 0):
        co, su = self._lists()
        for x in range(start, len(co) - 1):
            yield x, su[co[x]:co[x + 1]]

    def to_device(self, device=None) -> CSRGraph:
        """The CSR on ``device`` (this graph's device when None): built
        from the host parse, so ``report["route"]`` is "scan"."""
        g = self._materialize()
        dev = self.device if device is None else torch.device(device)
        if g.device != dev:
            g = CSRGraph(g.offsets.to(dev), g.succ.to(dev), device=dev)
        g.report = dict(format=type(self).__name__, route="scan")
        return g

    @classmethod
    def load(cls, basename: str, mode: str = "standard", shift: int = 0,
             device=None):
        """``basename`` is the arc-list file itself.  "standard"/"mapped":
        the ``CSRGraph`` on ``device``; otherwise the lazy graph."""
        g = cls(basename, shift=shift, device=device)
        if mode in ("standard", "mapped"):
            return g._materialize()
        return g

    @classmethod
    def store(cls, graph, basename: str, shift: int = 0, **kwargs) -> None:
        """Write one ``source<TAB>target`` line per arc, ids shifted by
        ``shift``, from a ``CSRGraph`` on any device or any graph with
        ``iter_nodes``."""
        with open(basename, "w") as f:
            for x, succ in host_lists(graph):
                for t in succ.tolist():
                    f.write(f"{x + shift}\t{t + shift}\n")


@register_graph_class("it.unimi.dsi.big.webgraph.ShiftedByOneArcListASCIIGraph")
class ShiftedByOneArcListASCIIGraph(ArcListASCIIGraph):
    """Arc-list variant with ids starting from 1 (shift = -1 on load)."""

    @classmethod
    def load(cls, basename: str, mode: str = "standard", shift: int = -1,
             device=None):
        return ArcListASCIIGraph.load(basename, mode=mode, shift=-1,
                                      device=device)

    @classmethod
    def store(cls, graph, basename: str, **kwargs) -> None:
        ArcListASCIIGraph.store(graph, basename, shift=1)
