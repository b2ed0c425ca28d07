"""Graphs: the host graph contract, file dispatch, and the device CSR.

Counterpart of ``webgraph_tpu/core/graph.py``:

- ``ImmutableGraph`` (``:53-140``), the host contract of the graph files
  (``codecs/bvgraph.py``, ``codecs/efgraph.py``): sorted int64 numpy
  successor lists, random access and sequential scans;
- ``GRAPH_CLASS_REGISTRY``, ``register_graph_class``, ``load`` and ``store``
  (``:38-50``, ``:226-258``): dispatch on a basename's ``graphclass``
  property, the big and the standard Java names alike;
- ``CSRGraph`` (``:142-223``), here on a device: offsets int64[n+1] and
  successors int32[m], both on one device (the JAX package keeps int64
  numpy arrays on the host and uploads per call).  Every method works on
  that device: sorting, deduplication and the per-arc source index are
  torch ops there.  ``from_decoded`` wraps the output of
  ``ops.csr.decode_to_csr`` without bringing the successors to the host;
- ``load_csr``, the device entry: a basename of any registered format to a
  ``CSRGraph`` on the GPU (or on a device the caller names).  Formats with a
  device decoder (BVGraph, EFGraph) decode there; the others (ASCII,
  int-list, views) are scanned on the host by ``ImmutableGraph.to_device``
  and uploaded, which their ``report["route"]`` says ("scan").
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import properties as javaprops

__all__ = ["CSRGraph", "expand_ranges", "ImmutableGraph", "load", "store",
           "load_csr", "register_graph_class", "GRAPH_CLASS_REGISTRY",
           "host_csr", "host_lists"]

PROPERTIES_EXTENSION = ".properties"

_INT32_LIMIT = 1 << 31


def expand_ranges(first, cnt, device) -> torch.Tensor:
    """repeat(first, cnt) + offsets within each run, int64 on ``device``:
    the positions of the ranges [first, first + cnt), concatenated."""
    first = torch.as_tensor(first, dtype=torch.int64, device=device)
    cnt = torch.as_tensor(cnt, dtype=torch.int64, device=device)
    total = int(cnt.sum()) if len(cnt) else 0
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    starts = torch.cumsum(cnt, 0) - cnt
    within = (torch.arange(total, device=device)
              - torch.repeat_interleave(starts, cnt, output_size=total))
    return torch.repeat_interleave(first, cnt, output_size=total) + within


def _on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def _device_of(x, device) -> torch.device:
    """``device`` when given, else the device of tensor ``x``: host arrays
    name their device explicitly."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    raise ValueError("host arrays: pass the device explicitly")


class CSRGraph:
    """CSR graph on ``device``: ``offsets`` int64[n+1], ``succ`` int32[m].
    ``device`` defaults to the successors' own when they are a tensor."""

    #: set by the file entries (``load_csr``, ``to_device``): the format,
    #: the route the decode took and its stages' seconds; else None
    report: Optional[dict] = None

    def __init__(self, offsets, successors, num_nodes: Optional[int] = None,
                 device=None):
        device = _device_of(successors, device)
        self.offsets = _on(offsets, device, torch.int64)
        self.succ = _on(successors, device, torch.int32)
        n = self.offsets.numel() - 1 if num_nodes is None else num_nodes
        if self.offsets.dim() != 1 or self.offsets.numel() != n + 1:
            raise ValueError(f"offsets must have n+1 = {n + 1} entries")
        if n >= _INT32_LIMIT:
            raise ValueError("node ids must fit int32")
        self._n = int(n)
        self._src: Optional[torch.Tensor] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_lists(cls, lists, device) -> "CSRGraph":
        offs = np.zeros(len(lists) + 1, dtype=np.int64)
        for i, lst in enumerate(lists):
            offs[i + 1] = offs[i] + len(lst)
        succ = (np.concatenate([np.asarray(lst, dtype=np.int64)
                                for lst in lists])
                if len(lists) else np.zeros(0, dtype=np.int64))
        return cls(offs, succ, device=device)

    @classmethod
    def from_arcs(cls, sources, targets, num_nodes: int, dedup: bool = True,
                  device=None) -> "CSRGraph":
        """Build from unsorted arc arrays: one device sort of the keys
        ``(src << 32) | tgt`` (lexicographic order), then optional dedup."""
        device = _device_of(sources, device)
        src = _on(sources, device, torch.int64)
        tgt = _on(targets, device, torch.int64)
        if src.shape != tgt.shape or src.dim() != 1:
            raise ValueError("sources and targets must be 1-D of one length")
        if src.numel() and (min(int(src.min()), int(tgt.min())) < 0
                            or max(int(src.max()), int(tgt.max()))
                            >= num_nodes):
            raise ValueError(f"arc endpoints must lie in [0, {num_nodes})")
        key = (src << 32) | tgt
        del src, tgt
        key = torch.unique(key) if dedup else torch.sort(key).values
        counts = torch.bincount(key >> 32, minlength=num_nodes)
        offsets = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
        torch.cumsum(counts, 0, out=offsets[1:])
        return cls(offsets, (key & 0xFFFFFFFF).to(torch.int32),
                   num_nodes=num_nodes, device=device)

    @classmethod
    def from_decoded(cls, csr_off, succ: torch.Tensor) -> "CSRGraph":
        """Wrap ``decode_to_csr``'s (host int64 offsets, device int32
        successors): the offsets are uploaded once, the successors stay."""
        off = np.asarray(csr_off, dtype=np.int64)
        if off[0] != 0 or off[-1] != succ.numel():
            raise ValueError("offsets must run from 0 to len(succ)")
        return cls(off, succ, device=succ.device)

    # -- the graph contract ------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.succ.device

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        return self.succ.numel()

    def outdegrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def outdegree(self, x: int) -> int:
        lo, hi = self.offsets[x:x + 2].tolist()
        return hi - lo

    def successors(self, x: int) -> torch.Tensor:
        lo, hi = self.offsets[x:x + 2].tolist()
        return self.succ[lo:hi]

    def iter_nodes(self, start: int = 0
                   ) -> Iterator[Tuple[int, torch.Tensor]]:
        offs = self.offsets.tolist()
        for x in range(start, self._n):
            yield x, self.succ[offs[x]:offs[x + 1]]

    def to_csr(self, lo: int = 0, hi: Optional[int] = None) -> "CSRGraph":
        """Nodes [lo, hi) as a CSR graph, offsets renumbered to 0."""
        if lo == 0 and (hi is None or hi == self._n):
            return self
        hi = self._n if hi is None else hi
        a, b = int(self.offsets[lo]), int(self.offsets[hi])
        return CSRGraph(self.offsets[lo:hi + 1] - a, self.succ[a:b],
                        num_nodes=hi - lo, device=self.device)

    def arc_sources(self) -> torch.Tensor:
        """Source node of every arc, int32[m], built once and kept."""
        if self._src is None:
            self._src = torch.repeat_interleave(
                torch.arange(self._n, dtype=torch.int32, device=self.device),
                self.outdegrees(), output_size=self.num_arcs)
        return self._src

    def arcs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sources, targets) int64 arc arrays in lexicographic order."""
        return (self.arc_sources().to(torch.int64),
                self.succ.to(torch.int64))

    def transpose(self) -> "CSRGraph":
        return CSRGraph.from_arcs(self.succ, self.arc_sources(), self._n,
                                  dedup=False, device=self.device)


# -- the host contract and file dispatch ------------------------------------

#: Maps the ``graphclass`` property value to the loader class.  Both the big
#: (64-bit) and standard (32-bit) Java class names map to the same class:
#: the on-disk formats are identical (ImmutableGraph.java:920/:1039).
GRAPH_CLASS_REGISTRY: Dict[str, type] = {}
_CODECS = ("codecs.bvgraph", "codecs.efgraph", "codecs.ascii",
           "codecs.intlist", "labelling.graph")


def register_graph_class(*java_names):
    """Class decorator registering Java ``graphclass`` aliases for a loader."""

    def deco(cls):
        for name in java_names:
            GRAPH_CLASS_REGISTRY[name] = cls
        cls.java_class_names = java_names
        return cls

    return deco


class ImmutableGraph:
    """Base class of the host graphs of the file layer.

    Subclasses implement :attr:`num_nodes`, :attr:`num_arcs`,
    :meth:`successors` (random access, where supported) and
    :meth:`iter_nodes` (sequential access); successor lists are sorted int64
    numpy arrays.
    """

    properties: Dict[str, str]

    @property
    def num_nodes(self) -> int:
        raise NotImplementedError

    @property
    def num_arcs(self) -> int:
        raise NotImplementedError

    @property
    def random_access(self) -> bool:
        return True

    def outdegree(self, x: int) -> int:
        return len(self.successors(x))

    def successors(self, x: int) -> np.ndarray:
        """Sorted int64 array of successors of node ``x``."""
        raise NotImplementedError

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        """Sequential scan yielding ``(node, successors)`` pairs from
        ``start``."""
        for x in range(start, self.num_nodes):
            yield x, self.successors(x)

    def split_ranges(self, pieces: int) -> List[Tuple[int, int]]:
        """Contiguous [lo, hi) node ranges for parallel scans (the
        analogue of splitNodeIterators, ImmutableGraph.java:405)."""
        n = self.num_nodes
        if pieces <= 0:
            raise ValueError("pieces must be positive")
        bounds = np.linspace(0, n, pieces + 1).astype(np.int64)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(pieces)]

    def to_csr(self, lo: int = 0, hi: Optional[int] = None, *,
               device) -> "CSRGraph":
        """Nodes [lo, hi), scanned on the host, as a ``CSRGraph`` on
        ``device`` (offsets renumbered to 0)."""
        hi = self.num_nodes if hi is None else hi
        offs = [0]
        chunks = []
        for x, succ in self.iter_nodes(lo):
            if x >= hi:
                break
            chunks.append(np.asarray(succ, dtype=np.int64))
            offs.append(offs[-1] + len(chunks[-1]))
        succ = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
        return CSRGraph(np.asarray(offs, dtype=np.int64), succ,
                        num_nodes=hi - lo, device=device)

    def to_device(self, device=None) -> "CSRGraph":
        """The whole graph as a ``CSRGraph`` on ``device`` (the GPU when
        None, the CPU only when the caller names it): scanned on the host
        and uploaded, for formats with no device decoder.  The result's
        ``report`` says so (``route`` "scan") and times the scan and upload
        on the host clock, ending in a synchronise."""
        from ..device import require_cuda

        dev = require_cuda() if device is None else torch.device(device)
        t0 = time.perf_counter()
        g = self.to_csr(device=dev)
        sync(dev)
        g.report = dict(format=type(self).__name__, route="scan",
                        scan_s=time.perf_counter() - t0)
        return g

    def equals(self, other) -> bool:
        """Successor-list equality (ImmutableGraph.java equals)."""
        if self.num_nodes != other.num_nodes:
            return False
        for (x, a), (y, b) in zip(self.iter_nodes(), other.iter_nodes()):
            a = np.asarray(a, dtype=np.int64)
            b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b,
                           dtype=np.int64)
            if x != y or not np.array_equal(a, b):
                return False
        return True

    @classmethod
    def load(cls, basename: str, mode: str = "standard") -> "ImmutableGraph":
        raise NotImplementedError

    @classmethod
    def store(cls, graph, basename: str, **kwargs):
        raise NotImplementedError


def host_csr(graph) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64[n+1], successors int64[m]) numpy arrays of a
    ``CSRGraph`` on any device (brought to the host once), of a graph with
    ``iter_blocks`` (blocks of nodes as CSR pieces), or of any graph with
    ``iter_nodes``."""
    if isinstance(graph, CSRGraph):
        return (graph.offsets.cpu().numpy(),
                graph.succ.cpu().to(torch.int64).numpy())
    if hasattr(graph, "iter_blocks"):
        offs, lists, base = [np.zeros(1, dtype=np.int64)], [], 0
        for _x, _hi, at, tgt in graph.iter_blocks():
            offs.append(at[1:] + base)
            lists.append(tgt)
            base += len(tgt)
        return (np.concatenate(offs),
                np.concatenate(lists) if lists else np.zeros(0, np.int64))
    offs = [0]
    lists = []
    for _x, succ in graph.iter_nodes():
        lists.append(np.asarray(succ, dtype=np.int64))
        offs.append(offs[-1] + len(lists[-1]))
    return (np.asarray(offs, dtype=np.int64),
            np.concatenate(lists) if lists else np.zeros(0, np.int64))


def host_lists(graph) -> Iterator[Tuple[int, np.ndarray]]:
    """(node, int64 numpy successors) pairs of a ``CSRGraph`` on any
    device or of any graph with ``iter_nodes``."""
    if isinstance(graph, CSRGraph):
        co, su = host_csr(graph)
        for x in range(len(co) - 1):
            yield x, su[co[x]:co[x + 1]]
    else:
        for x, succ in graph.iter_nodes():
            yield x, np.asarray(succ, dtype=np.int64)


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load(basename: str, mode: str = "standard") -> ImmutableGraph:
    """Load any graph by its ``.properties`` file (ImmutableGraph.java:674).
    ``mode``: "standard" (in memory), "mapped" (memory-map the stream),
    "offline"/"once"/"sequential" (no offsets: sequential access only)."""
    props = javaprops.load(basename + PROPERTIES_EXTENSION)
    gc = props.get("graphclass", "").replace("class ", "").strip()
    if gc not in GRAPH_CLASS_REGISTRY:
        # codec classes register themselves on import
        for mod in _CODECS:
            importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.{mod}")
    cls = GRAPH_CLASS_REGISTRY.get(gc)
    if cls is None:
        raise IOError(f"Unknown graphclass {gc!r} for basename {basename!r}")
    return cls.load(basename, mode=mode)


def store(graph, basename: str, graph_class=None, **kwargs):
    """Store ``graph`` with the given codec class (default BVGraph)."""
    if graph_class is None:
        from ..codecs.bvgraph import BVGraph as graph_class  # noqa: N813
    return graph_class.store(graph, basename, **kwargs)


def load_csr(basename: str, device=None) -> CSRGraph:
    """The graph at ``basename`` as a ``CSRGraph`` on ``device``: the GPU
    when None, the CPU only when the caller names it.  Loads the files
    (``load_s`` in the result's ``report``), then the codec's
    ``to_device`` decodes on the device."""
    from ..device import require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    t0 = time.perf_counter()
    g = load(basename)
    load_s = time.perf_counter() - t0
    csr = g.to_device(dev)
    csr.report = dict(csr.report, load_s=load_s)
    return csr
