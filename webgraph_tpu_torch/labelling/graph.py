"""Arc-labelled graphs on a device, and the bit-stream label files.

Counterpart of ``webgraph_tpu/labelling/graph.py`` (reference semantics:
ArcLabelledImmutableGraph.java:40-77, the store contract and
UNDERLYINGGRAPH_PROPERTY_KEY; BitStreamArcLabelledImmutableGraph.java:66-120,
the file family, :635-693, store and saveProperties;
UnionArcLabelledImmutableGraph and LabelMergeStrategy;
ArcRelabelledImmutableGraph:48; LabelSemiring:39; IntegerLabelFilter:28).

The JAX package keeps one ``Label`` object per arc.  Here the labels of an
``ArcLabelledGraph`` are tensors on its ``CSRGraph``'s device, aligned with
``succ``: one int64 value per arc for the scalar labels, a ragged pair
``(counts[m], entries)`` for the list labels.  The ``Label`` objects stay
the prototype and the host surface (``labels_of``, ``iter_labelled``).  The
combinators are tensor functions on the graph's device: a merge, a
conversion or a predicate receives the labels of many arcs at once, with
their sources and targets as int64 tensors.  The ``.labels`` and
``.labeloffsets`` streams are packed and unpacked by ``ops/labelcodec.py``;
``BitStreamArcLabelledGraph.to_device`` takes a labelled basename to the
card: the underlying graph's own device entry (B1 and B2 for a BVGraph)
and the labels decoded onto the same device.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import (CSRGraph, ImmutableGraph, expand_ranges,
                          load as load_graph, register_graph_class, sync)
from ..device import require_cuda
from ..ops import labelcodec
from ..ops.bitio import BitReader
from ..ops.ef_index import EliasFanoMonotoneList, build_ef
from ..utils import properties as javaprops
from .labels import Label, label_from_spec

__all__ = ["ArcLabelledGraph", "BitStreamArcLabelledGraph",
           "union_labelled", "relabel", "LabelSemiring",
           "integer_label_filter", "filter_labelled"]

LABELS_EXTENSION = ".labels"
LABEL_OFFSETS_EXTENSION = ".labeloffsets"
LABEL_OBL_EXTENSION = ".labelobl"
UNDERLYINGGRAPH_PROPERTY_KEY = "underlyinggraph"
LABELSPEC_PROPERTY_KEY = "labelspec"
LABELLED_GRAPH_CLASS = ("it.unimi.dsi.big.webgraph.labelling."
                        "BitStreamArcLabelledImmutableGraph")

_I64 = torch.int64


def _is_list(prototype: Label) -> bool:
    return labelcodec.label_format(prototype)[0] == "list"


def _values_from_labels(labels: List[Label], prototype: Label, device):
    """Label objects -> the tensor form of their values on ``device``."""
    if _is_list(prototype):
        counts = torch.tensor([len(l.value) for l in labels], dtype=_I64)
        entries = (np.concatenate([np.asarray(l.value, dtype=np.int64)
                                   for l in labels])
                   if labels else np.zeros(0, np.int64))
        return counts.to(device), torch.from_numpy(entries).to(device)
    return torch.tensor([int(l.value) for l in labels],
                        dtype=_I64).to(device)


def _list_offsets(counts: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(counts.numel() + 1, dtype=_I64, device=counts.device)
    torch.cumsum(counts, 0, out=off[1:])
    return off


def label_objects(values, prototype: Label) -> List[Label]:
    """``Label`` objects (copies of ``prototype``) of a run of arcs: int64
    values, or ``(counts, entries)`` holding exactly those arcs' entries."""
    p = prototype
    if isinstance(values, tuple):
        counts = values[0].tolist()
        ent = values[1].cpu().numpy()
        out, at = [], 0
        for c in counts:
            out.append(type(p)(p.key, p.width, ent[at:at + c]))
            at += c
        return out
    out = []
    for v in values.tolist():
        lab = p.copy()
        lab.value = v
        out.append(lab)
    return out


def cat_labels(parts):
    """Labels of consecutive runs of arcs, concatenated."""
    if parts and isinstance(parts[0], tuple):
        return (torch.cat([c for c, _ in parts]),
                torch.cat([e for _, e in parts]))
    return torch.cat(parts)


def gather_labels(values, idx: torch.Tensor):
    """The labels of arcs ``idx`` (any order, repeats allowed), in either
    tensor form."""
    if isinstance(values, tuple):
        counts, entries = values
        c = counts[idx]
        return c, entries[expand_ranges(_list_offsets(counts)[idx], c,
                                        counts.device)]
    return values[idx]


class ArcLabelledGraph(ImmutableGraph):
    """A ``CSRGraph`` and its labels as tensors on its device.

    ``values``: an int64 tensor [m] for scalar labels, ``(counts[m],
    entries)`` for list labels (the entries of arc j are
    ``entries[sum(counts[:j]) : sum(counts[:j + 1])]``), or a list of
    ``Label`` objects aligned with the successors, as the JAX constructor
    takes them; host arrays and lists go to the graph's device."""

    #: set by ``BitStreamArcLabelledGraph.to_device``: the underlying
    #: decode's report and the label decode's stages; else None
    report: Optional[dict] = None

    def __init__(self, graph: CSRGraph, values, prototype: Label):
        dev = graph.device
        if isinstance(values, list):
            values = _values_from_labels(values, prototype, dev)
        elif _is_list(prototype):
            values = tuple(torch.as_tensor(v).to(dev, _I64) for v in values)
        else:
            values = torch.as_tensor(values).to(dev, _I64)
        m = values[0].numel() if isinstance(values, tuple) else values.numel()
        if m != graph.num_arcs:
            raise ValueError(f"{m} labels for {graph.num_arcs} arcs")
        self.graph = graph
        self.values = values
        self.prototype = prototype
        self.properties = {}
        self._loff: Optional[list] = None   # list labels' offsets, on demand

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.graph.num_arcs

    def outdegree(self, x: int) -> int:
        return self.graph.outdegree(x)

    def successors(self, x: int) -> torch.Tensor:
        return self.graph.successors(x)

    def iter_nodes(self, start: int = 0):
        return self.graph.iter_nodes(start)

    def _host_labels(self, lo: int, hi: int) -> List[Label]:
        """``Label`` objects of arcs [lo, hi)."""
        if not isinstance(self.values, tuple):
            return label_objects(self.values[lo:hi], self.prototype)
        if self._loff is None:
            self._loff = _list_offsets(self.values[0]).tolist()
        off = self._loff
        return label_objects((self.values[0][lo:hi],
                              self.values[1][off[lo]:off[hi]]),
                             self.prototype)

    def labels_of(self, x: int) -> List[Label]:
        lo, hi = self.graph.offsets[x:x + 2].tolist()
        return self._host_labels(lo, hi)

    def iter_labelled(self, start: int = 0
                      ) -> Iterator[Tuple[int, torch.Tensor, List[Label]]]:
        """(node, successors, its labels as ``Label`` objects)."""
        offs = self.graph.offsets.tolist()
        for x, succ in self.graph.iter_nodes(start):
            yield x, succ, self._host_labels(offs[x], offs[x + 1])

    def label_values(self):
        """The labels' tensor form: int64 [m], or ``(counts, entries)``."""
        return self.values

    def equals_labelled(self, other: "ArcLabelledGraph") -> bool:
        """Same lists, same label type and key, same values."""
        a, b = self.graph, other.graph
        if a.num_nodes != b.num_nodes or not (
                _equal(a.offsets, b.offsets) and _equal(a.succ, b.succ)):
            return False
        p, q = self.prototype, other.prototype
        if type(p) is not type(q) or p.key != q.key:
            return False
        va, vb = self.values, other.values
        if isinstance(va, tuple):
            return all(_equal(x, y) for x, y in zip(va, vb))
        return _equal(va, vb)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a, b.to(a.device))


def _as_arc_labelled(labelled, device) -> ArcLabelledGraph:
    if isinstance(labelled, ArcLabelledGraph):
        return labelled
    return labelled.to_arc_labelled(device=device)


@register_graph_class(
    LABELLED_GRAPH_CLASS,
    "it.unimi.dsi.webgraph.labelling.BitStreamArcLabelledImmutableGraph",
)
class BitStreamArcLabelledGraph(ImmutableGraph):
    """On-disk labelled graph: ``.labels`` bit stream + ``.labeloffsets``
    gamma-gap offsets over any underlying graph."""

    def __init__(self, underlying: ImmutableGraph, prototype: Label,
                 label_data: np.ndarray, label_offsets: np.ndarray,
                 properties: Optional[Dict[str, str]] = None):
        self.underlying = underlying
        self.prototype = prototype
        self.label_data = label_data
        self.label_offsets = label_offsets
        self.properties = properties or {}

    @property
    def num_nodes(self) -> int:
        return self.underlying.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.underlying.num_arcs

    def successors(self, x: int) -> np.ndarray:
        return self.underlying.successors(x)

    def iter_nodes(self, start: int = 0):
        return self.underlying.iter_nodes(start)

    def labels_of(self, x: int) -> List[Label]:
        r = BitReader(self.label_data)
        r.position(int(self.label_offsets[x]))
        out = []
        for _ in range(self.underlying.outdegree(x)):
            lab = self.prototype.copy()
            lab.from_bitstream(r, x)
            out.append(lab)
        return out

    def iter_labelled(self, start: int = 0):
        for x, succ in self.iter_nodes(start):
            yield x, succ, self.labels_of(x)

    # -- the device entry -------------------------------------------------

    def to_device(self, device=None) -> ArcLabelledGraph:
        """The labelled graph as an ``ArcLabelledGraph`` on ``device``: the
        GPU when None, the CPU only when the caller names it.  The
        underlying graph takes its own device entry (``to_device``, what
        ``load_csr`` runs: B1 and B2 for a BVGraph on the card), then the
        labels are decoded onto the same device (``labelcodec``).  The
        result's ``report`` holds the underlying decode's report and the
        label decode's seconds and stages."""
        dev = require_cuda() if device is None else torch.device(device)
        u = self.underlying
        if hasattr(u, "to_device"):
            csr = u.to_device(dev)
        else:
            csr = u.to_csr(device=dev)
        sync(dev)
        t0 = time.perf_counter()
        split = {}
        values = labelcodec.unpack_labels(self.label_data,
                                          self.label_offsets, csr.offsets,
                                          self.prototype, split=split)
        sync(dev)
        g = ArcLabelledGraph(csr, values, self.prototype)
        g.report = dict(graph=csr.report, labels_s=time.perf_counter() - t0,
                        labels_split=split)
        return g

    def to_arc_labelled(self, device) -> ArcLabelledGraph:
        """``to_device`` on a device the caller names."""
        return self.to_device(device)

    # -- persistence ------------------------------------------------------

    @classmethod
    def load(cls, basename: str, mode: str = "standard"
             ) -> "BitStreamArcLabelledGraph":
        """Load ``basename.{labels,labeloffsets,properties}`` and the
        underlying graph they name (relative to the basename's directory).
        A ``.labelobl`` Elias-Fano cache is used when it is fresh (the
        reference's mtime discipline, BVGraph.java:1545-1555 applied to
        ``.labelobl``) and whole: a stale, foreign or truncated cache is
        derived data, so ``.labeloffsets`` stands in for it when present."""
        props = javaprops.load(basename + ".properties")
        under_name = props[UNDERLYINGGRAPH_PROPERTY_KEY]
        if not os.path.isabs(under_name):
            under_name = os.path.join(os.path.dirname(basename), under_name)
        underlying = load_graph(under_name, mode=mode)
        prototype = label_from_spec(props[LABELSPEC_PROPERTY_KEY])
        data = np.fromfile(basename + LABELS_EXTENSION, dtype=np.uint8)
        n = underlying.num_nodes
        obl = basename + LABEL_OBL_EXTENSION
        offs_path = basename + LABEL_OFFSETS_EXTENSION
        offsets = None
        if os.path.exists(obl) and (not os.path.exists(offs_path)
                                    or os.path.getmtime(obl)
                                    >= os.path.getmtime(offs_path)):
            try:
                ef = EliasFanoMonotoneList.load(obl)
                if len(ef) == n + 1:
                    offsets = ef.to_array()
            except IOError:
                if not os.path.exists(offs_path):
                    raise
        if offsets is None:
            # gamma gaps with a leading 0, n + 1 codes
            # (BitStreamArcLabelledImmutableGraph.java:66-120)
            offsets = labelcodec.gamma_prefix_sums(
                np.fromfile(offs_path, dtype=np.uint8), n + 1)
        return cls(underlying, prototype, data, offsets, props)

    def write_label_obl(self, basename: str) -> None:
        """Write the ``.labelobl`` Elias-Fano label-offsets cache."""
        build_ef(np.asarray(self.label_offsets, dtype=np.int64)).dump(
            basename + LABEL_OBL_EXTENSION)

    @classmethod
    def store(cls, labelled, basename: str, underlying_basename: str,
              comment: str = "BitStreamArcLabelledImmutableGraph properties"
              ) -> Dict[str, str]:
        """Write .labels/.labeloffsets/.properties; the underlying graph is
        referenced by (relative) basename and must be stored separately
        (the reference's store contract, ArcLabelledImmutableGraph:40-58).

        ``labelled``: an ``ArcLabelledGraph``, packed on its own device, or
        any labelled graph with ``to_arc_labelled(device)``, brought to the
        CPU first.  Byte-identical to the JAX ``store``."""
        g = _as_arc_labelled(labelled, "cpu")
        data, _bits, offs, _ = labelcodec.pack_labels(
            g.values, g.graph.offsets, g.prototype)
        return _write_label_files(basename, data, offs, g.prototype,
                                  underlying_basename, comment)


def _write_label_files(basename: str, data: bytes, offs: bytes,
                       prototype: Label, underlying_basename: str,
                       comment: str) -> Dict[str, str]:
    """The label family of ``basename``: the two streams and the
    properties naming the underlying graph and the label's spec."""
    with open(basename + LABELS_EXTENSION, "wb") as f:
        f.write(data)
    with open(basename + LABEL_OFFSETS_EXTENSION, "wb") as f:
        f.write(offs)
    props = {
        "graphclass": LABELLED_GRAPH_CLASS,
        UNDERLYINGGRAPH_PROPERTY_KEY: underlying_basename,
        LABELSPEC_PROPERTY_KEY: prototype.to_spec(),
    }
    javaprops.dump(props, basename + ".properties", comment)
    return props


# ---------------------------------------------------------------------------
# labelled combinators (tensor functions on the graph's device)
# ---------------------------------------------------------------------------


def _scalar(g: ArcLabelledGraph, what: str) -> torch.Tensor:
    if isinstance(g.values, tuple):
        raise TypeError(f"{what} merges scalar labels; list labels are "
                        f"not merged on the device")
    return g.values


def stable_key_order(src: torch.Tensor, tgt: torch.Tensor):
    """(sorted keys ``(src << 32) | tgt``, the stable permutation that
    sorts them): equal keys keep their order, so gathering labels with the
    permutation keeps each key's occurrences in input order."""
    key = (src.to(_I64) << 32) | tgt.to(_I64)
    s = torch.sort(key, stable=True)
    return s.values, s.indices


def fold_runs(key: torch.Tensor, vals: torch.Tensor, merge):
    """Runs of equal sorted keys folded to one value each, in order: the
    first occurrence, then ``merge(acc, next)`` over the later ones, one
    round per rank (elementwise over every run that long); ``merge=None``
    keeps the first.  Returns (the runs' keys, their values)."""
    m = key.numel()
    start = torch.ones(m, dtype=torch.bool, device=key.device)
    start[1:] = key[1:] != key[:-1]
    first = torch.nonzero(start).flatten()
    acc = vals[first]
    if merge is not None and first.numel() < m:
        size = torch.diff(first, append=first.new_full((1,), m))
        for r in range(1, int(size.max())):
            live = torch.nonzero(size > r).flatten()
            acc[live] = torch.as_tensor(merge(acc[live],
                                              vals[first[live] + r])).to(_I64)
    return key[first], acc


def _from_keys(key: torch.Tensor, num_nodes: int) -> CSRGraph:
    """A CSR from sorted unique ``(src << 32) | tgt`` keys."""
    dev = key.device
    if key.numel() and int(key[-1] >> 32) >= num_nodes:
        raise ValueError(f"arc sources must lie in [0, {num_nodes})")
    counts = torch.bincount(key >> 32, minlength=num_nodes)
    offsets = torch.zeros(num_nodes + 1, dtype=_I64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    return CSRGraph(offsets, (key & 0xFFFFFFFF).to(torch.int32),
                    num_nodes=num_nodes, device=dev)


def union_labelled(g0: ArcLabelledGraph, g1: ArcLabelledGraph,
                   merge: Callable) -> ArcLabelledGraph:
    """Labelled arc union; ``merge(a, b)`` resolves the arcs present in
    both, elementwise over int64 tensors, ``a`` g0's labels and ``b``
    g1's (UnionArcLabelledImmutableGraph + LabelMergeStrategy.java:28).
    An arc twice in one graph has no defined merge: it raises."""
    if g0.device != g1.device:
        raise ValueError("both graphs must be on one device")
    n = max(g0.num_nodes, g1.num_nodes)
    src = torch.cat([g0.graph.arc_sources(), g1.graph.arc_sources()])
    tgt = torch.cat([g0.graph.succ, g1.graph.succ])
    vals = torch.cat([_scalar(g0, "union_labelled"),
                      _scalar(g1, "union_labelled")])
    key, order = stable_key_order(src, tgt)
    del src, tgt
    side = order >= g0.num_arcs
    same = key[1:] == key[:-1]
    if bool((same & (side[1:] == side[:-1])).any()):
        raise ValueError("union_labelled: an arc occurs twice in one graph")
    ukey, v = fold_runs(key, vals[order], merge)
    return ArcLabelledGraph(_from_keys(ukey, n), v, g0.prototype)


def relabel(g: ArcLabelledGraph, convert: Callable,
            prototype: Label) -> ArcLabelledGraph:
    """On-the-fly relabelling (ArcRelabelledImmutableGraph.java:48):
    ``convert(values, sources, targets)`` gives the new labels of every arc
    (sources and targets int64 tensors on the graph's device)."""
    src, tgt = g.graph.arcs()
    return ArcLabelledGraph(g.graph, convert(g.values, src, tgt), prototype)


class LabelSemiring:
    """Semiring for labelled composition (LabelSemiring.java:39):
    ``multiply(a, b)`` concatenates path labels elementwise; ``add`` merges
    alternative paths, a ``scatter_reduce`` name ("sum", "amin", "amax",
    "prod"); ``zero``/``one`` are the identities."""

    def __init__(self, add: str, multiply, zero, one):
        if add not in ("sum", "amin", "amax", "prod"):
            raise ValueError(f"add must name a scatter_reduce, got {add!r}")
        self.add = add
        self.multiply = multiply
        self.zero = zero
        self.one = one


def integer_label_filter(*values) -> Callable:
    """Keep arcs whose integer label is among ``values``
    (IntegerLabelFilter.java:28): ``pred(values, sources, targets)`` gives
    a bool mask over the arcs."""
    allowed = torch.tensor(sorted(int(v) for v in values), dtype=_I64)

    def pred(labels: torch.Tensor, source, target) -> torch.Tensor:
        return torch.isin(labels, allowed.to(labels.device))

    return pred


def filter_labelled(g: ArcLabelledGraph, pred) -> ArcLabelledGraph:
    """Materialized labelled arc filter (Transform.java labelled
    filterArcs :520-534): the arcs where ``pred(values, sources,
    targets)`` is true, in their order, with their labels."""
    src, tgt = g.graph.arcs()
    keep = torch.as_tensor(pred(g.values, src, tgt)).to(g.device, torch.bool)
    del src
    kept = torch.zeros(g.num_arcs + 1, dtype=_I64, device=g.device)
    torch.cumsum(keep.to(_I64), 0, out=kept[1:])
    csr = CSRGraph(kept[g.graph.offsets], g.graph.succ[keep],
                   num_nodes=g.num_nodes, device=g.device)
    idx = torch.nonzero(keep).flatten()
    return ArcLabelledGraph(csr, gather_labels(g.values, idx), g.prototype)
