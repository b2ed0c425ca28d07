"""Labelled out-of-core transforms and labelled composition.

Counterpart of ``webgraph_tpu/transform/labelled.py`` (the reference's
``processTransposeBatch``, Transform.java:990-1048; labelled
transposeOffline :1281-1456, labelled symmetrizeOffline with a merge
strategy :546-633, labelled compose with a LabelSemiring :1792).

The arcs of an ``ArcLabelledGraph`` are read in chunks of nodes, in the JAX
functions' stream order, with their labels, and cut into batches of
``batch_size`` triples.  Each batch is sorted on the graph's device by one
stable sort of packed ``(src << 32) | tgt`` keys -- duplicates kept, each
key's occurrences in stream order, as ``np.lexsort`` keeps them -- and
spilled as an ``.npz`` of int64 arrays (sources, targets, and the labels:
values, or counts and entries).  A ``LabelledBatchGraph`` merges them:
``iter_labelled`` node by node on the host, as the JAX design does;
``to_arc_labelled`` in bulk on a device -- every batch concatenated in batch
order, one stable sort, each run of equal arcs folded with the merge in
order -- which gives the same graph.  Merges are elementwise tensor
functions of the scalar labels; list labels are carried (``merge=None``)
but not merged.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import CSRGraph, ImmutableGraph, expand_ranges
from ..labelling.graph import (ArcLabelledGraph, LabelSemiring, _from_keys,
                               _scalar, cat_labels, fold_runs, gather_labels,
                               label_objects, stable_key_order)
from ..labelling.labels import Label
from . import _free_bytes
from .offline import DEFAULT_BATCH_SIZE, _node_chunks, interleave_at

__all__ = ["process_labelled_batch", "LabelledBatchGraph",
           "transpose_offline_labelled", "symmetrize_offline_labelled",
           "compose_labelled"]

_I64 = torch.int64


def _arc_range(values, a: int, b: int):
    if isinstance(values, tuple):
        return gather_labels(values, torch.arange(a, b,
                                                  device=values[0].device))
    return values[a:b]


def _merge_runs(key: torch.Tensor, values, merge):
    """Sorted keys with their labels -> one label per key: ``fold_runs``
    for scalar labels; list labels keep the first occurrence and cannot
    be merged."""
    if not isinstance(values, tuple):
        return fold_runs(key, values, merge)
    start = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
    start[1:] = key[1:] != key[:-1]
    first = torch.nonzero(start).flatten()
    if merge is not None and first.numel() < key.numel():
        raise TypeError("list labels are not merged on the device")
    return key[first], gather_labels(values, first)


def process_labelled_batch(src: torch.Tensor, tgt: torch.Tensor, values,
                           temp_dir: str, batches: List[str]) -> int:
    """Sort (source, target, label) triples by (source, target) on their
    device, stably, and spill.

    Unlike the plain ``process_batch``, duplicates are KEPT -- merging
    duplicate arcs needs the labels and happens at consumption time with a
    merge strategy (Transform.processTransposeBatch :990-1048 keeps one
    label per arc the same way).  Returns the number of pairs written."""
    key, order = stable_key_order(src, tgt)
    v = gather_labels(values, order)
    arrays = dict(s=(key >> 32).cpu().numpy(),
                  t=(key & 0xFFFFFFFF).cpu().numpy())
    if isinstance(v, tuple):
        arrays.update(c=v[0].cpu().numpy(), e=v[1].cpu().numpy())
    else:
        arrays.update(v=v.cpu().numpy())
    fd, path = tempfile.mkstemp(suffix=".lbatch.npz", dir=temp_dir)
    os.close(fd)
    np.savez(path, **arrays)
    batches.append(path)
    return key.numel()


def _load_labelled_batch(path: str):
    """(sources, targets, labels) of a batch file, as CPU tensors."""
    z = np.load(path)
    lab = ((torch.from_numpy(z["c"]), torch.from_numpy(z["e"]))
           if "c" in z.files else torch.from_numpy(z["v"]))
    return torch.from_numpy(z["s"]), torch.from_numpy(z["t"]), lab


class LabelledBatchGraph(ImmutableGraph):
    """Sequential labelled graph merging sorted labelled batch files.

    ``merge`` resolves duplicate (x, t) arcs across (or within) batches,
    elementwise over int64 tensors, the earlier occurrence first -- the
    LabelMergeStrategy of the reference's labelled union/symmetrize
    (Transform.java:546-633); with ``merge=None`` the first occurrence in
    batch order wins.  ``num_arcs`` is the number of pairs spilled, before
    the merge, as in the JAX class (ROADMAP C5).  ``device`` is where the
    batches were sorted, ``to_arc_labelled``'s default."""

    def __init__(self, num_nodes: int, num_arcs: int, batches: List[str],
                 prototype: Label, merge: Optional[Callable] = None,
                 device=None):
        self._n = num_nodes
        self._m = num_arcs  # pairs spilled (pre-merge upper bound)
        self.batches = batches
        self.prototype = prototype
        self.merge = merge
        self.device = torch.device(device or "cpu")
        self.properties = {}

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        return self._m

    @property
    def random_access(self) -> bool:
        return False

    def successors(self, x: int) -> np.ndarray:
        raise RuntimeError("LabelledBatchGraph is sequential-only")

    def iter_labelled(self, start: int = 0
                      ) -> Iterator[Tuple[int, np.ndarray, List[Label]]]:
        """Per node from ``start``: its successors (int64 numpy) and their
        ``Label`` objects, each batch's arcs of the node taken in batch
        order and duplicates folded in that order."""
        streams = [_load_labelled_batch(p) for p in self.batches]
        cursors = [int(torch.searchsorted(s, start)) for s, _, _ in streams]
        for x in range(start, self._n):
            tgts, labs = [], []
            for bi, (s, t, lab) in enumerate(streams):
                c = cursors[bi]
                e = int(torch.searchsorted(s, x, right=True))
                if e > c:
                    tgts.append(t[c:e])
                    labs.append(_arc_range(lab, c, e))
                    cursors[bi] = e
            if not tgts:
                yield x, np.zeros(0, dtype=np.int64), []
                continue
            t = torch.cat(tgts)
            key, order = stable_key_order(torch.zeros_like(t), t)
            key, vals = _merge_runs(key, gather_labels(cat_labels(labs),
                                                       order), self.merge)
            yield x, key.numpy(), label_objects(vals, self.prototype)

    def iter_nodes(self, start: int = 0):
        for x, succ, _ in self.iter_labelled(start):
            yield x, succ

    def to_arc_labelled(self, device=None) -> ArcLabelledGraph:
        """The merged graph on ``device`` (the device the batches were
        sorted on when None), in bulk: the batches concatenated in batch
        order, one stable sort of the keys, the runs of equal arcs folded
        with the merge in order."""
        dev = self.device if device is None else torch.device(device)
        parts = [_load_labelled_batch(p) for p in self.batches]
        if not parts:
            return ArcLabelledGraph(
                CSRGraph(torch.zeros(self._n + 1, dtype=_I64),
                         torch.zeros(0, dtype=torch.int32), device=dev),
                [], self.prototype)
        src = torch.cat([s for s, _, _ in parts]).to(dev)
        tgt = torch.cat([t for _, t, _ in parts]).to(dev)
        labs = cat_labels([lab for _, _, lab in parts])
        labs = (tuple(x.to(dev) for x in labs) if isinstance(labs, tuple)
                else labs.to(dev))
        del parts
        key, order = stable_key_order(src, tgt)
        del src, tgt
        key, vals = _merge_runs(key, gather_labels(labs, order), self.merge)
        return ArcLabelledGraph(_from_keys(key, self._n), vals,
                                self.prototype)

    def cleanup(self) -> None:
        for p in self.batches:
            try:
                os.unlink(p)
            except OSError:
                pass


def _labelled(g) -> ArcLabelledGraph:
    if not isinstance(g, ArcLabelledGraph):
        raise TypeError(f"need an ArcLabelledGraph on a device, got "
                        f"{type(g).__name__}: bring it there with "
                        f"to_device or to_arc_labelled")
    return g


def _arc_chunks(g: ArcLabelledGraph):
    """(sources, targets, labels) of nodes in chunks, in node order, on
    the graph's device."""
    a = 0
    for s, t in _node_chunks(g.graph):
        b = a + s.numel()
        yield s, t, _arc_range(g.values, a, b)
        a = b


def _spill_labelled(chunks, num_nodes: int, prototype: Label,
                    batch_size: int, temp_dir: Optional[str], merge,
                    device) -> LabelledBatchGraph:
    """Cut a stream of (src, tgt, labels) device chunks into batches of
    exactly ``batch_size`` triples (the last one shorter) and spill each."""
    temp_dir = temp_dir or tempfile.gettempdir()
    batches: List[str] = []
    pend, fill, total = [], 0, 0
    for s, t, lab in chunks:
        o = 0
        while o < s.numel():
            take = min(batch_size - fill, s.numel() - o)
            pend.append((s[o:o + take], t[o:o + take],
                         _arc_range(lab, o, o + take)))
            fill += take
            o += take
            if fill == batch_size:
                total += _flush(pend, temp_dir, batches)
                pend, fill = [], 0
    if fill:
        total += _flush(pend, temp_dir, batches)
    return LabelledBatchGraph(num_nodes, total, batches, prototype, merge,
                              device)


def _flush(pend, temp_dir: str, batches: List[str]) -> int:
    return process_labelled_batch(
        torch.cat([s for s, _, _ in pend]), torch.cat([t for _, t, _ in pend]),
        cat_labels([lab for _, _, lab in pend]), temp_dir, batches)


def transpose_offline_labelled(g: ArcLabelledGraph,
                               batch_size: int = DEFAULT_BATCH_SIZE,
                               temp_dir: Optional[str] = None
                               ) -> LabelledBatchGraph:
    """Labelled out-of-core transpose (Transform.java:1281-1456): arc
    (x, y, l) becomes (y, x, l)."""
    chunks = ((t, s, lab) for s, t, lab in _arc_chunks(_labelled(g)))
    return _spill_labelled(chunks, g.num_nodes, g.prototype, batch_size,
                           temp_dir, None, g.device)


def symmetrize_offline_labelled(g: ArcLabelledGraph, merge: Callable,
                                batch_size: int = DEFAULT_BATCH_SIZE,
                                temp_dir: Optional[str] = None
                                ) -> LabelledBatchGraph:
    """Labelled out-of-core symmetrization = union of the graph and its
    transpose, duplicate arcs resolved by ``merge``
    (Transform.symmetrizeOffline labelled, :546-633).  The stream is the
    JAX function's -- per node its arcs, then the same arcs reversed -- so
    the pair (a, b) meets the label of (min, max) before that of
    (max, min): ``merge(label(min, max), label(max, min))``, and
    ``merge(l, l)`` for a loop."""

    def chunks():
        for s, t, lab in _arc_chunks(_labelled(g)):
            m = s.numel()
            fwd, bwd = interleave_at(s)
            idx = torch.empty(2 * m, dtype=_I64, device=s.device)
            rev = torch.zeros(2 * m, dtype=torch.bool, device=s.device)
            ar = torch.arange(m, device=s.device)
            idx[fwd], idx[bwd], rev[bwd] = ar, ar, True
            ss, tt = s[idx], t[idx]
            yield (torch.where(rev, tt, ss), torch.where(rev, ss, tt),
                   gather_labels(lab, idx))

    return _spill_labelled(chunks(), g.num_nodes, g.prototype, batch_size,
                           temp_dir, merge, g.device)


def compose_labelled(g0: ArcLabelledGraph, g1: ArcLabelledGraph,
                     semiring: LabelSemiring) -> ArcLabelledGraph:
    """Labelled composition (Transform.java:1792): the arc (x, z) exists
    when some y has (x, y) in g0 and (y, z) in g1; its label is the
    semiring ``add`` (a ``scatter_reduce``) over all such paths of
    ``multiply(l0, l1)`` (elementwise).  ``n = max(g0.num_nodes,
    g1.num_nodes)``; a middle node outside g1 ends no path.  The join holds
    one entry per path, the sum of the middle nodes' outdegrees; it is
    checked against the device's free memory before it is allocated."""
    if _labelled(g0).device != _labelled(g1).device:
        raise ValueError("both graphs must be on one device")
    dev = g0.device
    n = max(g0.num_nodes, g1.num_nodes)
    v0, v1 = _scalar(g0, "compose_labelled"), _scalar(g1, "compose_labelled")
    s0, t0 = g0.graph.arcs()
    inside = t0 < g1.num_nodes
    mid = torch.zeros_like(t0)
    mid[inside] = g1.graph.outdegrees()[t0[inside]]
    total = int(mid.sum())
    # the int64 path arrays (g0 arc, g1 arc, label, key), the gathers that
    # feed them, and unique's sort and inverse
    need = 72 * total
    free = _free_bytes(dev)
    if free is not None and need > free:
        raise MemoryError(f"compose_labelled: the join needs ~{need} bytes, "
                          f"{free} free on {dev}")
    first = torch.zeros_like(t0)
    first[inside] = g1.graph.offsets[t0[inside]]
    a0 = torch.repeat_interleave(torch.arange(t0.numel(), device=dev), mid,
                                 output_size=total)
    a1 = expand_ranges(first, mid, dev)
    del first, mid, inside
    lab = torch.as_tensor(semiring.multiply(v0[a0], v1[a1])).to(_I64)
    key = (s0[a0] << 32) | g1.graph.succ[a1].to(_I64)
    del a0, a1
    ukey, inv = torch.unique(key, return_inverse=True)
    del key
    out = torch.zeros(ukey.numel(), dtype=_I64, device=dev)
    out.scatter_reduce_(0, inv, lab, semiring.add, include_self=False)
    return ArcLabelledGraph(_from_keys(ukey, n), out, g0.prototype)
