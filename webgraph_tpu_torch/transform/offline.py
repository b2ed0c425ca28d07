"""Out-of-core transforms: arc batches sorted on the device, merged on the
host.

Counterpart of ``webgraph_tpu/transform/offline.py`` (``:32-226``; the
reference's disk-batch external sort, Transform.processBatch :938-974 and
BatchGraph's k-way heap merge :709-926).  The arcs of a device ``CSRGraph``
are read in chunks of nodes, in the JAX functions' stream order, and cut
into batches of ``batch_size`` pairs; each batch is sorted and deduplicated
on the graph's device (one sort of packed ``(src << 32) | tgt`` keys, as in
``CSRGraph.from_arcs``) and spilled as a ``(2, k)`` int64 ``.npy``, the JAX
package's file.  A ``BatchGraph`` then merges the batches lazily in node
order on the host, feeding any codec's ``store``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import CSRGraph, ImmutableGraph

__all__ = ["process_batch", "BatchGraph", "transpose_offline",
           "symmetrize_offline", "simplify_offline", "map_offline_batched"]

DEFAULT_BATCH_SIZE = 10_000_000  # pairs (Transform.java DEFAULT_BATCH_SIZE)
# arcs of the source graph read per chunk of nodes
_READ_ARCS = 1 << 24
# arcs of all batches merged per block of nodes (``BatchGraph.iter_nodes``)
_MERGE_ARCS = 1 << 22


def process_batch(src: torch.Tensor, tgt: torch.Tensor, temp_dir: str,
                  batches: List[str]) -> int:
    """Sort (source, target) pairs on their device, dedup, spill to a temp
    file.  Returns the number of unique pairs written (Transform.processBatch
    :938-974 semantics)."""
    key = torch.unique((src.to(torch.int64) << 32) | tgt.to(torch.int64))
    arr = torch.stack([key >> 32, key & 0xFFFFFFFF]).cpu().numpy()
    fd, path = tempfile.mkstemp(suffix=".batch.npy", dir=temp_dir)
    os.close(fd)
    # a plain (2, k) int64 .npy, so merges can mmap it
    np.save(path, arr)
    batches.append(path)
    return arr.shape[1]


def _load_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # plain arrays over the mapping: what is cut from them is no np.memmap
    arr = np.asarray(np.load(path, mmap_mode="r"))
    return arr[0], arr[1]


class BatchGraph(ImmutableGraph):
    """Sequential graph lazily merging sorted batch files (BatchGraph
    :709-926).  Iteration merges all batches in blocks of nodes; per-node
    lists are deduplicated across batches."""

    def __init__(self, num_nodes: int, num_arcs: int, batches: List[str]):
        self._n = num_nodes
        self._m = num_arcs
        self.batches = batches
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
        raise RuntimeError("BatchGraph is sequential-only")

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        """Merge-iterate from ``start``.  Positioning is a binary search
        per batch on its sorted source column, not a replay from node 0:
        the copiable-iterator contract that lets a store split the merge
        at any node bound, as the reference re-opens its batch files per
        split (Transform.java :771-789, NodeIterator.copy(upperBound))."""
        for x, hi, at, tgt in self.iter_blocks(start):
            for y in range(x, hi):
                yield y, tgt[at[y - x]:at[y - x + 1]]

    def iter_blocks(self, start: int = 0) -> Iterator[
            Tuple[int, int, np.ndarray, np.ndarray]]:
        """The merge from ``start`` a block of nodes at a time: (x, hi,
        offsets int64[hi - x + 1] from 0, successors int64) of nodes
        [x, hi).  Each batch's arcs of the block (one binary search for
        each end), one sort and dedup of their packed ``(src << 32) | tgt``
        keys; a block holds about ``_MERGE_ARCS`` arcs of all batches
        together.  ``host_csr`` and the native streaming store read whole
        blocks."""
        streams = [_load_batch(p) for p in self.batches]
        cursors = [int(np.searchsorted(s, start)) for s, _ in streams]
        n, x, step = self._n, start, 1 << 12
        while x < n:
            while True:
                hi = min(n, x + step)
                ends = [int(np.searchsorted(s, hi)) for s, _ in streams]
                arcs = sum(e - c for e, c in zip(ends, cursors))
                if arcs <= 2 * _MERGE_ARCS or hi == x + 1:
                    break
                step = max(1, step // 2)
            if arcs:
                key = np.unique(np.concatenate(
                    [(s[c:e] << 32) | t[c:e] for (s, t), c, e
                     in zip(streams, cursors, ends)]))
                yield (x, hi, np.searchsorted(key >> 32, np.arange(x, hi + 1)),
                       key & 0xFFFFFFFF)
            else:
                yield (x, hi, np.zeros(hi - x + 1, dtype=np.int64),
                       np.zeros(0, dtype=np.int64))
            cursors = ends
            x = hi
            if arcs < _MERGE_ARCS // 2:
                step *= 2

    def cleanup(self) -> None:
        for p in self.batches:
            try:
                os.unlink(p)
            except OSError:
                pass


def _node_chunks(g: CSRGraph):
    """(sources int64, targets int64) of nodes in chunks of about
    ``_READ_ARCS`` arcs, in node order, on the graph's device."""
    if not isinstance(g, CSRGraph):
        raise TypeError(f"need a CSRGraph on a device, got "
                        f"{type(g).__name__}")
    off = g.offsets.cpu().numpy()
    n = g.num_nodes
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(off, off[lo] + _READ_ARCS, "right")) - 1
        hi = min(max(hi, lo + 1), n)
        a, b = int(off[lo]), int(off[hi])
        if b > a:
            deg = g.offsets[lo + 1:hi + 1] - g.offsets[lo:hi]
            src = torch.repeat_interleave(
                torch.arange(lo, hi, dtype=torch.int64, device=g.device),
                deg, output_size=b - a)
            yield src, g.succ[a:b].to(torch.int64)
        lo = hi


def interleave_at(src: torch.Tensor):
    """Where each arc of a node-ordered chunk goes in the JAX functions'
    per-node stream ``yield xx, s; yield s, xx``: (forward positions,
    reversed positions) in a stream of 2m pairs, per source node its d
    arcs, then the same d arcs reversed."""
    m = src.numel()
    start = torch.ones(m, dtype=torch.bool, device=src.device)
    start[1:] = src[1:] != src[:-1]
    i = torch.arange(m, device=src.device)
    first = torch.cummax(torch.where(start, i, 0), 0).values
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(torch.roll(start, -1) | (i == m - 1), i, m), (0,)),
        0).values, (0,))
    fwd = first + i                   # 2 * first + (i - first)
    return fwd, fwd + (last - first + 1)   # after the node's d forward pairs


def _interleave(src, tgt):
    """Per source node, its arcs (src, tgt), then the same arcs reversed."""
    if src.numel() == 0:
        return src, tgt
    fwd, bwd = interleave_at(src)
    out_s = torch.empty(2 * src.numel(), dtype=src.dtype, device=src.device)
    out_t = torch.empty_like(out_s)
    out_s[fwd], out_t[fwd] = src, tgt
    out_s[bwd], out_t[bwd] = tgt, src
    return out_s, out_t


def _batched_arc_stream(chunks, num_nodes: int, batch_size: int,
                        temp_dir: Optional[str]) -> BatchGraph:
    """Cut a stream of (src, tgt) device chunks into batches of exactly
    ``batch_size`` pairs (the last one shorter) and spill each."""
    temp_dir = temp_dir or tempfile.gettempdir()
    batches: List[str] = []
    pend_s, pend_t, fill, total = [], [], 0, 0
    for s_arr, t_arr in chunks:
        o = 0
        while o < s_arr.numel():
            take = min(batch_size - fill, s_arr.numel() - o)
            pend_s.append(s_arr[o:o + take])
            pend_t.append(t_arr[o:o + take])
            fill += take
            o += take
            if fill == batch_size:
                total += process_batch(torch.cat(pend_s), torch.cat(pend_t),
                                       temp_dir, batches)
                pend_s, pend_t, fill = [], [], 0
    if fill:
        total += process_batch(torch.cat(pend_s), torch.cat(pend_t),
                               temp_dir, batches)
    return BatchGraph(num_nodes, total, batches)


def transpose_offline(g: CSRGraph, batch_size: int = DEFAULT_BATCH_SIZE,
                      temp_dir: Optional[str] = None) -> BatchGraph:
    """Out-of-core transpose (Transform.transposeOffline :1058-1144)."""
    chunks = ((t, s) for s, t in _node_chunks(g))
    return _batched_arc_stream(chunks, g.num_nodes, batch_size, temp_dir)


def symmetrize_offline(g: CSRGraph, batch_size: int = DEFAULT_BATCH_SIZE,
                       temp_dir: Optional[str] = None) -> BatchGraph:
    """Out-of-core symmetrization (Transform.symmetrizeOffline :546-633)."""
    chunks = (_interleave(s, t) for s, t in _node_chunks(g))
    return _batched_arc_stream(chunks, g.num_nodes, batch_size, temp_dir)


def simplify_offline(g: CSRGraph, batch_size: int = DEFAULT_BATCH_SIZE,
                     temp_dir: Optional[str] = None) -> BatchGraph:
    """Out-of-core symmetrize + loop removal (Transform.simplifyOffline)."""
    def chunks():
        for s, t in _node_chunks(g):
            keep = s != t
            yield _interleave(s[keep], t[keep])

    return _batched_arc_stream(chunks(), g.num_nodes, batch_size, temp_dir)


def map_offline_batched(g: CSRGraph, node_map,
                        num_nodes: Optional[int] = None,
                        batch_size: int = DEFAULT_BATCH_SIZE,
                        temp_dir: Optional[str] = None) -> BatchGraph:
    """Out-of-core node mapping (Transform.mapOffline :1160-1279): arcs
    with an endpoint mapped to -1 are dropped."""
    node_map = torch.as_tensor(node_map, device=g.device).to(torch.int64)
    if num_nodes is None:
        num_nodes = int(node_map.max()) + 1 if node_map.numel() else 0

    def chunks():
        for s, t in _node_chunks(g):
            ms, mt = node_map[s], node_map[t]
            keep = (ms >= 0) & (mt >= 0)
            yield ms[keep], mt[keep]

    return _batched_arc_stream(chunks(), num_nodes, batch_size, temp_dir)
