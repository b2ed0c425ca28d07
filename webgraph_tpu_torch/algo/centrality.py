"""Exact linear geometric centralities over a device CSR.

Counterpart of ``webgraph_tpu/algo/centrality.py`` (LinearGeometric
Centrality.java:55-254): centrality(x) = sum over nodes y reachable from x
of coef(d(x, y)), by batched multi-source BFS, the sources of a batch
advancing together one level per relaxation.  The same two formulations,
picked by the same test on ``DENSE_LIMIT``:

- **dense**: an (n, S) uint8 frontier, one scatter-max of the sources'
  rows into their targets' rows per level;
- **packed**: frontiers as bitmaps of ceil(n/32) words per source, held in
  int64 so that a word's 32 bits are never its sign.  Arcs are bucketed by
  target bit (tgt & 31); within a bucket every value carries one common
  bit, so a scatter-max is a scatter-OR.  Each bucket's plane is ORed into
  the next frontier as soon as it is done, and arcs stream in chunks of
  ``PACKED_CHUNK``.  Counts come from a popcount of the words.

Per level the counts are added on the device as ``acc += cnt * coef(d)``,
the JAX package's float64 operations in its order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.graph import CSRGraph

__all__ = ["linear_geometric_centrality", "harmonic_centrality",
           "closeness_centrality", "DENSE_LIMIT", "PACKED_CHUNK"]

# above this S*n the dense (n, S) formulation is refused and the packed
# bitmap path runs instead
DENSE_LIMIT = 200_000_000
# arcs per scatter of the packed path (its gather transient is S * chunk
# int64 words)
PACKED_CHUNK = 4_000_000
# arcs per scatter of the dense path
DENSE_ARCS = 1 << 24


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word holding 32 bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _dense_batch(g: CSRGraph, coef, batch_sources, max_dist) -> torch.Tensor:
    n, dev = g.num_nodes, g.device
    S = batch_sources.numel()
    src, tgt = g.arc_sources(), g.succ
    frontier = torch.zeros((n, S), dtype=torch.uint8, device=dev)
    frontier[batch_sources, torch.arange(S, device=dev)] = 1
    visited = frontier.clone()
    acc = torch.zeros(S, dtype=torch.float64, device=dev)
    d = 0
    while bool(frontier.any()) and d < max_dist:
        nxt = torch.zeros_like(frontier)
        for lo in range(0, g.num_arcs, DENSE_ARCS):
            hi = min(lo + DENSE_ARCS, g.num_arcs)
            idx = tgt[lo:hi].to(torch.int64)[:, None].expand(-1, S)
            nxt.scatter_reduce_(0, idx, frontier[src[lo:hi].to(torch.int64)],
                                "amax")
        frontier = nxt & (visited ^ 1)
        visited |= frontier
        d += 1
        acc += frontier.sum(0).to(torch.float64) * coef(d)
    return acc


def _packed_chunks(g: CSRGraph):
    """(bit, source word, source bit, target word) per arc chunk, arcs
    bucketed by target bit; level-invariant, built once."""
    src, tgt = g.arcs()
    order = torch.sort(tgt & 31, stable=True).indices
    src, tgt = src[order], tgt[order]
    bstart = [0] + torch.cumsum(torch.bincount(tgt & 31, minlength=32),
                                0).tolist()
    srcw, srcb = (src >> 5).to(torch.int32), (src & 31).to(torch.int32)
    tgtw = (tgt >> 5).to(torch.int32)
    del src, tgt, order
    chunks = []
    for b in range(32):
        for lo in range(bstart[b], bstart[b + 1], PACKED_CHUNK):
            hi = min(lo + PACKED_CHUNK, bstart[b + 1])
            chunks.append((b, srcw[lo:hi], srcb[lo:hi, None], tgtw[lo:hi]))
    return chunks


def _packed_batch(g: CSRGraph, coef, batch_sources, max_dist,
                  chunks) -> torch.Tensor:
    dev = g.device
    W = (g.num_nodes + 31) // 32
    S = batch_sources.numel()
    frontier = torch.zeros((W, S), dtype=torch.int64, device=dev)
    frontier[batch_sources >> 5, torch.arange(S, device=dev)] = (
        1 << (batch_sources & 31))
    visited = frontier.clone()
    acc = torch.zeros(S, dtype=torch.float64, device=dev)
    d = 0
    while d < max_dist:
        nxt = torch.zeros_like(frontier)
        plane, bit = None, -1
        for b, srcw, srcb, tgtw in chunks:
            if b != bit:
                if plane is not None:
                    nxt |= plane
                plane, bit = torch.zeros_like(frontier), b
            bits = ((frontier[srcw] >> srcb) & 1) << b
            plane.scatter_reduce_(
                0, tgtw.to(torch.int64)[:, None].expand(-1, S), bits, "amax")
        if plane is not None:
            nxt |= plane
        del plane
        frontier = nxt & ~visited
        visited |= frontier
        d += 1
        cnt = _popcount32(frontier).sum(0)
        if not bool(cnt.any()):
            break
        acc += cnt.to(torch.float64) * coef(d)
    return acc


def linear_geometric_centrality(
        g: CSRGraph, coef: Callable[[int], float], sources=None,
        batch: int = 256, max_dist: Optional[int] = None) -> torch.Tensor:
    """centrality[x] = sum over y != x reachable of coef(d(x, y)), float64
    per source on the graph's device."""
    n, dev = g.num_nodes, g.device
    if sources is None:
        sources = torch.arange(n, device=dev)
    sources = torch.as_tensor(sources, device=dev).to(torch.int64)
    if max_dist is None:
        max_dist = n
    packed = min(batch, sources.numel()) * max(n, 1) > DENSE_LIMIT
    chunks = _packed_chunks(g) if packed else None
    out = torch.zeros(sources.numel(), dtype=torch.float64, device=dev)
    for lo in range(0, sources.numel(), batch):
        bs = sources[lo:lo + batch]
        out[lo:lo + bs.numel()] = (
            _packed_batch(g, coef, bs, max_dist, chunks) if packed
            else _dense_batch(g, coef, bs, max_dist))
    return out


def harmonic_centrality(g: CSRGraph, **kw) -> torch.Tensor:
    return linear_geometric_centrality(g, lambda d: 1.0 / d, **kw)


def closeness_centrality(g: CSRGraph, **kw) -> torch.Tensor:
    """1 / sum of distances to reachable nodes (0 for isolated nodes), the
    reference's closeness convention."""
    sumd = linear_geometric_centrality(g, lambda d: float(d), **kw)
    return torch.where(sumd > 0, 1.0 / torch.clamp(sumd, min=1e-300), 0.0)
