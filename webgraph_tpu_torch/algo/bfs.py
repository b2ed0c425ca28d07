"""Breadth-first visits over a device CSR.

Counterpart of ``webgraph_tpu/algo/bfs.py`` (ParallelBreadthFirstVisit
.java:94-272): level-synchronous, each level one relaxation on the device.
The JAX package relaxes every arc at every level; here a level expands the
arcs of its frontier only (the same distances, queue and cut points, and the
same round count: ``rounds`` counts the final, empty level as ``bfs.py:55-58``
does).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.graph import CSRGraph, expand_ranges

__all__ = ["bfs", "visit", "visit_all", "arc_balanced_ranges"]


def bfs(g: CSRGraph, roots, dist=None) -> Tuple[torch.Tensor, int]:
    """Multi-source BFS.  Returns (dist int64[n] on the graph's device, -1
    where unreached; rounds).

    ``dist`` may carry prior marks (entries >= 0 count as visited), for the
    reference's visitAll round-marking idiom."""
    dev = g.device
    n = g.num_nodes
    roots = torch.as_tensor(roots, device=dev).to(torch.int64).reshape(-1)
    if dist is None:
        dist = torch.full((n,), -1, dtype=torch.int64, device=dev)
    else:
        dist = torch.as_tensor(dist, device=dev).to(torch.int64).clone()
    dist[roots] = 0
    off, succ = g.offsets, g.succ
    mark = torch.zeros(n, dtype=torch.bool, device=dev)
    mark[roots] = True
    frontier = torch.nonzero(mark).squeeze(1)
    level = 0
    while frontier.numel():
        lo = off[frontier]
        tgt = succ[expand_ranges(lo, off[frontier + 1] - lo, dev)]
        tgt = tgt[dist[tgt] < 0]
        mark.zero_()
        mark[tgt.to(torch.int64)] = True
        frontier = torch.nonzero(mark).squeeze(1)
        dist[frontier] = level + 1
        level += 1
    return dist, level


def visit(g: CSRGraph, start: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visit from one node (ParallelBreadthFirstVisit.visit :209).

    Returns (queue, cut_points), int64 on the graph's device: nodes level
    by level, ids ascending within a level, and the level boundaries,
    cut_points[i]..cut_points[i+1] being level i."""
    dist, rounds = bfs(g, [start])
    nodes = torch.nonzero(dist >= 0).squeeze(1)
    queue = nodes[torch.sort(dist[nodes], stable=True).indices]
    sizes = torch.bincount(dist[nodes], minlength=rounds)[:rounds]
    cuts = torch.zeros(rounds + 1, dtype=torch.int64, device=g.device)
    torch.cumsum(sizes, 0, out=cuts[1:])
    return queue, cuts


def visit_all(g: CSRGraph) -> torch.Tensor:
    """Visit all nodes, marking each with its visit round
    (ParallelBreadthFirstVisit.visitAll :272).  Returns round[n]."""
    n = g.num_nodes
    marks = torch.full((n,), -1, dtype=torch.int64, device=g.device)
    rnd = 0
    x = 0
    while x < n:
        rest = torch.nonzero(marks[x:] < 0)
        if not rest.numel():
            break
        x += int(rest[0])
        dist, _ = bfs(g, [x], dist=torch.where(marks >= 0, 0, -1))
        marks[(dist >= 0) & (marks < 0)] = rnd
        rnd += 1
    return marks


def arc_balanced_ranges(offsets, pieces: int) -> List[Tuple[int, int]]:
    """Split nodes into ranges with ~equal arc counts (the work-splitting
    role of EliasFanoCumulativeOutdegreeList, SURVEY §2.7): the cumulative
    outdegree list is the CSR offsets array itself."""
    offsets = torch.as_tensor(offsets).to(torch.int64)
    n = offsets.numel() - 1
    m = int(offsets[-1])
    targets = torch.tensor([m * i // pieces for i in range(1, pieces)],
                           dtype=torch.int64, device=offsets.device)
    bounds = ([0] + torch.searchsorted(offsets, targets).tolist() + [n])
    bounds = sorted(min(b, n) for b in bounds)
    return [(bounds[i], bounds[i + 1]) for i in range(pieces)]
