"""In-memory graph transforms on the device.

Counterpart of ``webgraph_tpu/transform/__init__.py`` ``transpose``,
``union``, ``symmetrize`` and ``simplify`` (``:58-88``): each builds an arc
array on the graph's device and hands it to ``CSRGraph.from_arcs``, one
device sort of ``(src << 32) | tgt`` keys with ``unique`` for dedup.
"""

from __future__ import annotations

import torch

from .core.graph import CSRGraph

__all__ = ["transpose", "union", "symmetrize", "simplify"]


def transpose(g: CSRGraph) -> CSRGraph:
    """Every arc reversed (Transform.transposeOffline, :1058-1144)."""
    return g.transpose()


def union(g0: CSRGraph, g1: CSRGraph) -> CSRGraph:
    """Arc-set union (Transform.union :1659)."""
    if g0.device != g1.device:
        raise ValueError("both graphs must be on one device")
    s0, t0 = g0.arc_sources(), g0.succ
    s1, t1 = g1.arc_sources(), g1.succ
    n = max(g0.num_nodes, g1.num_nodes)
    return CSRGraph.from_arcs(torch.cat([s0, s1]), torch.cat([t0, t1]), n,
                              dedup=True, device=g0.device)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """union(g, transpose(g)) (Transform.symmetrizeOffline :546-633)."""
    src, tgt = g.arc_sources(), g.succ
    return CSRGraph.from_arcs(torch.cat([src, tgt]), torch.cat([tgt, src]),
                              g.num_nodes, dedup=True, device=g.device)


def simplify(g: CSRGraph) -> CSRGraph:
    """Symmetrize and remove loops (Transform.simplify :645-705)."""
    src, tgt = g.arc_sources(), g.succ
    keep = src != tgt
    src, tgt = src[keep], tgt[keep]
    return CSRGraph.from_arcs(torch.cat([src, tgt]), torch.cat([tgt, src]),
                              g.num_nodes, dedup=True, device=g.device)
