"""Strongly connected components over a device CSR.

Counterpart of ``webgraph_tpu/algo/scc.py`` (``:35-144``): the colouring /
forward-backward method in place of the reference's sequential Tarjan
(StronglyConnectedComponents.java:48-126).  Each outer iteration trims the
active nodes with no active in- or out-arc (singleton components), then
propagates the maximum colour forward to a fixpoint; a node whose colour is
its own id is a pivot, and the component of a pivot is the set of nodes of
its colour that reach it, found backwards inside the colour class.  Every
step is a device relaxation over all arcs.  Ids are dense, in first
appearance order over the nodes, so they equal the JAX package's.
``strongly_connected_components_labelled`` (``scc.py:147-156``) runs it on
the arcs a labelled filter keeps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.graph import CSRGraph
from .cc import first_appearance_ids

__all__ = ["strongly_connected_components", "scc_sizes", "scc_buckets",
           "strongly_connected_components_labelled"]


def _fixpoint(step, x: torch.Tensor) -> torch.Tensor:
    while True:
        new = step(x)
        if torch.equal(new, x):
            return x
        x = new


def strongly_connected_components(g: CSRGraph, stats: dict = None
                                  ) -> Tuple[int, torch.Tensor]:
    """Returns (number of components, component int64[n] on the graph's
    device).  ``stats``, when given, receives the number of outer
    iterations, trim passes, colour rounds and reach rounds."""
    n = g.num_nodes
    dev = g.device
    if n == 0:
        return 0, torch.zeros(0, dtype=torch.int64, device=dev)
    src, tgt = g.arc_sources().to(torch.int64), g.succ.to(torch.int64)
    ids = torch.arange(n, device=dev)
    loop = src == tgt
    comp = torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    count = dict(outer=0, trim_passes=0, colour_rounds=0, reach_rounds=0)
    while bool(active.any()):
        count["outer"] += 1
        # trim: peel singleton components (no active in- or out-arc)
        while True:
            count["trim_passes"] += 1
            alive = (active[src] & active[tgt] & ~loop).to(torch.int32)
            outd = torch.zeros(n, dtype=torch.int32, device=dev)
            ind = torch.zeros(n, dtype=torch.int32, device=dev)
            outd.index_add_(0, src, alive)
            ind.index_add_(0, tgt, alive)
            trivial = active & ((outd == 0) | (ind == 0))
            del alive, outd, ind
            if not bool(trivial.any()):
                break
            comp[trivial] = ids[trivial]
            active &= ~trivial
        if not bool(active.any()):
            break
        ok = active[src] & active[tgt]

        def colour_round(c):
            count["colour_rounds"] += 1
            prop = torch.where(ok, c[src], -1)
            return torch.where(active, c.scatter_reduce(0, tgt, prop, "amax"),
                               c)

        colour = _fixpoint(colour_round, torch.where(active, ids, -1))
        del ok
        # backward reachability of the pivots inside their colour class
        inside = (colour[src] == colour[tgt]) & active[src]

        def reach_round(r):
            count["reach_rounds"] += 1
            return r.scatter_reduce(0, src, r[tgt] & inside, "amax")

        reach = _fixpoint(reach_round, (colour == ids).to(torch.uint8))
        del inside
        in_scc = reach.bool() & active
        comp[in_scc] = colour[in_scc]
        active &= ~in_scc
    if stats is not None:
        stats.update(count)
    comp = first_appearance_ids(comp)
    return int(comp.max()) + 1, comp


def strongly_connected_components_labelled(g, pred, stats: dict = None
                                           ) -> Tuple[int, torch.Tensor]:
    """SCC of a labelled graph considering only arcs accepted by the
    labelled arc filter ``pred(values, sources, targets)`` -> bool mask
    (StronglyConnectedComponents.java:375): ``filter_labelled``, then
    ``strongly_connected_components`` of what it keeps.  ``g``: an
    ``ArcLabelledGraph`` on a device."""
    from ..labelling.graph import filter_labelled
    return strongly_connected_components(filter_labelled(g, pred).graph,
                                         stats=stats)


def scc_sizes(component: torch.Tensor) -> torch.Tensor:
    return torch.bincount(component)


def scc_buckets(g: CSRGraph, component: torch.Tensor) -> torch.Tensor:
    """Terminal non-dangling components, bool per component on the graph's
    device: no arc leaves the component, and it is not a singleton without
    a loop (StronglyConnectedComponents.java:225)."""
    src, tgt = g.arc_sources().to(torch.int64), g.succ.to(torch.int64)
    k = int(component.max()) + 1 if component.numel() else 0
    cs, ct = component[src], component[tgt]
    leaves = torch.zeros(k, dtype=torch.bool, device=g.device)
    leaves[cs[cs != ct]] = True
    has_loop = torch.zeros(k, dtype=torch.bool, device=g.device)
    has_loop[component[src[src == tgt]]] = True
    sizes = torch.bincount(component, minlength=k)
    return ~leaves & ((sizes > 1) | has_loop)
