"""Connected components of symmetric graphs over a device CSR.

Counterpart of ``webgraph_tpu/algo/cc.py`` (ConnectedComponents.java:107):
min-label propagation with pointer jumping, every round on the device, then
component ids renumbered by first appearance over the nodes.  That order
depends only on the partition, so the ids equal the JAX package's.
"""

from __future__ import annotations

import torch

from ..core.graph import CSRGraph

__all__ = ["connected_components", "compute_sizes", "sort_by_size",
           "first_appearance_ids"]


def first_appearance_ids(label: torch.Tensor) -> torch.Tensor:
    """Labels in [0, n) renumbered 0..k-1 in order of first appearance."""
    n = label.numel()
    label = label.to(torch.int64)
    pos = torch.arange(n, device=label.device)
    first = torch.full((n,), n, dtype=torch.int64, device=label.device)
    first.scatter_reduce_(0, label, pos, "amin")
    first = first[label]
    rank = torch.cumsum(first == pos, 0) - 1
    return rank[first]


def connected_components(g: CSRGraph) -> torch.Tensor:
    """Component id per node, int64 on the graph's device: the minimum node
    id of each component, renumbered in first-appearance order."""
    src, tgt = g.arc_sources().to(torch.int64), g.succ.to(torch.int64)
    label = torch.arange(g.num_nodes, device=g.device)
    while True:
        new = label.scatter_reduce(0, tgt, label[src], "amin")
        new = new[new]
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    return first_appearance_ids(label)


def compute_sizes(component: torch.Tensor) -> torch.Tensor:
    """Size of each component (ConnectedComponents.computeSizes)."""
    return torch.bincount(component)


def sort_by_size(component: torch.Tensor) -> torch.Tensor:
    """Renumber components by decreasing size (ConnectedComponents
    .sortBySize); ties broken by original component id."""
    order = torch.sort(-compute_sizes(component), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank[component]
