"""Graph analytics over the port's device CSR (``core.graph.CSRGraph``).

Counterparts of ``webgraph_tpu/algo``: the same names.
"""

from .bfs import arc_balanced_ranges, bfs, visit, visit_all
from .cc import compute_sizes, connected_components, sort_by_size
from .centrality import (closeness_centrality, harmonic_centrality,
                         linear_geometric_centrality)
from .hyperball import (HyperBall, effective_diameter, estimate_counts,
                        hyperloglog_init, sequential_hyperball)
from .scc import (scc_buckets, scc_sizes, strongly_connected_components,
                  strongly_connected_components_labelled)

__all__ = [
    "bfs", "visit", "visit_all", "arc_balanced_ranges",
    "connected_components", "compute_sizes", "sort_by_size",
    "strongly_connected_components", "scc_sizes", "scc_buckets",
    "strongly_connected_components_labelled",
    "HyperBall", "hyperloglog_init", "estimate_counts", "effective_diameter",
    "sequential_hyperball",
    "linear_geometric_centrality", "harmonic_centrality",
    "closeness_centrality",
]
