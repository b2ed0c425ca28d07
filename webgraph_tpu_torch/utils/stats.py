"""Graph statistics over a device CSR (Stats.java:53-67).

Counterpart of ``webgraph_tpu/utils/stats.py``: the same keys and the same
files.  Degree distributions are ``bincount``s on the graph's device (of the
outdegrees, and of the indegrees counted from ``succ``); scalars are Python
numbers, arrays tensors on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.graph import CSRGraph

__all__ = ["compute_stats", "write_stats"]


def compute_stats(g: CSRGraph, component: Optional[torch.Tensor] = None
                  ) -> Dict[str, object]:
    """Degree distributions and min/max/avg, plus the component counts and
    sizes when a component array (e.g. of SCCs) is given."""
    n, m = g.num_nodes, g.num_arcs
    outd = g.outdegrees()
    indeg = torch.bincount(g.succ, minlength=n)
    loops = int((g.arc_sources() == g.succ).sum())

    def lo_hi(d):
        # numpy's min(initial=0) of the JAX package: the minima read 0
        # whatever the degrees (ROADMAP C2), kept for equal files
        return (min(int(d.min()), 0), int(d.max())) if n else (0, 0)

    (omin, omax), (imin, imax) = lo_hi(outd), lo_hi(indeg)
    empty = torch.zeros(0, dtype=torch.float64, device=g.device)
    stats: Dict[str, object] = {
        "nodes": n,
        "arcs": m,
        "loops": loops,
        "minoutdegree": omin,
        "maxoutdegree": omax,
        "avgoutdegree": m / n if n else 0.0,
        "minindegree": imin,
        "maxindegree": imax,
        "avgindegree": m / n if n else 0.0,
        "dangling": int((outd == 0).sum()),
        "terminal": int((indeg == 0).sum()),
        "outdegree_distribution": torch.bincount(outd) if n else empty,
        "indegree_distribution": torch.bincount(indeg) if n else empty,
    }
    if component is not None:
        sizes = torch.bincount(component)
        stats["sccs"] = sizes.numel()
        stats["maxsccsize"] = int(sizes.max()) if sizes.numel() else 0
        stats["sccsizes"] = sizes
    return stats


def write_stats(stats: Dict[str, object], basename: str) -> None:
    """Write ``basename.stats`` (key=value lines) and the degree
    distribution files (one count per line, index = degree)."""
    with open(basename + ".stats", "w") as f:
        for k, v in stats.items():
            if isinstance(v, torch.Tensor):
                continue
            f.write(f"{k}={v}\n")
    for key, ext in (("outdegree_distribution", ".outdegrees"),
                     ("indegree_distribution", ".indegrees")):
        if key in stats:
            with open(basename + ext, "w") as f:
                for c in stats[key].tolist():
                    f.write(f"{c}\n")
