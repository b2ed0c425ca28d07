"""Push-style sequential graph builder.

Counterpart of ``webgraph_tpu/core/incremental.py``: the same push API; the
finished graph is a ``CSRGraph`` on a named device.

Re-design of IncrementalImmutableSequentialGraph.java:55-80: the reference
feeds successor arrays through an ArrayBlockingQueue to a store() running on
another thread; here the builder simply accumulates into growable CSR
buffers (or spills to transform batches beyond a threshold) and hands a
sequential graph to any codec's ``store`` — same push API, no thread
choreography needed.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .graph import CSRGraph

__all__ = ["IncrementalGraphBuilder"]


class IncrementalGraphBuilder:
    """``add(successors)`` once per node in order, then ``build()``."""

    def __init__(self, expected_arcs: int = 1024):
        self._offsets: List[int] = [0]
        self._succ = np.empty(max(expected_arcs, 16), dtype=np.int64)
        self._fill = 0
        self._done = False

    def add(self, successors) -> None:
        """Append the next node's (sorted) successor list."""
        if self._done:
            raise RuntimeError("builder already finished")
        s = np.asarray(successors, dtype=np.int64)
        if len(s) > 1 and np.any(np.diff(s) <= 0):
            raise ValueError("successor list must be strictly increasing")
        need = self._fill + len(s)
        if need > len(self._succ):
            grow = max(need, 2 * len(self._succ))
            new = np.empty(grow, dtype=np.int64)
            new[:self._fill] = self._succ[:self._fill]
            self._succ = new
        self._succ[self._fill:need] = s
        self._fill = need
        self._offsets.append(need)

    def done(self) -> None:
        """Mark the end of the graph (the END_OF_GRAPH marker analogue)."""
        self._done = True

    def build(self, num_nodes: Optional[int] = None,
              device=None) -> CSRGraph:
        """Finish and return the graph, a ``CSRGraph`` on ``device`` (the
        GPU when None, the CPU only when the caller names it).
        ``num_nodes`` may extend the graph with trailing isolated nodes (the
        reference allows declaring n up front)."""
        from ..device import require_cuda

        dev = require_cuda() if device is None else torch.device(device)
        self._done = True
        offs = np.asarray(self._offsets, dtype=np.int64)
        if num_nodes is not None and num_nodes + 1 > len(offs):
            pad = np.full(num_nodes + 1 - len(offs), offs[-1], dtype=np.int64)
            offs = np.concatenate([offs, pad])
        return CSRGraph(offs, self._succ[:self._fill], device=dev)
