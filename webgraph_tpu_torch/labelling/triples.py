"""IntegerTriplesArcLabelledImmutableGraph -- the reference's worked example
(examples/IntegerTriplesArcLabelledImmutableGraph.java:55-120): a list of
(source, target, label) integer triples exposed as an arc-labelled graph
with gamma-coded nonnegative integer labels, plus the main-method behavior
of reading TAB-separated triples and storing BVGraph +
BitStreamArcLabelledImmutableGraph.

Counterpart of ``webgraph_tpu/labelling/triples.py``: the triples are
sorted on the device the caller names (a stable sort of the packed keys),
and the labels stay a tensor aligned with the successors.
"""

from __future__ import annotations

from typing import IO, Union

import numpy as np
import torch

from ..core.graph import CSRGraph
from ..device import require_cuda
from .graph import ArcLabelledGraph, BitStreamArcLabelledGraph, \
    stable_key_order
from .labels import GammaCodedIntLabel

__all__ = ["integer_triples_graph", "store_integer_triples"]


def integer_triples_graph(triples, device=None) -> ArcLabelledGraph:
    """Build an :class:`ArcLabelledGraph` on ``device`` (the GPU when None,
    the CPU only when the caller names it) from (source, target, label)
    triples.  Order is irrelevant; multiple arcs are not allowed; the node
    count is the max index + 1; labels are nonnegative ints saved as
    :class:`GammaCodedIntLabel` (key "FOO", matching the reference
    example's prototype)."""
    dev = require_cuda() if device is None else torch.device(device)
    t = torch.from_numpy(np.asarray(triples, dtype=np.int64).reshape(-1, 3)
                         ).to(dev)
    proto = GammaCodedIntLabel("FOO")
    if t.shape[0] == 0:
        return ArcLabelledGraph(CSRGraph.from_lists([], device=dev),
                                torch.zeros(0, dtype=torch.int64), proto)
    if bool((t[:, 2] < 0).any()):
        raise ValueError("labels must be nonnegative")
    key, order = stable_key_order(t[:, 0], t[:, 1])
    if bool((key[1:] == key[:-1]).any()):
        raise ValueError("multiple arcs are not allowed")
    n = int(t[:, :2].max()) + 1
    g = CSRGraph.from_arcs(t[:, 0], t[:, 1], n, dedup=False, device=dev)
    return ArcLabelledGraph(g, t[order, 2], proto)


def store_integer_triples(src: Union[str, IO[str]], basename: str,
                          device=None) -> None:
    """The example's main(): read TAB-separated triples (one per line)
    and store the graph as BVGraph + BitStreamArcLabelledImmutableGraph
    under ``basename`` (underlying graph at ``basename-underlying``); the
    triples are sorted on ``device`` (the GPU when None)."""
    close = False
    if isinstance(src, str):
        f = open(src)
        close = True
    else:
        f = src
    try:
        triples = [tuple(int(v) for v in line.split())
                   for line in f if line.strip()]
    finally:
        if close:
            f.close()
    labelled = integer_triples_graph(triples, device=device)
    from ..codecs.bvgraph import BVGraph
    BVGraph.store(labelled.graph, basename + "-underlying")
    BitStreamArcLabelledGraph.store(labelled, basename,
                                    underlying_basename=basename
                                    + "-underlying")
