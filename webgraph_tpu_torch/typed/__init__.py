"""Typed graphs (SURVEY §2.8).

Counterpart of ``webgraph_tpu/typed/__init__.py``, the same names and files.
Nodes carry a type in the 16 high bits and an id-within-type in the low 48
(TypedGraph.java:35-63).  A typed graph is stored as one compressed stream
per type (BVImmutableTypedGraph.java:45-75) plus a *type graph* describing
which types point to which.

- :func:`node` / :func:`node_type` / :func:`node_id` -- packing helpers.
- :func:`convert_to_typed` -- split any graph + node->type map into per-type
  BVGraph streams with successors rewritten to packed typed ids, plus the
  per-type ``.ids`` mapping files (ConvertToTypedGraph.java:61-66).  The
  split is numpy on the host (packed ids need 64 bits, past the device
  CSR's int32 successors); each stream is the native encoder's, as the JAX
  package's ``BVGraph.store`` of a CSR graph, so the files are
  byte-identical.
- :class:`BVTypedGraph` -- load and random-access the per-type family; its
  :meth:`~BVTypedGraph.type_graph` is a ``CSRGraph`` on a named device.
- :func:`estimate_typed_graph_size` -- size estimate of the typed split
  (EstimateTypedGraphSize.java:49).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import native as _native
from ..codecs.bvgraph import BVGraph, BVGraphSettings, _finish_native
from ..core.graph import CSRGraph, host_csr
from ..utils import properties as javaprops

__all__ = ["ID_BITS", "node", "node_type", "node_id", "convert_to_typed",
           "BVTypedGraph", "estimate_typed_graph_size"]

ID_BITS = 48
_ID_MASK = (1 << ID_BITS) - 1


def node(t: int, i: int) -> int:
    """Pack (type, id) into a typed node (TypedGraph.node :60)."""
    return (t << ID_BITS) | i


def node_type(x: int) -> int:
    return x >> ID_BITS


def node_id(x: int) -> int:
    return x & _ID_MASK


def _local_ids(types: np.ndarray, num_types: int):
    """(local id of every node within its type, nodes per type): nodes of
    each type numbered in node order."""
    local = np.zeros(len(types), dtype=np.int64)
    counts = np.zeros(num_types, dtype=np.int64)
    for t in range(num_types):
        idx = np.flatnonzero(types == t)
        local[idx] = np.arange(len(idx), dtype=np.int64)
        counts[t] = len(idx)
    return local, counts


def convert_to_typed(g, types: np.ndarray, basename: str,
                     settings: Optional[BVGraphSettings] = None) -> Dict:
    """Split ``g`` (a ``CSRGraph`` on any device, or any graph with
    ``iter_nodes``) into per-type streams.

    ``types[x]`` is the type of node x.  Nodes of each type get local ids in
    node order; per-type ``.ids`` files record the original node of each
    local id; successors are rewritten to packed typed ids.  Writes
    ``basename-<t>.{graph,offsets,properties}``, ``basename-<t>.ids`` and a
    master ``basename.properties``.
    """
    types = np.asarray(types, dtype=np.int64)
    n = g.num_nodes
    if len(types) != n:
        raise ValueError(f"types has {len(types)} entries for {n} nodes")
    num_types = int(types.max(initial=-1)) + 1
    local, counts = _local_ids(types, num_types)
    packed = (types << ID_BITS) | local  # original node -> typed node

    co, su = host_csr(g)
    m = len(su)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(co))
    rewritten = packed[su]
    # each list sorted by its typed ids: one sort by (source, typed id)
    order = np.lexsort((rewritten, src))
    src_t, rew = types[src[order]], rewritten[order]
    s = settings or BVGraphSettings()
    for t in range(num_types):
        orig = np.flatnonzero(types == t).astype(np.int64)
        sub_co = np.zeros(len(orig) + 1, dtype=np.int64)
        np.cumsum(co[orig + 1] - co[orig], out=sub_co[1:])
        sub_su = rew[src_t == t]
        # the native threaded encode of the JAX package's CSR store, with
        # its thread heuristic (BVGraph.java:2382-2386)
        k = len(orig)
        threads = max(1, min(os.cpu_count() or 1, k // 100_000))
        _finish_native(f"{basename}-{t}", s, "BVGraph properties", k,
                       _native.bv_encode(sub_co, sub_su, s, threads=threads))
        orig.astype(">i8").tofile(f"{basename}-{t}.ids")

    # the type graph: arcs between types
    pairs = np.unique(types[src] * max(num_types, 1) + types[su])
    a, b = np.divmod(pairs, max(num_types, 1))
    tg_lists = [b[a == t] for t in range(num_types)]
    props = {
        "graphclass": "it.unimi.dsi.big.webgraph.typed.BVImmutableTypedGraph",
        "types": str(num_types),
        "nodes": str(n),
        "arcs": str(m),
        "typecounts": ",".join(str(int(c)) for c in counts),
        "typegraph": ";".join(",".join(map(str, lst.tolist()))
                              for lst in tg_lists),
    }
    javaprops.dump(props, basename + ".properties",
                   "BVImmutableTypedGraph properties")
    return props


class BVTypedGraph:
    """Per-type compressed streams with packed-typed-id access
    (BVImmutableTypedGraph.java:45).  The per-type streams are host
    ``BVGraph``s; the type graph is a ``CSRGraph`` on ``device`` (the GPU
    when None, the CPU only when the caller names it)."""

    def __init__(self, basename: str, device=None):
        from ..device import require_cuda

        dev = require_cuda() if device is None else torch.device(device)
        props = javaprops.load(basename + ".properties")
        self.properties = props
        self.num_types = int(props["types"])
        self._n = int(props["nodes"])
        self._m = int(props["arcs"])
        self.type_counts = np.asarray(
            [int(c) for c in props["typecounts"].split(",")], dtype=np.int64)
        self.graphs = [BVGraph.load(f"{basename}-{t}")
                       for t in range(self.num_types)]
        self.ids = [np.fromfile(f"{basename}-{t}.ids", dtype=">i8")
                    .astype(np.int64) for t in range(self.num_types)]
        tg_lists = []
        spec = props.get("typegraph", "")
        for part in spec.split(";") if spec else []:
            tg_lists.append(np.asarray(
                [int(v) for v in part.split(",") if v], dtype=np.int64))
        while len(tg_lists) < self.num_types:
            tg_lists.append(np.zeros(0, dtype=np.int64))
        self._type_graph = CSRGraph.from_lists(tg_lists, device=dev)

    def type_graph(self) -> CSRGraph:
        return self._type_graph

    @property
    def num_nodes(self) -> int:
        return self._n

    def num_nodes_of_type(self, t: int) -> int:
        return int(self.type_counts[t])

    @property
    def num_arcs(self) -> int:
        return self._m

    def outdegree(self, x: int) -> int:
        return self.graphs[node_type(x)].outdegree(node_id(x))

    def successors(self, x: int) -> np.ndarray:
        """Successors of a packed typed node, as packed typed nodes."""
        return self.graphs[node_type(x)].successors(node_id(x))

    def original_node(self, x: int) -> int:
        """Map a typed node back to the pre-split node id."""
        return int(self.ids[node_type(x)][node_id(x)])


def estimate_typed_graph_size(g, types: np.ndarray) -> Dict[str, float]:
    """Rough per-type compressed-size estimate (gap entropy bound), the
    planning role of EstimateTypedGraphSize.java:49."""
    types = np.asarray(types, dtype=np.int64)
    num_types = int(types.max(initial=-1)) + 1
    local, counts = _local_ids(types, num_types)
    packed = (types << ID_BITS) | local
    co, su = host_csr(g)
    bits = np.zeros(num_types)
    for x in range(g.num_nodes):
        succ = su[co[x]:co[x + 1]]
        if not len(succ):
            continue
        vals = np.sort(packed[succ] & _ID_MASK)
        gaps = np.diff(vals, prepend=0) + 1
        bits[types[x]] += float(np.sum(2 * np.floor(np.log2(gaps)) + 1))
    return {"bits_per_type": bits, "total_bits": float(bits.sum()),
            "nodes_per_type": counts}
