"""Graph transforms on the graph's device.

Counterpart of ``webgraph_tpu/transform/__init__.py`` (``:58-281``; the
reference's Transform.java, SURVEY §2.6): each transform builds an arc
array on the graph's device and hands it to ``CSRGraph.from_arcs``, one
device sort of ``(src << 32) | tgt`` keys with ``unique`` for dedup.  The
out-of-core forms are in ``transform/offline.py``, the labelled ones and the
labelled composition in ``transform/labelled.py``.

API (Transform.java):
  transpose / transpose_offline          (:1058-1144)
  symmetrize / symmetrize_offline        (:546-633)
  simplify / simplify_offline            (:645-705)
  map_offline, map_offline_batched       (:1160-1279)
  union                                  (:1659)
  compose                                (:1666-1811)
  filter_arcs, no_loops, NodeClassFilter (:103-534)
  gray_code_permutation, random_permutation,
  lexicographical_permutation            (:1940-2040), apply_permutation
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.graph import CSRGraph, expand_ranges

__all__ = [
    "transpose", "symmetrize", "simplify", "union", "map_offline", "compose",
    "filter_arcs", "no_loops", "NodeClassFilter", "gray_code_permutation",
    "random_permutation", "lexicographical_permutation", "apply_permutation",
]


def _csr(g) -> CSRGraph:
    if not isinstance(g, CSRGraph):
        raise TypeError(f"need a CSRGraph on a device, got "
                        f"{type(g).__name__}: load it with load_csr or "
                        f"to_csr(device=...)")
    return g


def _map(x, device) -> torch.Tensor:
    """A node map or permutation (array, list or tensor) as int64 on
    ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int64)


# ---------------------------------------------------------------------------
# basic transforms
# ---------------------------------------------------------------------------


def transpose(g: CSRGraph) -> CSRGraph:
    """Every arc reversed (Transform.transposeOffline, :1058-1144)."""
    return _csr(g).transpose()


def union(g0: CSRGraph, g1: CSRGraph) -> CSRGraph:
    """Arc-set union (Transform.union :1659)."""
    if _csr(g0).device != _csr(g1).device:
        raise ValueError("both graphs must be on one device")
    s0, t0 = g0.arc_sources(), g0.succ
    s1, t1 = g1.arc_sources(), g1.succ
    n = max(g0.num_nodes, g1.num_nodes)
    return CSRGraph.from_arcs(torch.cat([s0, s1]), torch.cat([t0, t1]), n,
                              dedup=True, device=g0.device)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """union(g, transpose(g)) (Transform.symmetrizeOffline :546-633)."""
    src, tgt = _csr(g).arc_sources(), g.succ
    return CSRGraph.from_arcs(torch.cat([src, tgt]), torch.cat([tgt, src]),
                              g.num_nodes, dedup=True, device=g.device)


def simplify(g: CSRGraph) -> CSRGraph:
    """Symmetrize and remove loops (Transform.simplify :645-705)."""
    src, tgt = _csr(g).arc_sources(), g.succ
    keep = src != tgt
    src, tgt = src[keep], tgt[keep]
    return CSRGraph.from_arcs(torch.cat([src, tgt]), torch.cat([tgt, src]),
                              g.num_nodes, dedup=True, device=g.device)


def map_offline(g: CSRGraph, node_map,
                num_nodes: Optional[int] = None) -> CSRGraph:
    """Apply a node map (Transform.mapOffline :1160-1279).

    ``node_map[x]`` is the image of node x, or -1 to drop the node and its
    arcs.  Non-injective maps merge nodes (arcs are deduplicated).  The
    default ``num_nodes`` is the largest image plus one."""
    node_map = _map(node_map, _csr(g).device)
    src, tgt = g.arcs()
    ms, mt = node_map[src], node_map[tgt]
    del src, tgt
    keep = (ms >= 0) & (mt >= 0)
    if num_nodes is None:
        num_nodes = int(node_map.max()) + 1 if node_map.numel() else 0
    return CSRGraph.from_arcs(ms[keep], mt[keep], num_nodes, dedup=True,
                              device=g.device)


def _free_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA device; None elsewhere (no check)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def compose(g0: CSRGraph, g1: CSRGraph) -> CSRGraph:
    """Graph composition: arc (x, z) iff some y has x -> y in g0 and y -> z
    in g1 (Transform.compose :1666-1811).  The expansion holds one arc per
    (x -> y, y -> z) pair, the sum of the middle nodes' outdegrees; it is
    checked against the device's free memory before it is allocated."""
    if _csr(g0).device != _csr(g1).device:
        raise ValueError("both graphs must be on one device")
    dev = g0.device
    s0, t0 = g0.arcs()
    n = max(g0.num_nodes, g1.num_nodes)
    if t0.numel() and int(t0.max()) >= g1.num_nodes:
        raise ValueError("a middle node of g0 lies outside g1")
    mid_deg = g1.outdegrees()[t0]
    total = int(mid_deg.sum())
    # the int64 pair arrays, their index, and from_arcs' key and sort
    need = 40 * total
    free = _free_bytes(dev)
    if free is not None and need > free:
        raise MemoryError(f"compose: the expansion needs ~{need} bytes, "
                          f"{free} free on {dev}")
    rep = torch.repeat_interleave(mid_deg, output_size=total)
    idx = expand_ranges(g1.offsets[t0], mid_deg, dev)
    return CSRGraph.from_arcs(s0[rep], g1.succ[idx], n, dedup=True,
                              device=dev)


# ---------------------------------------------------------------------------
# arc filters (Transform.ArcFilter :103, filterArcs :503-534)
# ---------------------------------------------------------------------------


def no_loops(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """The NO_LOOPS filter (Transform.java:219)."""
    return src != tgt


class NodeClassFilter:
    """Keeps arcs whose endpoints are in the same class (Transform.java
    :154)."""

    def __init__(self, classes):
        self.classes = torch.as_tensor(classes)

    def __call__(self, src, tgt):
        c = self.classes.to(src.device)
        return c[src] == c[tgt]


def filter_arcs(g: CSRGraph, pred: Callable) -> CSRGraph:
    """The arcs for which ``pred(src, tgt)`` (int64 tensors on the graph's
    device) is true (FilteredImmutableGraph :222)."""
    src, tgt = _csr(g).arcs()
    keep = torch.as_tensor(pred(src, tgt), device=g.device).to(torch.bool)
    return CSRGraph.from_arcs(src[keep], tgt[keep], g.num_nodes,
                              dedup=False, device=g.device)


# ---------------------------------------------------------------------------
# permutations (Transform.java:1940-2040)
# ---------------------------------------------------------------------------


def apply_permutation(g: CSRGraph, perm) -> CSRGraph:
    """Renumber nodes by a bijective permutation (old -> new)."""
    perm = _map(perm, _csr(g).device)
    src, tgt = g.arcs()
    return CSRGraph.from_arcs(perm[src], perm[tgt], g.num_nodes,
                              dedup=False, device=g.device)


def random_permutation(g: CSRGraph, seed: int = 0) -> torch.Tensor:
    """A uniformly random old -> new permutation, int64 on the graph's
    device: numpy's ``default_rng(seed).permutation``, the JAX package's
    generator, so the same seed gives the same permutation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(_csr(g).num_nodes).astype(np.int64)
    return torch.from_numpy(perm).to(g.device)


def _invert(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), dtype=order.dtype,
                              device=order.device)
    return inv


class _Rows:
    """Column keys of a CSR's rows: ``key(rows, c)`` is the key of column
    c of each row, an int64 below 2**31.  Lexicographic order is the order
    of the key sequences: a successor s is s + 1 and the end of a row 0.
    Gray order (Transform.grayCodePermutation :1940) is lexicographic order
    on the Gray decode of the row, its prefix-XOR bitvector: comparison
    descends at even positions (n - s, the end of a row first, 0) and
    ascends at odd ones (s + 1, the end of a row last, n + 1)."""

    def __init__(self, csr: CSRGraph, gray: bool):
        self.off = csr.offsets
        self.succ = csr.succ
        self.deg = csr.outdegrees()
        self.n = csr.num_nodes
        self.gray = gray
        if self.n + 1 >= 1 << 31:
            raise ValueError("row keys need n + 1 < 2**31")

    def key(self, rows: torch.Tensor, c) -> torch.Tensor:
        """Keys of column ``c`` (an int or an int64 tensor per row)."""
        has = self.deg[rows] > c
        pos = (self.off[rows] + c).clamp(max=max(self.succ.numel() - 1, 0))
        s = self.succ[pos].to(torch.int64) if self.succ.numel() else \
            torch.zeros_like(rows)
        if not self.gray:
            return torch.where(has, s + 1, 0)
        even = (torch.as_tensor(c, device=rows.device) & 1) == 0
        return torch.where(has, torch.where(even, self.n - s, s + 1),
                           torch.where(even, 0, self.n + 1))


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _row_sort_order(csr: CSRGraph, gray: bool, key_cols: int = 8,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """The rows' order on the device, equal to the JAX function's.

    First a stable sort over the first ``key_cols`` columns, two columns to
    an int64 key, the last pair first (a least-significant-first lexsort).
    Rows equal on those columns form tie groups; a group with a member
    deeper than the columns seen is resolved in bulk: each round finds, per
    group, the first column where its members are not all equal (every
    member against the group's first row, over the columns not yet seen)
    and stably sorts the members by (group, key of that column), which
    splits it.  Groups whose members are equal in full stop, in the order
    they had: the original order, as the JAX function's stable comparator
    sort leaves equal rows.  ``stats``: a dict to fill with the tie groups
    and rows resolved and the rounds."""
    n = csr.num_nodes
    dev = csr.device
    R = _Rows(csr, gray)
    deg = R.deg
    maxd = int(deg.max()) if n else 0
    K = min(key_cols, maxd)
    order = torch.arange(n, dtype=torch.int64, device=dev)
    if K == 0:
        return order
    for c in range(K - 2 + (K & 1), -1, -2):
        key = R.key(order, c)
        if c + 1 < K:
            key = (key << 32) | R.key(order, c + 1)
        order = order[_stable_order(key)]
    same = torch.ones(n, dtype=torch.bool, device=dev)
    for c in range(K):
        k = R.key(order, c)
        same[1:] &= k[1:] == k[:-1]
    same[0] = False
    gid = torch.cumsum(~same, 0) - 1
    ngroups = int(gid[-1]) + 1
    size = torch.bincount(gid, minlength=ngroups)
    deepest = torch.zeros(ngroups, dtype=torch.int64, device=dev)
    deepest.scatter_reduce_(0, gid, deg[order], "amax")
    need = (size > 1) & (deepest > K)
    pos = torch.nonzero(need[gid]).flatten()       # sorted positions
    if stats is not None:
        stats.update(tie_groups=int(need.sum()), tie_rows=pos.numel(),
                     rounds=0)
    agreed = torch.full((ngroups,), K, dtype=torch.int64, device=dev)
    g = gid[pos]
    while pos.numel():
        # the groups as 0..G-1, each with the columns its members agree on
        start = torch.ones(pos.numel(), dtype=torch.bool, device=dev)
        start[1:] = g[1:] != g[:-1]
        local = torch.cumsum(start, 0) - 1
        c0 = agreed[g[start]]
        rows = order[pos]
        lead = rows[start][local]
        d, dl = deg[rows], deg[lead]
        common = torch.minimum(d, dl)
        # the first column from c0 on where a member differs from its lead
        c_m = c0[local]
        cnt = (common - c_m).clamp(min=0)
        j = expand_ranges(c_m, cnt, dev)
        owner = torch.repeat_interleave(
            torch.arange(rows.numel(), device=dev), cnt,
            output_size=j.numel())
        diff = csr.succ[R.off[rows[owner]] + j] != \
            csr.succ[R.off[lead[owner]] + j]
        inf = torch.iinfo(torch.int64).max
        first = torch.where(d != dl, common, inf)
        first.scatter_reduce_(0, owner[diff], j[diff], "amin")
        split = torch.full((c0.numel(),), inf, dtype=torch.int64, device=dev)
        split.scatter_reduce_(0, local, first, "amin")
        # members equal in full: done, in the order they have
        live = split[local] < inf
        pos, rows, local = pos[live], rows[live], local[live]
        p = split[local]
        key = (local << 32) | R.key(rows, p)
        perm = _stable_order(key)
        rows, key, p = rows[perm], key[perm], p[perm]
        order[pos] = rows
        # the new groups: members agree on columns up to p, so a group
        # needs another round iff it has two members and one deeper than
        # p + 1
        start = torch.ones(pos.numel(), dtype=torch.bool, device=dev)
        start[1:] = key[1:] != key[:-1]
        new = torch.cumsum(start, 0) - 1
        nnew = int(new[-1]) + 1 if new.numel() else 0
        size = torch.bincount(new, minlength=nnew)
        deepest = torch.zeros(nnew, dtype=torch.int64, device=dev)
        deepest.scatter_reduce_(0, new, deg[rows], "amax")
        agreed = p[start] + 1
        keep = ((size > 1) & (deepest > agreed))[new]
        pos, g = pos[keep], new[keep]
        if stats is not None:
            stats["rounds"] += 1
    return order


def lexicographical_permutation(g: CSRGraph,
                                stats: Optional[dict] = None) -> torch.Tensor:
    """Sort adjacency rows lexicographically; returns old -> new, int64 on
    the graph's device (Transform.lexicographicalPermutation :2013).
    ``stats``: see ``_row_sort_order``."""
    return _invert(_row_sort_order(_csr(g), gray=False, stats=stats))


def gray_code_permutation(g: CSRGraph,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Sort adjacency rows in Gray-code order; returns old -> new, int64 on
    the graph's device (Transform.grayCodePermutation :1940)."""
    return _invert(_row_sort_order(_csr(g), gray=True, stats=stats))


# ---------------------------------------------------------------------------
# offline (external-memory) variants
# ---------------------------------------------------------------------------

from .offline import (  # noqa: E402
    BatchGraph,
    map_offline_batched,
    process_batch,
    simplify_offline,
    symmetrize_offline,
    transpose_offline,
)

__all__ += ["BatchGraph", "map_offline_batched", "process_batch",
            "symmetrize_offline", "simplify_offline", "transpose_offline"]

from .labelled import (  # noqa: E402
    LabelledBatchGraph,
    compose_labelled,
    process_labelled_batch,
    symmetrize_offline_labelled,
    transpose_offline_labelled,
)

__all__ += ["LabelledBatchGraph", "compose_labelled",
            "process_labelled_batch", "symmetrize_offline_labelled",
            "transpose_offline_labelled"]
