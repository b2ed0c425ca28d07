"""Inputs of HyperBall's merge (``algo.hyperball.merge_rows``), shared by the
CPU and card tests of the port (numpy and the port only: the card's machine
has no jax).

``crawl(n, seed)`` is a CSR of n nodes with every shape a list can take in
the merge: empty lists (every seventh node, and a run of 40 at the end),
self-loops (every node divisible by 11 lists itself), one list of 5,000
distinct arcs (node 3; n - 1 where n is smaller), repeated successors, and
short runs of nearby ids otherwise.  ``registers`` are random uint8 rows,
so every byte of a row can win a max, and a share of rows that already hold
their successors' maxima, so some nodes do not change.  ``merge_reference`` is a node-by-node numpy
merge.  ``counters`` are rows for HyperBall's count estimate
(``algo.hyperball.estimate_rows``): rows of zeros, nearly empty rows (the
small-range branch), rows as HyperLogLog fills them, and uniform rows, every
register at most ``top``; ``exact_top(log2m)`` is the highest register for
which a row's float64 sum of 2^-r is exact in any order.
"""

from __future__ import annotations

import numpy as np

LOG2MS = (2, 4, 6, 8)
HUB, HUB_ARCS = 3, 5000


def crawl(n: int = 6000, seed: int = 0):
    """(offsets int64[n+1], successors int64[m])."""
    rng = np.random.default_rng(seed)
    lists = []
    for x in range(n):
        if x == HUB:
            lst = np.sort(rng.choice(n, min(HUB_ARCS, n - 1),
                                     replace=False))
        elif x % 7 == 0 or x >= n - 40:
            lst = np.zeros(0, dtype=np.int64)
        else:
            k = int(rng.integers(1, 24))
            lst = np.clip(x + rng.integers(-60, 60, size=k), 0, n - 1)
            if x % 11 == 0:
                lst = np.append(lst, x)
        lists.append(np.asarray(lst, dtype=np.int64))
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(x) for x in lists], out=co[1:])
    return co, np.concatenate(lists)


def registers(n: int, log2m: int, seed: int = 0) -> np.ndarray:
    """uint8 (n, 2^log2m): random bytes below 64, every fifth row all 63
    (it holds every successor's maximum, so it cannot change)."""
    rng = np.random.default_rng(seed + 1)
    regs = rng.integers(0, 64, size=(n, 1 << log2m), dtype=np.uint8)
    regs[::5] = 63
    return regs


def merge_reference(co, su, regs, nodes=None):
    """(merged rows, changed flags) of ``nodes`` (all when None), node by
    node."""
    nodes = np.arange(len(co) - 1) if nodes is None else np.asarray(nodes)
    out = regs[nodes].copy()
    for i, x in enumerate(nodes):
        ys = su[co[x]:co[x + 1]]
        if len(ys):
            out[i] = np.maximum(out[i], regs[ys].max(axis=0))
    return out, (out != regs[nodes]).any(axis=1)


def node_list(n: int, seed: int = 0) -> np.ndarray:
    """A sparse, ascending node list as a systolic round has it: about one
    node in nine, the hub and an empty list among them."""
    rng = np.random.default_rng(seed + 2)
    pick = rng.random(n) < 0.11
    pick[[HUB, 0, n - 1]] = True
    return np.flatnonzero(pick).astype(np.int64)


def exact_top(log2m: int) -> int:
    """53 - log2m: each partial sum of 2^-r over a row is then a multiple of
    2^-top no larger than 2^log2m, 53 bits at most."""
    return 53 - log2m


def counters(n: int, log2m: int, top: int, seed: int = 0) -> np.ndarray:
    """uint8 (n, 2^log2m), every register <= ``top``.  Row i by i % 4: all
    zeros; zeros but for a few registers <= 3 (the small-range branch);
    1 + a geometric(1/2) count, as HyperLogLog fills a counter; uniform in
    [0, top].  Row 5 holds ``top`` in its last register."""
    rng = np.random.default_rng(seed + 3)
    m = 1 << log2m
    regs = np.zeros((n, m), dtype=np.int64)
    few = rng.random((n, m)) < 2.0 / m
    regs[1::4] = np.where(few, rng.integers(1, 4, size=(n, m)), 0)[1::4]
    regs[2::4] = rng.geometric(0.5, size=(n, m))[2::4]
    regs[3::4] = rng.integers(0, top + 1, size=(n, m))[3::4]
    if n > 5:
        regs[5, -1] = top
    return np.minimum(regs, top).astype(np.uint8)
