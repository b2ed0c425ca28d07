"""Procedural graphs past 2^31 arcs, regenerated one node range at a time.

``WebLikeGraph``: n nodes, node x has 12 local successors x+1 ... x+12
(mod n), which BVGraph codes as copy blocks and intervals, and 5 from a
seeded integer hash of (x, j) mod n, coded as residuals; each list sorted
and deduplicated.  At n = 2^27 that is about 2.28G arcs (over 2^31) under
2^31 nodes, and a ``.graph`` stream past 2^32 bits.  Any node range is
regenerated vectorised in numpy, so no host ever holds the whole graph;
``chip_smoke.py`` keeps a torch copy (``web_like_slice``) that runs on the
card, held equal to this one by ``tests/test_torch_big.py``.
"""

import numpy as np

LOCAL = 12
RANDOM = 5
# the hash's odd multipliers, as signed int64 (numpy wraps int64 products)
K_X = -7046029254386353131      # 0x9E3779B97F4A7C15
K_J = 7150378442421005337       # 0x633B3F4F1E1D6C19
K_1 = -4658895280553007687      # 0xBF58476D1CE4E5B9
K_2 = -7723592293110705685      # 0x94D049BB133111EB
M62 = (1 << 62) - 1


def _srl(h, s: int):
    """Logical right shift of int64 values."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def mix(h):
    """splitmix64's finaliser on int64 values, cut to [0, 2^62)."""
    h = h ^ _srl(h, 30)
    h = h * K_1
    h = h ^ _srl(h, 27)
    h = h * K_2
    h = h ^ _srl(h, 31)
    return h & M62


class WebLikeGraph:
    def __init__(self, num_nodes: int, seed: int = 0):
        assert num_nodes > LOCAL
        self.num_nodes = num_nodes
        self.seed = seed

    def slice(self, lo: int, hi: int):
        """(csr_off int64[hi - lo + 1], succ int64) of nodes [lo, hi)."""
        n = self.num_nodes
        x = np.arange(lo, hi, dtype=np.int64)[:, None]
        with np.errstate(over="ignore"):
            local = (x + np.arange(1, LOCAL + 1, dtype=np.int64)) % n
            rnd = mix(x * K_X + np.arange(RANDOM, dtype=np.int64) * K_J
                      + self.seed) % n
        row = np.sort(np.concatenate([local, rnd], axis=1), axis=1)
        keep = np.ones(row.shape, dtype=bool)
        keep[:, 1:] = row[:, 1:] != row[:, :-1]
        co = np.zeros(hi - lo + 1, dtype=np.int64)
        np.cumsum(keep.sum(axis=1), out=co[1:])
        return co, row[keep]

    def slices(self, step_nodes: int):
        lo = 0
        while lo < self.num_nodes:
            hi = min(lo + step_nodes, self.num_nodes)
            yield lo, hi, *self.slice(lo, hi)
            lo = hi
