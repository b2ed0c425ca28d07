"""Synthetic web-graph generator for uk-2002-scale runs.

The port's own copy of ``webgraph_tpu/utils/synth.py``: same arguments, same
graph for the same seed (tests/test_torch_native.py holds the two equal).

Produces a CSR graph with the structural features BVGraph compression
exploits (SURVEY §2.1): power-law outdegrees, successor locality (small
gaps, consecutive runs -> intervals), and groups of consecutive nodes with
near-identical lists (-> reference copies), mirroring the regularities of
real web graphs the reference was built for (BVGraph.java:91-94).

Everything is vectorized numpy; ~300M arcs generate in seconds and the
encoded stream is cached on disk by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthesize_webgraph"]


def synthesize_webgraph(n: int, mean_outdegree: float = 16.0,
                        group: int = 4, global_frac: float = 0.1,
                        seed: int = 0):
    """Return (offsets int64[n+1], successors int64[m]).

    Nodes come in groups of ``group`` consecutive nodes: the leader gets a
    gap-coded local successor list; followers reuse the leader's list with
    a +-1 length perturbation (high reference/copy affinity).  A
    ``global_frac`` fraction of groups anchor their list uniformly at
    random instead of near their own id (long-range links -> residuals).
    """
    rng = np.random.default_rng(seed)
    n_groups = max(1, (n + group - 1) // group)

    # power-law-ish leader outdegrees: Pareto, clipped, mean scaled
    raw = rng.pareto(1.8, n_groups) + 1.0
    d_leader = np.minimum(raw * (mean_outdegree * 0.55), 4096.0)
    d_leader = np.maximum(d_leader.astype(np.int64), 1)

    # leader gap lists: gaps of 1 are common (interval runs)
    lg_off = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(d_leader, out=lg_off[1:])
    m_lead = int(lg_off[-1])
    u = rng.random(m_lead)
    gaps = np.where(u < 0.45, 1,
                    1 + (rng.geometric(0.25, m_lead) * (u * 7).astype(np.int64)))
    cs = np.cumsum(gaps)
    seg_base = cs[lg_off[:-1]] - gaps[lg_off[:-1]]
    row_of = np.repeat(np.arange(n_groups, dtype=np.int64), d_leader)
    rel = cs - seg_base[row_of]          # 1-based strictly increasing gaps

    totals = rel[lg_off[1:] - 1]
    leader_node = np.arange(n_groups, dtype=np.int64) * group
    anchor = np.maximum(leader_node - totals // 2, 0)
    is_global = rng.random(n_groups) < global_frac
    rand_anchor = rng.integers(0, np.maximum(n - totals - 2, 1))
    anchor = np.where(is_global, rand_anchor, anchor)
    # keep the last successor <= n-2 so a follower's single extra arc
    # (last + 1) stays in range without creating a duplicate
    anchor = np.minimum(anchor, np.maximum(n - totals - 2, 0))
    leader_succ = anchor[row_of] + rel

    # per-node outdegree: leader d plus {-1, 0, +1} for followers
    x = np.arange(n, dtype=np.int64)
    gid = x // group
    is_leader = (x % group) == 0
    delta = rng.integers(-1, 2, n)
    d = np.where(is_leader, d_leader[gid], d_leader[gid] + delta)
    d = np.clip(d, 0, None)

    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(d, out=offsets[1:])
    m = int(offsets[-1])

    # node arc i (i < min(d_x, d_leader)) copies the leader's arc i; the
    # (rare) extra arc extends past the leader's last successor
    arc_row = np.repeat(x, d)
    arc_i = np.arange(m, dtype=np.int64) - offsets[arc_row]
    g_arc = gid[arc_row]
    shared = arc_i < d_leader[g_arc]
    src = lg_off[g_arc] + np.minimum(arc_i, d_leader[g_arc] - 1)
    succ = leader_succ[src]
    last = leader_succ[lg_off[g_arc + 1] - 1]
    succ = np.where(shared, succ,
                    np.minimum(last + (arc_i - d_leader[g_arc]) + 1, n - 1))
    return offsets, succ
