"""Web-crawl-like graph, made on the device from the seed.

A torch copy of ``synthesize_webgraph`` (``webgraph_tpu_torch/utils/synth.py``,
the numpy generator the repository's earlier runs used): Pareto leader
outdegrees clipped at 4,096, gap-coded local lists (gaps of 1 are common,
so BVGraph finds intervals), groups of consecutive nodes that copy their
leader's list with a +-1 length change (reference copies), and a share of
groups anchored at random (residuals).  The draws come from a
``torch.Generator`` on ``device`` in a few large calls, so the same seed
gives the same graph on the same kind of device.

One change from the numpy original: a leader list whose gaps would reach
past node n-2 is cut there, so every graph is valid at any n (ascending,
distinct successors below n).  At the configured 18.5M nodes no list comes
near that (the longest spans a few tens of thousands of ids), so nothing is
cut there.
"""

from __future__ import annotations

import torch

_I64 = torch.int64


def _seg_ids(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """Row id of every element of a CSR whose rows have ``lengths``."""
    rows = torch.arange(lengths.numel(), dtype=_I64, device=lengths.device)
    return torch.repeat_interleave(rows, lengths, output_size=total)


def _offsets(lengths: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(lengths.numel() + 1, dtype=_I64, device=lengths.device)
    torch.cumsum(lengths, 0, out=off[1:])
    return off


def generate(params: dict, seed: int, device) -> tuple:
    """(offsets int64[n+1], successors int32[m]) on ``device``.

    ``params``: ``nodes``, ``mean_outdegree``, ``group``, ``global_frac``
    (the numpy generator's arguments)."""
    n = int(params["nodes"])
    mean = float(params["mean_outdegree"])
    group = int(params["group"])
    gfrac = float(params["global_frac"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=dev, generator=gen)
    ng = max(1, (n + group - 1) // group)

    # leader outdegrees: Pareto(1.8) + 1 = (1 - U)^(-1/1.8), scaled, clipped
    raw = (1.0 - torch.rand(ng, **f64)).pow(-1.0 / 1.8)
    d_lead = torch.clamp(raw * (mean * 0.55), max=4096.0).to(_I64)
    d_lead.clamp_(min=1)
    del raw
    m_lead = int(d_lead.sum())

    # gaps: 1 with probability 0.45, else 1 + Geometric(0.25) * floor(7u)
    u = torch.rand(m_lead, **f64)
    geo = torch.empty(m_lead, dtype=torch.float64, device=dev)
    geo.geometric_(0.25, generator=gen)
    gaps = torch.where(u < 0.45, 1, 1 + geo.to(_I64) * (u * 7).to(_I64))
    del u, geo
    row = _seg_ids(d_lead, m_lead)
    lg_off = _offsets(d_lead)
    cs = torch.cumsum(gaps, 0)
    rel = cs - (cs - gaps)[lg_off[:-1]][row]     # 1-based, strictly rising
    del cs, gaps
    # cut a list where it would pass node n-2 (only happens at tiny n)
    keep = rel <= max(n - 2, 1)
    if not bool(keep.all()):
        rel, row = rel[keep], row[keep]
        d_lead = torch.bincount(row, minlength=ng)
        lg_off = _offsets(d_lead)
    del keep
    m_lead = rel.numel()

    totals = rel[lg_off[1:] - 1]
    leader = torch.arange(ng, dtype=_I64, device=dev) * group
    anchor = torch.clamp(leader - totals // 2, min=0)
    is_global = torch.rand(ng, **f64) < gfrac
    hi = torch.clamp(n - totals - 2, min=1)
    rand_anchor = (torch.rand(ng, **f64) * hi).to(_I64)
    anchor = torch.where(is_global, rand_anchor, anchor)
    anchor = torch.minimum(anchor, torch.clamp(n - totals - 2, min=0))
    lead_succ = anchor[row] + rel
    del rel, row, anchor, rand_anchor, is_global, hi, totals

    # outdegrees: the leader's, followers +-1
    x = torch.arange(n, dtype=_I64, device=dev)
    gid = x // group
    is_leader = (x % group) == 0
    delta = torch.randint(-1, 2, (n,), dtype=_I64, device=dev, generator=gen)
    d = torch.where(is_leader, d_lead[gid], d_lead[gid] + delta).clamp_(min=0)
    del delta, is_leader
    offsets = _offsets(d)
    m = int(offsets[-1])

    # arc i < the leader's outdegree copies the leader's arc i; a follower's
    # extra arc extends one past the leader's last successor
    arc_row = _seg_ids(d, m)
    arc_i = torch.arange(m, dtype=_I64, device=dev) - offsets[arc_row]
    g_arc = gid[arc_row]
    del arc_row, d, gid, x
    dl = d_lead[g_arc]
    shared = arc_i < dl
    succ = lead_succ[lg_off[g_arc] + torch.minimum(arc_i, dl - 1)]
    last = lead_succ[lg_off[g_arc + 1] - 1]
    succ = torch.where(shared, succ,
                       torch.clamp(last + (arc_i - dl) + 1, max=n - 1))
    return offsets, succ.to(torch.int32)
