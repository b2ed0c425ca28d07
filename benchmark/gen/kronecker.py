"""Graph500 Kronecker graph, made on the device from the seed.

The Graph500 specification's generator (kronecker_generator.m of its
reference code): ``edgefactor * 2^scale`` edges, each endpoint's bits drawn
level by level with the initiator probabilities A, B, C, D (D = 1 - A - B -
C), then the vertex labels randomly permuted.  The graph it defines is
stored undirected, as Graph500 and LDBC Graphalytics' ``graph500-*`` read
it: both directions of every edge, self-loops and duplicate arcs dropped,
ids that no edge touches kept as nodes of outdegree 0.  The draws come from
a ``torch.Generator`` on ``device``, so the same seed gives the same graph
on the same kind of device.
"""

from __future__ import annotations

import torch

_I64 = torch.int64


def generate(params: dict, seed: int, device) -> tuple:
    """(offsets int64[n+1], successors int32[m]) on ``device``.

    ``params``: ``scale``, ``edgefactor``, ``A``, ``B``, ``C``."""
    scale = int(params["scale"])
    n = 1 << scale
    edges = int(params["edgefactor"]) * n
    a, b, c = float(params["A"]), float(params["B"]), float(params["C"])
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    src = torch.zeros(edges, dtype=_I64, device=dev)
    dst = torch.zeros(edges, dtype=_I64, device=dev)
    for level in range(scale):
        ii = torch.rand(edges, device=dev, generator=gen) > ab
        thr = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(edges, device=dev, generator=gen) > thr
        del thr
        src |= ii.to(_I64) << level
        dst |= jj.to(_I64) << level
        del ii, jj
    perm = torch.randperm(n, device=dev, generator=gen)
    src, dst = perm[src], perm[dst]
    del perm

    loop = src == dst
    if bool(loop.any()):
        src, dst = src[~loop], dst[~loop]
    del loop
    key = torch.cat([(src << 32) | dst, (dst << 32) | src])
    del src, dst
    key = torch.unique(key)        # sorted: by source, then by target
    counts = torch.bincount(key >> 32, minlength=n)
    offsets = torch.zeros(n + 1, dtype=_I64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    return offsets, (key & 0xFFFFFFFF).to(torch.int32)
