"""The decode plan: chunk bounds, halo lists, lane table and store layout.

Counterpart of ``webgraph_tpu/ops/kdecode.py`` ``plan_kernel_decode``
(``:1545``), ``_chunk_needs`` (``:1263``) and ``_chain_depths`` (``:1523``).

The node range is cut into cost-balanced chunks, one per lane.  Each lane
gets a store segment sized exactly to its halo lists plus its chunk's arcs,
since the outdegrees are known, so no lane is skipped for size and no hub
split is needed: a large node simply makes a long lane.

Warm plans (``halo_csr`` given) write the halo lists into the store up
front.  Cold plans see only the stream and its offsets, as the reference's
loader does (BVGraph.java:1479-1574): references come from the native
header-only scan, and the halo values are resolved by wavefront passes of
the decode itself (``resolve.resolve_halos``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from webgraph_tpu import native as _native

from .bitstream import stream_words
from .kdecode import (M_BASE, M_BIT, M_NODES, M_SEG, M_WCUR0, M_WIN, M_X,
                      KernelSpec, LanePlan, nmeta)

# a lane's step count is ~ its arcs plus ~STATE_COST header steps per node:
# chunks balance that cost, not raw arcs (equal-arc chunks hand sparse
# regions thousands of nodes per lane)
STATE_COST = 5
MAX_LANES = 1 << 20


def _needed_preds(starts, ends, refs, W, n):
    """``needed[i, j]``: chunk i's first nodes reference predecessor
    starts[i]-1-j across the boundary (only the first W nodes can, since
    ref <= W).  Without refs every in-range predecessor is needed."""
    L = len(starts)
    needed = np.zeros((L, max(W, 1)), dtype=bool)
    if W == 0:
        return needed
    if refs is None:
        for j in range(W):
            needed[:, j] = (starts - 1 - j) >= 0
        return needed
    empty = starts == ends
    lanes = np.arange(L)
    for o in range(W):
        xs = starts + o
        valid = ~empty & (xs < ends) & (xs < n)
        rr = np.where(valid, refs[np.minimum(xs, n - 1)], 0)
        ys = xs - rr
        cross = valid & (rr > 0) & (ys < starts)
        needed[lanes[cross], (starts - 1 - ys)[cross]] = True
    return needed


def chain_depths(refs, bounds, maxref: int):
    """Per-node pass after which the node's list is right in the store of a
    cold plan: 1 + the chunk-boundary crossings on its reference chain
    (chains are <= max_ref_count hops, BVGraph.java:455).  Returns (D, first
    node)."""
    first = int(bounds[0])
    n_end = int(bounds[-1])
    cnt = (bounds[1:] - bounds[:-1]).astype(np.int64)
    cs = np.repeat(bounds[:-1], cnt)
    nn = n_end - first
    x = np.arange(first, n_end, dtype=np.int64)
    r = np.asarray(refs[first:n_end], dtype=np.int64)
    valid = r > 0
    src = x - r
    src_i = np.clip(src - first, 0, max(nn - 1, 0))
    cross = (src < cs).astype(np.int16)
    D = np.ones(nn, dtype=np.int16)
    for _ in range(max(maxref, 1)):
        D = np.where(valid, D[src_i] + cross, D).astype(np.int16)
    return D, first


def _within(cnt):
    """Offsets 0..c-1 inside each of the runs of lengths ``cnt``."""
    tot = int(cnt.sum())
    return np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt,
                                                      cnt)


def plan_kernel_decode(offsets, outdegrees, settings, data, *, device,
                       halo_csr: Optional[Tuple[np.ndarray, np.ndarray]]
                       = None,
                       target_arcs_per_lane: int = 128,
                       node_base: int = 0, first_node: int = 0
                       ) -> Optional[LanePlan]:
    """Build the lane plan on ``device``, or return None when the format is
    outside the kernel's envelope (or a cold plan lacks the native scan).

    ``halo_csr``: (csr_off, succ) of every plan-local node's final list
    (warm plan); None plans cold.  ``node_base``: global id of plan-local
    node 0 (sliced plans, warm only); ``first_node``: first plan-local node
    to decode (the ones before it are halo only).  Per-node references come
    from the native header scan; without it a warm plan takes every
    predecessor in the window as halo."""
    spec = KernelSpec.from_settings(settings)
    if not spec.supported():
        return None
    offsets = np.asarray(offsets, dtype=np.int64)
    outd = np.asarray(outdegrees, dtype=np.int64)
    n = len(offsets) - 1
    if node_base + n >= (1 << 31):
        return None   # successor values must fit the int32 store
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    arc_base = int(cum[first_node])
    m = int(cum[n]) - arc_base
    W = settings.window_size
    CYC = W + 1
    cold = halo_csr is None
    if cold and node_base:
        raise ValueError("sliced plans (node_base != 0) need halo_csr")
    refs = None
    if W > 0:
        if _native.available():
            refs = _native.bv_scan_refs(data, offsets,
                                        settings).astype(np.int64)
        elif cold:
            return None

    L = max(1024, min(MAX_LANES, 1 << int(np.ceil(np.log2(
        max(m, 1) / target_arcs_per_lane + 1)))))
    cumc = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd + STATE_COST, out=cumc[1:])
    c0 = int(cumc[first_node])
    mc = int(cumc[n]) - c0
    bounds = np.empty(L + 1, dtype=np.int64)
    bounds[0] = first_node
    bounds[1:L] = np.searchsorted(
        cumc, c0 + (mc * np.arange(1, L, dtype=np.int64)) // L, side="left")
    bounds[L] = n
    bounds = np.maximum.accumulate(bounds)
    starts, ends = bounds[:-1], bounds[1:]
    active = starts != ends

    # halo lists: predecessors the chunk references across its boundary,
    # packed in ascending node order at the head of the segment
    needed = _needed_preds(starts, ends, refs, W, n)
    lanes_i = np.arange(L, dtype=np.int64)
    jj = np.arange(max(W, 1), dtype=np.int64)[None, :]
    ys = starts[:, None] - 1 - jj
    in_rng = active[:, None] & (ys >= 0)
    ysc = np.clip(ys, 0, max(n - 1, 0))
    pk = needed & in_rng
    dy = np.where(pk, outd[ysc], 0)
    # h[i, j]: rows taken by the lists of predecessors older than j's
    h = np.cumsum(dy[:, ::-1], axis=1)[:, ::-1] - dy
    halo = dy.sum(axis=1)
    arcs = cum[ends] - cum[starts]
    seg = np.where(active, halo + arcs, 0)
    store_off = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(seg, out=store_off[1:])

    meta = np.zeros((L, nmeta(W)), dtype=np.int64)
    meta[:, M_NODES] = ends - starts
    meta[:, M_BIT] = offsets[starts]
    meta[:, M_X] = starts + node_base
    meta[:, M_WCUR0] = halo
    meta[:, M_BASE] = store_off[:-1]
    meta[:, M_SEG] = seg
    if W > 0:
        # window slots keyed by GLOBAL node id, as the kernel's (x - ref)
        # % (W+1): slice-local keying desyncs when node_base % (W+1) != 0
        slot = (ysc + node_base) % CYC
        for j in range(W):
            v = in_rng[:, j]
            meta[lanes_i[v], M_WIN + slot[v, j]] = outd[ysc[v, j]]
            p = pk[:, j]
            meta[lanes_i[p], M_WIN + CYC + slot[p, j]] = h[p, j]

    # per-list halo (destination, length, predecessor)
    dst0 = (store_off[:-1, None] + h)[pk]
    cnt = dy[pk]
    ys_sel = ysc[pk]
    store = torch.zeros(int(store_off[-1]), dtype=torch.int32, device=device)
    wf = {}
    if not cold:
        if len(cnt):
            hco, hsu = halo_csr
            within = _within(cnt)
            hdst = np.repeat(dst0, cnt) + within
            hval = np.asarray(hsu)[np.repeat(np.asarray(hco)[ys_sel], cnt)
                                   + within]
            store[torch.from_numpy(hdst).to(device)] = torch.from_numpy(
                hval.astype(np.int32)).to(device)
    elif len(cnt):
        # each halo list's values live in the store itself, in the
        # predecessor's own chunk: recorded as a (dst, src, cnt) triple and
        # copied by resolve_halos once the source is right
        c_y = np.searchsorted(bounds, ys_sel, side="right") - 1
        src0 = store_off[c_y] + halo[c_y] + (cum[ys_sel] - cum[starts[c_y]])
        D, d_first = chain_depths(refs, bounds, settings.max_ref_count)
        wf = dict(wf_dst0=dst0, wf_src0=src0, wf_nodes=ys_sel, wf_cnt=cnt,
                  wf_chunk=c_y,
                  wf_depth=D[np.clip(ys_sel - d_first, 0,
                                     max(len(D) - 1, 0))].astype(np.int64))

    return LanePlan(
        spec=spec, device=torch.device(device),
        words=stream_words(data, device),
        meta=torch.from_numpy(meta).to(device), store=store,
        n=n, m=m, chunk_starts=bounds, halo_arcs=halo,
        store_off=store_off, cum_arcs=cum, outdegrees=outd, offsets=offsets,
        exp_arcs=seg, exp_nodes=ends - starts,
        expect=torch.from_numpy(np.stack([seg, ends - starts], axis=1)
                                .astype(np.int32)).to(device),
        data=np.asarray(data, dtype=np.uint8), settings=settings,
        node_base=node_base, arc_base=arc_base, cold=cold,
        resolved=not (cold and len(cnt) > 0), **wf)
