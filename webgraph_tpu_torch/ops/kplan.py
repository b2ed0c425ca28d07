"""The decode plan: chunk bounds, halo lists, lane table and store layout.

Counterpart of ``webgraph_tpu/ops/kdecode.py`` ``plan_kernel_decode``
(``:1545``), ``_chunk_needs`` (``:1263``) and ``_chain_depths`` (``:1523``).

The node range is cut into cost-balanced chunks, one per lane.  Each lane
gets a store segment sized exactly to its halo lists plus its chunk's arcs,
since the outdegrees are known, so no lane is skipped for size.

A list of more than ``SPLIT_ARCS`` arcs is split: one thread decoding it
alone would set B1's time (~1.5 arcs/us).  The list gets a chunk of its own
(its head lane), and the native checkpoint parse (``native.hub_parse``, the
reference's ``wg_bv_hub_parse``) cuts its residual run into runs of at most
``SEG_ARCS`` arcs and ``SEG_BITS`` bits, each decoded by a preset lane of
its own that writes into the head lane's rows at the run's index
(``kdecode.SplitPlan``).  The store layout, B2's runs and the cold plan's
halo sources stay those of the unsplit plan.  The plan keeps a checkpoint
(bit, value, count) a run, never a successor.  A list with copies or
intervals is merged after B1 (``kdecode.merge_split``).  The span
``wg.plan.split`` holds the outdegree test and the parse; the counters
``plan.split_lists`` (lists over the threshold), ``plan.split_segments``
(preset lanes) and ``plan.split_merged`` (lists that need the merge) count
every plan, 0 where nothing is split.

Warm plans (``halo_csr`` given) write the halo lists into the store up
front.  Cold plans see only the stream and its offsets, as the reference's
loader does (BVGraph.java:1479-1574): references come from the native
header-only scan, and the halo values are resolved by wavefront passes of
the decode itself (``resolve.resolve_halos``).  A cold plan that starts past
node 0 (``first_node``, a shard's plan) decodes on the host, at plan time,
the lists of predecessors before its first node: no lane holds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native as _native

from ..utils.trace import count, span
from .bitstream import stream_words
from .kdecode import (M_BASE, M_BIT, M_NODES, M_SEG, M_WCUR0, M_WIN, M_X,
                      KernelSpec, LanePlan, SplitPlan, nmeta, preset_col)
from .resolve import pred_values as _pred_values

# a lane's step count is ~ its arcs plus ~STATE_COST header steps per node:
# chunks balance that cost, not raw arcs (equal-arc chunks hand sparse
# regions thousands of nodes per lane)
STATE_COST = 5
MAX_LANES = 1 << 20
# a list of more arcs than SPLIT_ARCS is split across preset lanes of at
# most SEG_ARCS arcs and SEG_BITS bits each (the reference's bit cut,
# webgraph_tpu/ops/kdecode.py plan_kernel_decode: 32 * (r_cap - 2) - 256)
SPLIT_ARCS = 8192
SEG_ARCS = 4096
SEG_BITS = 32 * (160 - 2) - 256


def _needed_preds(starts, ends, refs, W, n):
    """``needed[i, j]``: chunk i's first nodes reference predecessor
    starts[i]-1-j across the boundary (only the first W nodes can, since
    ref <= W)."""
    L = len(starts)
    needed = np.zeros((L, max(W, 1)), dtype=bool)
    if W == 0:
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
    (chains are <= max_ref_count hops, BVGraph.java:455).  A chain ends at
    a node whose reference lies before the first node: that list is
    decoded on the host, right from the start.  Returns (D, first node)."""
    first = int(bounds[0])
    n_end = int(bounds[-1])
    cnt = (bounds[1:] - bounds[:-1]).astype(np.int64)
    cs = np.repeat(bounds[:-1], cnt)
    nn = n_end - first
    x = np.arange(first, n_end, dtype=np.int64)
    r = np.asarray(refs[first:n_end], dtype=np.int64)
    src = x - r
    valid = (r > 0) & (src >= first)
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


def _split_lists(data, settings, offsets, outd, refs, first_node: int,
                 split_arcs: int, seg_arcs: int, seg_bits: int):
    """The lists to split and their checkpoints (``native.hub_parse``), or
    None when there is none or the parse fails (the plan then splits
    nothing)."""
    xs = np.flatnonzero(outd[first_node:] > split_arcs) + first_node
    if refs is not None:    # a reference before node 0: a corrupt header
        xs = xs[refs[xs] <= xs]
    if not len(xs):
        return None
    try:
        hp = _native.hub_parse(data, xs, offsets[xs], outd, settings,
                               seg_arcs, seg_bits)
    except RuntimeError:
        return None
    return xs, hp


def plan_kernel_decode(offsets, outdegrees, settings, data, *, device,
                       halo_csr: Optional[Tuple[np.ndarray, np.ndarray]]
                       = None,
                       target_arcs_per_lane: int = 128,
                       node_base: int = 0, first_node: int = 0,
                       split_arcs: int = SPLIT_ARCS,
                       seg_arcs: int = SEG_ARCS, seg_bits: int = SEG_BITS
                       ) -> Optional[LanePlan]:
    """Build the lane plan on ``device``, or return None when the format is
    outside the kernel's envelope.

    ``halo_csr``: (csr_off, succ) of every plan-local node's final list
    (warm plan); None plans cold.  ``node_base``: global id of plan-local
    node 0 (sliced plans, warm only); ``first_node``: first plan-local node
    to decode (the ones before it are halo only).  Per-node references come
    from the native header scan (``native.bv_scan_refs``).  Lists of more
    than ``split_arcs`` arcs are split into preset lanes of at most
    ``seg_arcs`` arcs and ``seg_bits`` bits (module docstring); the
    defaults are the module's ``SPLIT_ARCS``, ``SEG_ARCS``, ``SEG_BITS``."""
    if not 0 < seg_bits < 1 << 29 or seg_arcs < 1:
        raise ValueError("seg_bits must lie in 1..2^29 - 1, seg_arcs >= 1")
    spec = KernelSpec.from_settings(settings)
    if not spec.supported():
        return None
    offsets = np.asarray(offsets, dtype=np.int64)
    outd = np.asarray(outdegrees, dtype=np.int64)
    n = len(offsets) - 1
    if node_base + n >= (1 << 31):
        return None   # successor values must fit the int32 store
    W = settings.window_size
    CYC = W + 1
    cold = halo_csr is None
    if cold and node_base:
        raise ValueError("sliced plans (node_base != 0) need halo_csr")
    refs = None
    if W > 0:
        with span("plan.scan_refs"):
            refs = _native.bv_scan_refs(data, offsets,
                                        settings).astype(np.int64)

    with span("plan.split"):
        hub = _split_lists(data, settings, offsets, outd, refs, first_node,
                           split_arcs, seg_arcs, seg_bits)
    with span("plan.chunks"):
        cum = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(outd, out=cum[1:])
        arc_base = int(cum[first_node])
        m = int(cum[n]) - arc_base
        L = max(1024, min(MAX_LANES, 1 << int(np.ceil(np.log2(
            max(m, 1) / target_arcs_per_lane + 1)))))
        # a split list's chunk costs its head lane's work, not its residuals
        cost_n = outd + STATE_COST
        if hub is not None:
            cost_n = cost_n.copy()
            cost_n[hub[0]] -= hub[1]["res_cnt"]
        cumc = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cost_n, out=cumc[1:])
        c0 = int(cumc[first_node])
        mc = int(cumc[n]) - c0
        bounds = np.empty(L + 1, dtype=np.int64)
        bounds[0] = first_node
        bounds[1:L] = np.searchsorted(
            cumc, c0 + (mc * np.arange(1, L, dtype=np.int64)) // L,
            side="left")
        bounds[L] = n
        bounds = np.maximum.accumulate(bounds)
        if hub is not None:     # each split list alone in its chunk
            bounds = np.sort(np.concatenate([bounds, hub[0], hub[0] + 1]))
            L = len(bounds) - 1
        starts, ends = bounds[:-1], bounds[1:]
        active = starts != ends

    # halo lists: predecessors the chunk references across its boundary,
    # packed in ascending node order at the head of the segment
    with span("plan.needed_preds"):
        needed = _needed_preds(starts, ends, refs, W, n)
    with span("plan.lanes"):
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
        store = torch.zeros(int(store_off[-1]), dtype=torch.int32,
                            device=device)
        wf, src0 = {}, None
        if not cold:
            if len(cnt):
                hco, hsu = halo_csr
                within = _within(cnt)
                hdst = np.repeat(dst0, cnt) + within
                hval = np.asarray(hsu)[np.repeat(np.asarray(hco)[ys_sel],
                                                 cnt) + within]
                store[torch.from_numpy(hdst).to(device)] = torch.from_numpy(
                    hval.astype(np.int32)).to(device)
        elif len(cnt):
            # each halo list's values live in the store itself, in the
            # predecessor's own chunk: recorded as a (dst, src, cnt) triple
            # and copied by resolve_halos once the source is right
            c_y = np.searchsorted(bounds, ys_sel, side="right") - 1
            # a predecessor before the first decoded node (shard plans with
            # first_node > 0) or in an empty lane has no device source: its
            # list is decoded on the host here and written in place
            on_dev = (ys_sel >= bounds[0]) & active[np.maximum(c_y, 0)]
            if not on_dev.all():
                off = ~on_dev
                c_off = cnt[off]
                hval = _pred_values(data, settings, offsets, outd, node_base,
                                    ys_sel[off], c_off)
                hdst = np.repeat(dst0[off], c_off) + _within(c_off)
                store[torch.from_numpy(hdst).to(device)] = torch.from_numpy(
                    hval.astype(np.int32)).to(device)
                dst0, cnt, ys_sel, c_y = (a[on_dev] for a in (dst0, cnt,
                                                             ys_sel, c_y))
            src0 = (store_off[c_y] + halo[c_y]
                    + (cum[ys_sel] - cum[starts[c_y]]))

        # threads take the costliest lanes first: long lanes start in the
        # first wave, and a warp's 32 lanes cost about the same
        cost = (ends - starts) * STATE_COST + arcs
        split = None
        if hub is not None:
            meta, cost, split = _preset_lanes(
                hub, meta, cost, bounds, offsets, outd, halo, store_off, W,
                node_base, device)
        count("plan.split_lists", 0 if hub is None else len(hub[0]))
        count("plan.split_segments", 0 if split is None else split.segments)
        count("plan.split_merged", 0 if split is None else split.merged)
        order = np.argsort(-cost, kind="stable").astype(np.int32)

    if src0 is not None:    # the cold plan's halo triples
        with span("plan.chain_depths"):
            D, d_first = chain_depths(refs, bounds, settings.max_ref_count)
            wf = dict(wf_dst0=dst0, wf_src0=src0, wf_nodes=ys_sel,
                      wf_cnt=cnt, wf_chunk=c_y,
                      wf_depth=D[np.clip(ys_sel - d_first, 0, max(
                          len(D) - 1, 0))].astype(np.int64))

    with span("plan.upload"):
        return LanePlan(
            spec=spec, device=torch.device(device),
            words=stream_words(data, device),
            meta=torch.from_numpy(meta).to(device), store=store,
            n=n, m=m, chunk_starts=bounds, halo_arcs=halo,
            store_off=store_off, cum_arcs=cum, outdegrees=outd,
            offsets=offsets, exp_arcs=seg, exp_nodes=ends - starts,
            expect=torch.from_numpy(np.stack([seg, ends - starts], axis=1)
                                    .astype(np.int32)).to(device),
            order=torch.from_numpy(order).to(device),
            data=np.asarray(data, dtype=np.uint8), settings=settings,
            node_base=node_base, arc_base=arc_base, cold=cold,
            resolved=not (cold and len(cnt) > 0), split=split, **wf)


def _preset_lanes(hub, meta, cost, bounds, offsets, outd, halo, store_off,
                  W: int, node_base: int, device):
    """The split lists' rows of the lane table: each head lane's preset
    fields, then one preset lane a checkpoint (``kdecode`` module
    docstring).  Returns (the lane table with the preset lanes after the
    chunks', the lanes' costs, the ``SplitPlan``)."""
    xs, hp = hub
    res, cpc, cps = hp["res_cnt"], hp["cp_cnt"], hp["cps"]
    heads = np.searchsorted(bounds, xs, side="right") - 1
    P0 = preset_col(W)
    cut = res > 0
    first = (np.cumsum(cpc) - cpc)[cut]
    meta[heads[cut], P0] = -res[cut]
    meta[heads[cut], P0 + 1] = cps[first, 0]
    cost[heads] -= res
    # per preset lane: its list, its run's first residual index, its end
    lst = np.repeat(np.arange(len(xs)), cpc)
    bit, val, cnt = cps[:, 0], cps[:, 1], cps[:, 2]
    k0 = np.cumsum(cnt) - cnt
    k0 -= np.repeat(k0[first], cpc[cut])
    more = np.zeros(len(cps), dtype=bool)
    more[:-1] = lst[1:] == lst[:-1]
    end = np.where(more, np.roll(bit, -1), offsets[xs[lst] + 1])
    h = heads[lst]
    pm = np.zeros((len(cps), meta.shape[1]), dtype=np.int64)
    pm[:, M_NODES] = 1
    pm[:, M_BIT] = bit
    pm[:, M_X] = xs[lst] + node_base
    pm[:, M_WCUR0] = halo[h] + k0
    pm[:, M_BASE] = store_off[h]
    pm[:, M_SEG] = halo[h] + k0 + cnt
    pm[:, M_WIN] = end - bit
    pm[:, M_WIN + W + 1] = more
    pm[:, P0] = cnt
    pm[:, P0 + 1] = val + node_base
    # lists with copies or intervals: merged after the decode
    mg = cut & (outd[xs] > res)
    d_m = outd[xs[mg]]
    base = np.zeros(len(d_m) + 1, dtype=np.int64)
    np.cumsum(d_m, out=base[1:])
    dev = torch.device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)
                                ).to(dev)
    split = SplitPlan(
        nodes=xs, heads=heads, res=res, seg_head=h, seg_wcur=pm[:, M_SEG],
        seg_head_t=up(h), seg_wcur_t=up(pm[:, M_SEG]).to(torch.int32),
        merge_row0=up(store_off[heads[mg]] + halo[heads[mg]]),
        merge_res=up(res[mg]), merge_base=up(base),
        merge_tile=up(np.searchsorted(base, np.arange(0, base[-1], 256),
                                      side="right") - 1).to(torch.int32),
        merge_rows=int(base[-1]))
    return (np.concatenate([meta, pm]), np.concatenate([cost, cnt]), split)
