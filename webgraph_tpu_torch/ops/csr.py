"""Decode -> compact -> splice: the device-resident CSR.

Counterpart of ``webgraph_tpu/ops/kdecode.py`` ``plan_csr_index``
(``:2885``), ``decode_to_csr`` (``:2986``), ``fill_csr_device`` (``:3091``)
and ``fill_lanes`` (``:2584``).  The product is what analytics consume: host
int64 offsets and a device int32 successor array.

Lanes the decode flags (``check_diag`` != 0: a corrupt stream, never a size
cap) are compacted as invalid runs and their arcs are decoded on the host by
the native range decoder, then spliced in.  ``decode_to_csr`` reports how
many arcs took that path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import native as _native
from ..core.graph import expand_ranges
from ..utils.trace import count, recording, span

from .kcompact import compact, plan_compact
from .kdecode import DIAG_STEPS, LanePlan, decode_chunked, lanes_flagged
from .resolve import resolve_halos


def plan_csr_index(plan: LanePlan) -> None:
    """One run per lane: its chunk arcs, which follow its halo rows; and
    the CSR offsets of the decoded nodes."""
    starts = plan.chunk_starts[:-1]
    arc_start = np.empty(plan.lanes + 1, dtype=np.int64)
    arc_start[:-1] = plan.cum_arcs[starts] - plan.arc_base
    arc_start[-1] = plan.m
    src0 = plan.store_off[:-1] + plan.halo_arcs
    plan.compact_plan = plan_compact(
        arc_start, src0, np.ones(plan.lanes, dtype=bool), plan.m,
        device=plan.device)
    first = int(plan.chunk_starts[0])
    plan.csr_off = plan.cum_arcs[first:] - plan.arc_base


def fill_lanes(plan: LanePlan, lanes_mask: np.ndarray):
    """Native host decode of the masked lanes.  Returns (CSR positions
    int64[k], values int64[k]).  Adjacent lanes merge into one range, so
    they share one halo warm-up."""
    settings = plan.settings
    W = settings.window_size
    halo_n = W * max(int(settings.max_ref_count), 1) if W > 0 else 0
    cum = plan.cum_arcs
    cs = plan.chunk_starts
    idx = np.flatnonzero(np.asarray(lanes_mask) & (cs[:-1] != cs[1:]))
    if not len(idx):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    brk = np.flatnonzero(idx[1:] != idx[:-1] + 1)
    s = cs[idx[np.concatenate([[0], brk + 1])]]
    e = cs[idx[np.concatenate([brk, [len(idx) - 1]])] + 1]
    p = np.maximum(s - halo_n, 0)
    init = np.zeros((len(s), max(W, 1)), dtype=np.int64)
    if W > 0:
        yj = p[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        ok = yj >= 0
        init[ok] = plan.outdegrees[yj[ok]]
    arcs = cum[e] - cum[s]
    dst = np.cumsum(arcs) - arcs
    vals = np.empty(max(int(arcs.sum()), 1), dtype=np.int64)
    dpad = np.concatenate([plan.data, np.zeros(16, dtype=np.uint8)])
    nb = plan.node_base   # node ids are global, stream and arcs local
    _native.bv_fill_ranges(dpad, settings, p + nb, s + nb, e + nb,
                           plan.offsets[p], init, dst, arcs, vals,
                           threads=os.cpu_count() or 1, padded=True)
    pos = expand_ranges(cum[s] - plan.arc_base, arcs, "cpu").numpy()
    return pos, vals[:len(pos)]


def fill_csr_device(plan: LanePlan, succ: torch.Tensor,
                    bad: np.ndarray) -> int:
    """Splice host-decoded values of the flagged lanes into the device CSR;
    returns the number of arcs filled."""
    pos, vals = fill_lanes(plan, bad)
    if len(pos):
        succ[torch.from_numpy(pos).to(succ.device)] = torch.from_numpy(
            vals.astype(np.int32)).to(succ.device)
    return len(pos)


def decode_to_csr(plan: LanePlan):
    """Decode every lane and flatten to CSR on the plan's device.

    Returns (csr_off int64[n-first+1] host, succ int32[m] device,
    fallback_arcs).  ``csr_off`` is the plan's own array, the same on
    every call: read it, do not write it.  Cold plans resolve their halos
    first.  Only a flagged lane brings the diagnostics to the host.

    The call is the span ``wg.decode_to_csr``, with children ``wg.resolve``
    (an unresolved cold plan), ``wg.csr.index`` (the first call),
    ``wg.b1`` (B1's launch), ``wg.csr.flags`` (the flag check and its
    sync), ``wg.b2`` (B2 and its output) and ``wg.csr.fill`` (flagged
    lanes only).

    Counter ``b1.lane_steps``: B1's longest lane, its ``DIAG_STEPS`` (the
    preset lanes' too), a call.  It comes to the host in the flag check's
    one read, and only while a profiler records, so an untraced call reads
    the flag alone."""
    with span("decode_to_csr"):
        if plan.cold and not plan.resolved:
            with span("resolve"):
                resolve_halos(plan)
        if plan.compact_plan is None:
            with span("csr.index"):
                plan_csr_index(plan)
        with span("b1"):
            diag = decode_chunked(plan)
        with span("csr.flags"):
            flagged = lanes_flagged(plan, diag)
            if recording():
                anyf, steps = torch.stack((flagged.any().to(diag.dtype),
                                           diag[:, DIAG_STEPS].amax())).tolist()
                count("b1.lane_steps", steps)
            else:
                anyf = bool(flagged.any())
            bad = flagged.cpu().numpy() if anyf else None
            cp = plan.compact_plan
            if bad is not None:
                cp.valid = (~flagged).to(torch.uint8)
        with span("b2"):
            succ = compact(cp, plan.store)
        filled = 0
        if bad is not None:
            with span("csr.fill"):
                filled = fill_csr_device(plan, succ, bad)
    return plan.csr_off, succ, filled
