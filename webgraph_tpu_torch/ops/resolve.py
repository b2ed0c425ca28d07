"""Cold-plan halo resolution: wavefront passes of the decode.

Counterpart of ``webgraph_tpu/ops/kdecode.py`` ``resolve_halos`` (``:2326``)
and ``_host_pred_values`` (``:2026``).

A cold plan starts with zeros where the halo lists go.  Outdegrees, and so
every copy block's structure, are known up front, so wrong halo values never
desync the stream: they only propagate wrong values.  A node whose reference
chain crosses k-1 chunk boundaries is right in the store after pass k
(``kplan.chain_depths``).  Pass k decodes every lane, then copies into the
halo rows exactly the lists whose depth is k; the pass count is the largest
depth (at most max_ref_count + 1).  Lists whose source lane the decode
flagged are decoded on the host instead (their store rows are garbage).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import native as _native
from ..core.graph import expand_ranges

from .kdecode import LanePlan, check_diag, decode_chunked


def pred_values(data, settings, offsets, outdegrees, node_base: int, ys,
                cnts) -> np.ndarray:
    """Host-decode the lists of predecessors ``ys`` (plan-local ids; native
    range decode from y - W*max_ref_count, the chain bound
    BVGraph.java:455), flattened per request: the first ``cnts[i]`` values
    of y_i's list.  ``offsets``/``outdegrees``: plan-local bit offsets and
    outdegrees; ``node_base``: global id of plan-local node 0."""
    ys = np.asarray(ys, dtype=np.int64)
    cnts = np.asarray(cnts, dtype=np.int64)
    uy, inv = np.unique(ys, return_inverse=True)
    W = settings.window_size
    halo_n = W * max(int(settings.max_ref_count), 1) if W > 0 else 0
    p = np.maximum(uy - halo_n, 0)
    init = np.zeros((len(uy), max(W, 1)), dtype=np.int64)
    if W > 0:
        yj = p[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        ok = yj >= 0
        init[ok] = outdegrees[yj[ok]]
    d = outdegrees[uy]
    uo = np.zeros(len(uy) + 1, dtype=np.int64)
    np.cumsum(d, out=uo[1:])
    succ = np.empty(max(int(uo[-1]), 1), dtype=np.int64)
    dpad = np.concatenate([np.asarray(data, dtype=np.uint8),
                           np.zeros(16, dtype=np.uint8)])
    _native.bv_fill_ranges(dpad, settings, p + node_base, uy + node_base,
                           uy + 1 + node_base, offsets[p], init, uo[:-1], d,
                           succ, threads=os.cpu_count() or 1, padded=True)
    within = (np.arange(int(cnts.sum()), dtype=np.int64)
              - np.repeat(np.cumsum(cnts) - cnts, cnts))
    return succ[np.repeat(uo[inv], cnts) + within]


def _drop_lists(plan: LanePlan, keep: np.ndarray) -> None:
    for f in ("wf_dst0", "wf_src0", "wf_nodes", "wf_cnt", "wf_chunk",
              "wf_depth"):
        setattr(plan, f, getattr(plan, f)[keep])


def resolve_halos(plan: LanePlan) -> int:
    """Fill a cold plan's halo rows; returns the number of decode passes."""
    if not plan.cold or plan.resolved:
        return 0
    dev = plan.device
    store = plan.store
    max_d = int(plan.wf_depth.max(initial=1))
    passes = 0
    for k in range(1, max_d + 1):
        diag = decode_chunked(plan)
        passes += 1
        if k == 1:
            # errors are structural (stream-dependent, not halo-dependent):
            # one check finds every list whose source lane is garbage
            errs = check_diag(plan, diag)
            bad = errs[plan.wf_chunk] != 0
            if bad.any():
                vals = pred_values(plan.data, plan.settings, plan.offsets,
                                   plan.outdegrees, plan.node_base,
                                   plan.wf_nodes[bad], plan.wf_cnt[bad])
                dst = expand_ranges(plan.wf_dst0[bad], plan.wf_cnt[bad], dev)
                store[dst] = torch.from_numpy(vals.astype(np.int32)).to(dev)
                _drop_lists(plan, ~bad)
        sel = np.flatnonzero(plan.wf_depth == k)
        if len(sel):
            cnt = plan.wf_cnt[sel]
            dst = expand_ranges(plan.wf_dst0[sel], cnt, dev)
            src = expand_ranges(plan.wf_src0[sel], cnt, dev)
            store[dst] = store[src]
    plan.resolved = True
    return passes
