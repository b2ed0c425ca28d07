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

from webgraph_tpu import native as _native

from .kdecode import LanePlan, check_diag, decode_chunked


def _expand(first, cnt, device):
    """repeat(first, cnt) + offsets within each run, on ``device``."""
    first = torch.as_tensor(first, dtype=torch.int64, device=device)
    cnt = torch.as_tensor(cnt, dtype=torch.int64, device=device)
    total = int(cnt.sum()) if len(cnt) else 0
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    starts = torch.cumsum(cnt, 0) - cnt
    within = (torch.arange(total, device=device)
              - torch.repeat_interleave(starts, cnt, output_size=total))
    return torch.repeat_interleave(first, cnt, output_size=total) + within


def host_pred_values(plan: LanePlan, ys, cnts) -> np.ndarray:
    """Host-decode the lists of predecessors ``ys`` (native range decode
    from y - W*max_ref_count, the chain bound BVGraph.java:455), flattened
    per request."""
    settings = plan.settings
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
        init[ok] = plan.outdegrees[yj[ok]]
    d = plan.outdegrees[uy]
    uo = np.zeros(len(uy) + 1, dtype=np.int64)
    np.cumsum(d, out=uo[1:])
    succ = np.empty(max(int(uo[-1]), 1), dtype=np.int64)
    dpad = np.concatenate([plan.data, np.zeros(16, dtype=np.uint8)])
    _native.bv_fill_ranges(dpad, settings, p + plan.node_base,
                           uy + plan.node_base, uy + 1 + plan.node_base,
                           plan.offsets[p], init, uo[:-1], d, succ,
                           threads=os.cpu_count() or 1, padded=True)
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
                vals = host_pred_values(plan, plan.wf_nodes[bad],
                                        plan.wf_cnt[bad])
                dst = _expand(plan.wf_dst0[bad], plan.wf_cnt[bad], dev)
                store[dst] = torch.from_numpy(vals.astype(np.int32)).to(dev)
                _drop_lists(plan, ~bad)
        sel = np.flatnonzero(plan.wf_depth == k)
        if len(sel):
            cnt = plan.wf_cnt[sel]
            dst = _expand(plan.wf_dst0[sel], cnt, dev)
            src = _expand(plan.wf_src0[sel], cnt, dev)
            store[dst] = store[src]
    plan.resolved = True
    return passes
