"""Multi-device decode: one process, a tuple of devices.

Counterpart of ``webgraph_tpu/parallel/sharded.py``.  The reference decodes
node ranges in parallel threads (splitNodeIterators, BVGraph.java:2406-2483);
here the ranges go to devices, and since every range carries the lists it
references across its boundary (the plan's halo lists), no device waits on
another:

- :func:`decode_sharded_kernel` shards the lanes of one resolved plan: each
  device gets a contiguous lane range, balanced by store rows, with its own
  copy of the stream, its lanes' table and its segment of the store; B1
  (``kdecode.decode_lanes``) is launched on every device before anything
  synchronises, and the segments come back into the plan's store.
- :func:`decode_sharded` decodes a whole stream: each device plans and
  decodes its own arc-balanced node range (a cold plan that starts at the
  range's first node, as ``multihost.plan_shard_decode`` builds), through
  B1 and B2, and the ranges are joined on the host.

A "mesh" here is a plain tuple of ``torch.device`` (:func:`make_mesh`),
repeats allowed: one process drives every device, so no process group is
needed.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from .. import native as _native
from ..device import require_cuda
from ..ops.kdecode import (DIAG_ROWS, M_BASE, _check_lane_table,
                           decode_lanes, lane_rows, merge_split)
from .multihost import shard_bounds

__all__ = ["make_mesh", "decode_sharded", "decode_sharded_kernel"]


def make_mesh(devices=None) -> Tuple[torch.device, ...]:
    """The devices to shard over: every CUDA device when None (raising
    when there is none), else ``devices`` (devices or their names, repeats
    allowed) with each CUDA device checked and given its index."""
    if devices is None:
        require_cuda()
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = require_cuda(torch.cuda.current_device()
                             if d.index is None else d.index)
        out.append(d)
    return tuple(out)


def _on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (kernels launch there)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def decode_sharded_kernel(plan, devices):
    """Decode a resolved ``LanePlan``'s lanes across ``devices``.

    The lanes split into contiguous shares balanced by store rows, one per
    device; a device gets a copy of the stream (one per distinct device),
    its lanes' table (with the preset lanes of the split lists it heads)
    with the segment bases rebased to its share, its segment of the store
    and the plan's lane order restricted to its lanes.  B1 runs once per
    non-empty share, every share launched before anything synchronises.
    The segments are copied back into ``plan.store``, the split lists that
    need it merged (``kdecode.merge_split``), and the diagnostics put in
    lane-table order on the plan's device.  Returns (``plan.store``,
    diagnostics), which ``kdecode.check_diag`` and ``kcompact.compact``
    take as after ``kdecode.decode_chunked``.  A cold plan must be resolved first
    (``resolve.resolve_halos``): ValueError otherwise."""
    if plan.cold and not plan.resolved:
        raise ValueError("an unresolved cold plan: run "
                         "resolve.resolve_halos(plan) first")
    devs = make_mesh(devices)
    so = plan.store_off
    lane_b = shard_bounds(so, len(devs))
    order = plan.order.cpu().numpy()
    W = plan.spec.window_size
    rows_all = plan.meta.shape[0]
    words = {}
    shares = []
    # every share's inputs, checked, before the first launch: the checks
    # synchronise
    for dev, a, b in zip(devs, lane_b[:-1].tolist(), lane_b[1:].tolist()):
        if a == b:
            continue
        if dev not in words:
            words[dev] = plan.words.to(dev)
        rows = lane_rows(plan, a, b)
        rows_t = torch.from_numpy(rows).to(plan.meta.device)
        meta = plan.meta[rows_t].to(dev, copy=True)
        meta[:, M_BASE] -= int(so[a])
        seg = plan.store[int(so[a]):int(so[b])].to(dev, copy=True)
        at = np.full(rows_all, -1, dtype=np.int64)
        at[rows] = np.arange(len(rows))
        mine = at[order]
        own = torch.from_numpy(mine[mine >= 0].astype(np.int32)).to(dev)
        _check_lane_table(meta, seg, W, own)
        shares.append((dev, a, b, rows_t, meta, seg, own))
    diags = []
    for dev, _a, _b, _r, meta, seg, own in shares:
        with _on_device(dev):
            diags.append(decode_lanes(words[dev], meta, seg, plan.spec, own))
    diag = torch.empty((rows_all, DIAG_ROWS), dtype=torch.int32,
                       device=plan.device)
    # a plan has lanes, and shard_bounds gives the last share whatever the
    # others leave: every lane is in one share
    for (_d, a, b, rows_t, _m, seg, _o), dg in zip(shares, diags):
        plan.store[int(so[a]):int(so[b])].copy_(seg)
        diag[rows_t.to(plan.device)] = dg.to(plan.device)
    if plan.split is not None:
        merge_split(plan.split, plan.store)
    return plan.store, diag


def decode_sharded(data, offsets, settings, devices,
                   bvgraph=None) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a BVGraph stream across ``devices``, one arc-balanced node
    range each: a cold plan over ``offsets[:hi+1]`` starting at the range's
    first node, then ``ops.csr.decode_to_csr`` (B1 and B2) on that device.
    Returns host (csr_offsets int64[n+1], successors int64[m]).

    ``settings`` is the stream's ``BVGraphSettings`` (window, reference
    chain bound ``max_ref_count``, codes): the JAX function's
    ``vdecode.ParseConfig`` belongs to its XLA decoders, which the port
    does not carry.  ``bvgraph`` is accepted for the JAX signature and not
    read.  Raises ValueError for codes outside the decode kernel's
    envelope."""
    from ..ops.csr import decode_to_csr
    from ..ops.kplan import plan_kernel_decode

    devs = make_mesh(devices)
    data = np.asarray(data, dtype=np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    outd = _native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    bounds = shard_bounds(cum, len(devs))
    succ = np.empty(int(cum[-1]), dtype=np.int64)
    for dev, lo, hi in zip(devs, bounds[:-1].tolist(), bounds[1:].tolist()):
        if lo == hi:
            continue
        with _on_device(dev):
            plan = plan_kernel_decode(offsets[:hi + 1], outd[:hi], settings,
                                      data, device=dev, first_node=lo)
            if plan is None:
                raise ValueError("codes outside the decode kernel's envelope;"
                                 " decode with native.bv_decode_all")
            _co, su, _filled = decode_to_csr(plan)
            succ[cum[lo]:cum[hi]] = su.cpu().numpy()
        del plan, su
    return cum, succ
