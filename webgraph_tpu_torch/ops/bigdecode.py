"""Sliced device decode: a BVGraph decoded in arc-bounded node slices.

Counterpart of ``webgraph_tpu/ops/bigdecode.py`` (``decode_big_slices``,
``:31-95``).  It walks the graph in slices of about ``slice_arcs``
arcs, rebases each slice's bit stream to a byte boundary (so in-slice bit
offsets stay small), decodes the slice's range natively -- one
arc-balanced piece per host thread (``native.bv_fill_ranges``) -- for the
planner's halo lists, plans a warm decode of the slice against it
(``plan_kernel_decode`` with ``node_base`` = the slice's first halo node:
successor values are global node ids, which fit int32 for n < 2^31) and
runs ``decode_to_csr`` -- the kernels B1 and B2 on a CUDA device, their
plain versions on the CPU -- yielding each slice's CSR on the device.  One
slice is resident at a time besides what the caller keeps.

Reference chains never cross a slice's halo floor (W * maxRefCount nodes,
BVGraph.java:455/:2258), so each slice plans against a native decode that
itself warms up from one extra halo below, and each of that decode's
pieces from one halo below it -- the same chain-bound argument as the
range decoder (wgnative.cpp wg_bv_decode_range).

Graphs with n >= 2^31 NODES decode through the native streaming path
(``BVGraph.iter_csr_slices``) instead: successor values no longer fit the
kernel's int32 store (BVGraphSlowTest.java:30-97 regime).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from .csr import decode_to_csr
from .kplan import plan_kernel_decode

__all__ = ["decode_big_slices"]


def _halo_decode(data_slice, settings, offsets, bitbase: int, outd, cum,
                 p2: int, lo_p: int, hi: int):
    """Native decode of nodes [lo_p, hi) of a slice whose bytes start at
    node ``p2``'s offset: (csr_off int64[hi-lo_p+1], succ int64).

    The outdegrees give the offsets, so the range is cut into one
    arc-balanced piece per host thread and the pieces decode at once
    (``native.bv_fill_ranges``), each warming up from the halo_n nodes
    below it -- the chain bound the sequential range decode rests on
    (BVGraph.java:455) -- or from ``p2``, where the slice's bytes begin."""
    W = settings.window_size
    halo_n = W * max(settings.max_ref_count, 1) if W else 0
    co = cum[lo_p:hi + 1] - cum[lo_p]
    k = max(1, min(os.cpu_count() or 1, hi - lo_p))
    cuts = np.searchsorted(co, (int(co[-1]) * np.arange(1, k)) // k) + lo_p
    x0 = np.unique(np.concatenate([[lo_p], np.clip(cuts, lo_p, hi - 1)]))
    x1 = np.concatenate([x0[1:], [hi]])
    p = np.maximum(x0 - halo_n, p2)
    init = np.zeros((len(p), max(W, 1)), dtype=np.int64)
    if W:
        yj = p[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        ok = yj >= 0
        init[ok] = outd[yj[ok]]
    start = np.asarray(offsets[p], dtype=np.int64) - bitbase
    arcs = co[x1 - lo_p] - co[x0 - lo_p]
    succ = np.empty(max(int(co[-1]), 1), dtype=np.int64)
    _native.bv_fill_ranges(data_slice, settings, p, x0, x1, start, init,
                           co[x0 - lo_p], arcs, succ, threads=len(p))
    return co, succ[:int(co[-1])]


def decode_big_slices(offsets, outdegrees, settings, data,
                      slice_arcs: int = 1 << 27, device=None,
                      target_arcs_per_lane: int = 128,
                      report: Optional[list] = None) -> Iterator[
                          Tuple[int, int, torch.Tensor, torch.Tensor]]:
    """Yield (lo, hi, csr_off_local int64[hi-lo+1], succ int32) per
    arc-balanced node slice [lo, hi), both tensors on ``device`` (the GPU
    when None, the CPU only when the caller names it).

    ``offsets``: int64 bit offsets (n+1) or an ``EliasFanoMonotoneList``;
    ``data``: the whole ``.graph`` stream (array or memmap).  Total arcs
    may exceed 2^31; the node count must stay below 2^31 (see the module
    doc).  ``report``: a list to which one dict per slice is appended --
    its route ("kernel", or "native" outside the kernel's envelope, where
    the native decode is the slice), its halo decode, plan and
    decode seconds (host clock; the decode ends in a synchronise) and its
    arcs decoded on the host."""
    from ..device import require_cuda

    n = len(outdegrees)
    if n >= (1 << 31):
        raise ValueError("n >= 2^31: use BVGraph.iter_csr_slices (native "
                         "streaming) -- successor values exceed int32 lanes")
    dev = require_cuda() if device is None else torch.device(device)
    outd = np.asarray(outdegrees, dtype=np.int64)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    W = settings.window_size
    halo_n = W * max(settings.max_ref_count, 1) if W else 0

    lo = 0
    while lo < n:
        hi = int(np.searchsorted(cum, cum[lo] + slice_arcs, side="left"))
        hi = max(min(hi, n), lo + 1)
        lo_p = max(lo - halo_n, 0)
        p2 = max(lo_p - halo_n, 0)
        t0 = time.perf_counter()
        bit_lo = int(offsets[p2])
        byte0 = bit_lo >> 3
        bitbase = byte0 * 8
        byte1 = (int(offsets[hi]) + 7) >> 3
        data_slice = np.ascontiguousarray(
            np.asarray(data[byte0:byte1 + 8], dtype=np.uint8))
        offs_loc = np.asarray(offsets[lo_p:hi + 1], dtype=np.int64) - bitbase
        outd_loc = outd[lo_p:hi]

        # native halo decode of [lo_p, hi): the planner's halo lists (and,
        # outside the kernel's envelope, the slice itself)
        co_halo, su_halo = _halo_decode(data_slice, settings, offsets,
                                        bitbase, outd, cum, p2, lo_p, hi)
        t1 = time.perf_counter()

        plan = plan_kernel_decode(
            offs_loc, outd_loc, settings, data_slice, device=dev,
            halo_csr=(co_halo, su_halo),
            target_arcs_per_lane=target_arcs_per_lane,
            node_base=lo_p, first_node=lo - lo_p)
        t2 = time.perf_counter()
        if plan is None:
            # outside the kernel envelope: the native decode IS the slice
            a = int(co_halo[lo - lo_p])
            co = torch.from_numpy(co_halo[lo - lo_p:] - a).to(dev)
            succ = torch.from_numpy(su_halo[a:].astype(np.int32)).to(dev)
            route, filled = "native", 0
        else:
            co_h, succ, filled = decode_to_csr(plan)
            co = torch.from_numpy(co_h).to(dev)
            del plan
            route = "kernel"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if report is not None:
            report.append(dict(lo=lo, hi=hi, arcs=int(cum[hi] - cum[lo]),
                               route=route, halo_decode_s=t1 - t0,
                               plan_s=t2 - t1,
                               decode_s=time.perf_counter() - t2,
                               fallback_arcs=filled))
        yield lo, hi, co, succ
        lo = hi
