"""Ragged compaction: lane-segmented store -> flat CSR (kernel B2).

Counterpart of ``webgraph_tpu/ops/kcompact.py`` (``plan_compact`` ``:163``,
``_run_compact`` ``:113``, ``compact`` ``:322``).  A piecewise-shift copy:

    csr[p] = store[src0[r] + p - arc_start[r]]   for p in a valid run r

Invalid runs: ``compact`` leaves their positions unspecified (the kernel
does not write them; a 16-byte output vector that touches one writes only
its valid positions), and the caller splices them (``ops/csr.py`` fills the
arcs of flagged lanes on the host).  Every comparison of the kernel with
``compact_plain`` holds valid positions only.  The CUDA kernel is
``csrc/compact.cu``; ``compact_plain`` is its plain PyTorch twin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build

TILE = 8192   # output positions per tile: WG_B2_TILE of csrc/compact.cu


@dataclasses.dataclass
class CompactPlan:
    """Run table on the device plus the per-tile run bracket: tile b's
    positions [b tile, (b + 1) tile) lie in runs tile_run0[b] ..
    tile_run0[b + 1]."""

    arc_start: torch.Tensor   # int64[R+1], ascending, arc_start[R] = m
    src0: torch.Tensor        # int64[R]
    valid: torch.Tensor       # uint8[R]
    tile_run0: torch.Tensor   # int64[NB+1]
    m: int
    src_end: int              # max over runs of src0 + length
    tile: int = TILE          # output positions per tile

    @property
    def n_tiles(self) -> int:
        return self.tile_run0.shape[0] - 1


def plan_compact(arc_start, src0, valid, m: int, *, device,
                 tile: int = TILE) -> CompactPlan:
    """``arc_start``: int64[R+1] CSR position of each run's first arc (last
    = m); ``src0``: int64[R] store position of each run's first arc;
    ``valid``: bool[R].  ``tile`` (a multiple of 4) sizes the bracket; the
    kernel takes ``TILE`` only."""
    arc_start = np.asarray(arc_start, dtype=np.int64)
    R = len(arc_start) - 1
    if R < 1 or arc_start[0] != 0 or arc_start[-1] != m:
        raise ValueError("runs must tile [0, m)")
    if (np.diff(arc_start) < 0).any():
        raise ValueError("arc_start must be ascending")
    src0 = np.asarray(src0, dtype=np.int64)
    if len(src0) != R or (src0 < 0).any():
        raise ValueError("src0 must hold R store positions >= 0")
    if tile <= 0 or tile % 4:
        raise ValueError("tile must be a positive multiple of 4")
    nb = -(-m // tile)
    t = np.minimum(np.arange(nb + 1, dtype=np.int64) * tile, max(m - 1, 0))
    run0 = np.clip(np.searchsorted(arc_start[:-1], t, side="right") - 1,
                   0, R - 1)
    run0[-1] = R - 1
    return CompactPlan(
        arc_start=torch.from_numpy(arc_start).to(device),
        src0=torch.from_numpy(src0).to(device),
        valid=torch.from_numpy(np.asarray(valid, dtype=np.uint8)).to(device),
        tile_run0=torch.from_numpy(run0).to(device), m=int(m),
        src_end=int((src0 + np.diff(arc_start)).max()), tile=int(tile))


def compact(cp: CompactPlan, store: torch.Tensor) -> torch.Tensor:
    """int32[m] CSR from the store.  CUDA tensors launch ``compact_runs``;
    CPU tensors run :func:`compact_plain`."""
    dev = store.device
    if store.dtype != torch.int32 or store.dim() != 1 \
            or not store.is_contiguous():
        raise ValueError("store must be a contiguous 1-d int32 tensor")
    for name, dtype in (("arc_start", torch.int64), ("src0", torch.int64),
                        ("valid", torch.uint8), ("tile_run0", torch.int64)):
        t = getattr(cp, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
    if cp.valid.shape != cp.src0.shape:
        raise ValueError("valid must hold one flag per run")
    if cp.src_end > store.numel():
        raise ValueError("a run reads past the end of the store")
    if dev.type == "cpu":
        return compact_plain(cp, store)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cp.tile != TILE:
        raise ValueError(f"the kernel takes tiles of {TILE}, the plan has "
                         f"{cp.tile}")
    csr = torch.empty(cp.m, dtype=torch.int32, device=dev)
    rc = _build.lib().wg_compact_runs(
        store.data_ptr(), store.numel(), csr.data_ptr(), cp.m,
        cp.arc_start.data_ptr(), cp.src0.data_ptr(), cp.valid.data_ptr(),
        cp.tile_run0.data_ptr(), cp.n_tiles, cp.tile,
        _build.stream_ptr(store))
    _build.check(rc, "compact_runs")
    _build.LAUNCHES["compact_runs"] += 1
    return csr


def compact_plain(cp: CompactPlan, store: torch.Tensor) -> torch.Tensor:
    """The plain twin: a repeat_interleave gather over the valid runs."""
    dev = store.device
    csr = torch.empty(cp.m, dtype=torch.int32, device=dev)
    lens = cp.arc_start[1:] - cp.arc_start[:-1]
    R = lens.shape[0]
    run = torch.repeat_interleave(torch.arange(R, device=dev), lens,
                                  output_size=cp.m)
    p = torch.arange(cp.m, device=dev)
    ok = cp.valid[run].bool()
    src = cp.src0[run] + p - cp.arc_start[run]
    csr[ok] = store[src[ok]]
    return csr
