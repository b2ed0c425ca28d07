"""Port of ``experiments/pallas_probe5.py``: the primitives the decode
kernel is built from.

Six bodies on one ``(8, 128)`` tile (the probe's ``simple`` kernels):
``clz``; ``varshift`` (``(x << s) | (x >> (s + 1))`` on uint32);
``while_max`` (``acc += x`` while the tile's largest ``acc`` is below
1000, then ``acc + steps``: a tile-wide vote each step);
``dyngather_u32`` (``x[idx, col]`` within the tile); ``scratch_dyn``
(16 scratch tiles written and read at a loop index, in shared memory); and
``u32_cmp_mix`` (uint32 compares and an int32 select).  Then
``dma_dynoffset``: each of ``steps`` steps copies the rows
``[off, off + 4)``, ``off = (7 i) % (T - 4)``, of a ``(T, 8, 128)`` array in
device memory into shared memory with one bulk async copy (the Tensor
Memory Accelerator, completing on an mbarrier), and adds rows 0 and 3.

uint32 values travel as int32 tensors of the same bits.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe5``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _build
from . import common as C
from .common import (M32, TILE, Case, i64, launch, on_cpu, out32, ptr, s32,
                     shl, shr)

SIMPLE = "probe5.simple"
DMA = "probe5.t_dma_dynoffset"
# variant ids of wg_probe_prims (csrc/probe_prims.cu)
CLZ, VARSHIFT, WHILE_MAX, DYNGATHER, SCRATCH_DYN, U32_CMP_MIX, V_DMA = range(7)
DMA_STEPS = 8
DMA_ROWS = 4


def _simple(variant: int, plain, a: torch.Tensor,
            b: torch.Tensor | None = None) -> torch.Tensor:
    """Check the (8, 128) tiles, then run ``plain`` on the CPU or launch the
    kernel ``variant``."""
    _build.check_tensor(a, "a", TILE)
    if b is not None:
        _build.check_tensor(b, "b", TILE, device=a.device)
    if on_cpu(a):
        return plain(a) if b is None else plain(a, b)
    out = torch.empty_like(a)
    launch(SIMPLE, "wg_probe_prims", variant, ptr(a), ptr(b), ptr(out), 8, 0,
           like=a)
    return out


def clz(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each int32 lane (32 for 0)."""
    return _simple(CLZ, clz_plain, x)


def clz_plain(x: torch.Tensor) -> torch.Tensor:
    v = i64(x) & M32
    _, e = torch.frexp(v.to(torch.float64))
    return torch.where(v == 0, 32, 32 - e.to(torch.int64)).to(torch.int32)


def varshift(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(x << s) | (x >> (s + 1))`` on uint32 lanes, s in 0..30."""
    return _simple(VARSHIFT, varshift_plain, x, s)


def varshift_plain(x, s):
    xv, sv = i64(x) & M32, i64(s) & M32
    return out32(shl(xv, sv) | shr(xv, sv + 1))


def while_max(x: torch.Tensor) -> torch.Tensor:
    """``acc = x``; ``acc += x`` while ``max(acc) < 1000`` over the tile;
    then ``acc + steps``."""
    return _simple(WHILE_MAX, while_max_plain, x)


def while_max_plain(x):
    xi = i64(x)
    acc, i = xi, 0
    while bool(acc.max() < 1000):
        acc = s32(acc + xi)
        i += 1
    return out32(acc + i)


def dyngather_u32(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx, col]`` within the tile; an index outside 0..7 gives 0."""
    return _simple(DYNGATHER, dyngather_u32_plain, x, idx)


def dyngather_u32_plain(x, idx):
    r = i64(idx)
    v = x[r.clamp(0, 7), torch.arange(128, device=x.device)]
    return torch.where((r >= 0) & (r < 8), v, 0).to(torch.int32)


def scratch_dyn(x: torch.Tensor) -> torch.Tensor:
    """``x + i`` stored into scratch tile ``i`` for i < 16, then the 16
    tiles summed."""
    return _simple(SCRATCH_DYN, scratch_dyn_plain, x)


def scratch_dyn_plain(x):
    xi = i64(x)
    scr = torch.stack([xi + i for i in range(16)])
    return out32(scr.sum(0))


def u32_cmp_mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a >> 3`` where ``a < b`` (uint32), else ``-(b & 7)``."""
    return _simple(U32_CMP_MIX, u32_cmp_mix_plain, a, b)


def u32_cmp_mix_plain(a, b):
    av, bv = i64(a) & M32, i64(b) & M32
    return out32(torch.where(av < bv, shr(av, 3), -(bv & 7)))


def dma_dynoffset(hbm: torch.Tensor, steps: int = DMA_STEPS) -> torch.Tensor:
    """Sum over ``steps`` steps of ``hbm[off] + hbm[off + 3]``,
    ``off = (7 i) % (T - 4)``, each slab brought in by one bulk copy."""
    _build.check_tensor(hbm, "hbm", (None, *TILE))
    T = hbm.shape[0]
    if T <= DMA_ROWS or steps < 0:
        raise ValueError(f"need more than {DMA_ROWS} rows and steps >= 0")
    if on_cpu(hbm):
        return dma_dynoffset_plain(hbm, steps)
    out = torch.empty(TILE, dtype=torch.int32, device=hbm.device)
    launch(DMA, "wg_probe_prims", V_DMA, ptr(hbm), None, ptr(out), T, steps,
           like=hbm)
    return out


def dma_dynoffset_plain(hbm, steps: int = DMA_STEPS):
    h = i64(hbm)
    acc = torch.zeros(TILE, dtype=torch.int64, device=hbm.device)
    for i in range(steps):
        off = (i * 7) % (hbm.shape[0] - DMA_ROWS)
        acc = s32(acc + h[off] + h[off + 3])
    return out32(acc)


def inputs(rng: np.random.Generator, device) -> dict:
    """The probe's inputs, drawn in its order (uint32 values as int32)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(device)
    return dict(
        clz=(t(rng.integers(1, 1 << 30, TILE).astype(np.int32)),),
        varshift=(t(rng.integers(0, 1 << 16, TILE).astype(np.uint32)),
                  t(rng.integers(0, 15, TILE).astype(np.uint32))),
        while_max=(t(rng.integers(1, 100, TILE).astype(np.int32)),),
        dyngather_u32=(t(rng.integers(0, 1 << 31, TILE).astype(np.uint32)),
                       t(rng.integers(0, 8, TILE).astype(np.int32))),
        scratch_dyn=(t(rng.integers(0, 100, TILE).astype(np.int32)),),
        dma_dynoffset=(t(rng.integers(0, 100, (64, *TILE)).astype(np.int32)),),
        u32_cmp_mix=(t(rng.integers(0, 1 << 31, TILE).astype(np.uint32)),
                     t(rng.integers(0, 1 << 31, TILE).astype(np.uint32))))


NAMES = {
    "clz": "clz int32", "varshift": "variable shifts uint32",
    "while_max": "while_loop vector state",
    "dyngather_u32": "dynamic_gather uint32 (8,128)",
    "scratch_dyn": "VMEM scratch dynamic-index tiles",
    "dma_dynoffset": "DMA HBM->VMEM dynamic offset in loop",
    "u32_cmp_mix": "uint32 compares / where mix"}


def cases(device, rng: np.random.Generator) -> list[Case]:
    mod = sys.modules[__name__]
    out = []
    for key, args in inputs(rng, device).items():
        site = DMA if key == "dma_dynoffset" else SIMPLE
        out.append(Case(site, NAMES[key], getattr(mod, key),
                        getattr(mod, key + "_plain"), args,
                        steps=DMA_STEPS if site == DMA else None))
    # the copy's round trip, over enough steps to see past the launch
    out.append(Case(DMA, "DMA HBM->VMEM dynamic offset, 4096 steps",
                    dma_dynoffset, dma_dynoffset_plain,
                    next(c for c in out if c.site == DMA).args, steps=4096,
                    check_steps=256))
    return out


if __name__ == "__main__":
    sys.exit(C.main(cases))
