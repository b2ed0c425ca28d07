"""Port of ``experiments/pallas_probe17.py``: output-store strategies for
the decode kernel's flush.

``make(x, variant)`` runs ``STEPS`` steps over one ``(8, 128)`` tile of the
stage-register discipline of the decode (16 stage words a lane, two written
a step) plus one flush strategy into the lane's output column of ``V8``
groups of 8 words (``out_buf``, ``(V8, 8, 8, 128)``) or a time-major
buffer (``tm_buf``, ``(F8, 8, 8, 128)``); both start zero-filled.  The
variants (``VARIANTS``) and their meaning are listed in
``csrc/probe_flush.cu``.  The result is
``acc + wcur + out_buf[0, 0] + tm_buf[0, 0]``.  Both buffers (2 MB and
2.6 MB a tile) live in device memory.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe17``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _build
from . import common as C
from .common import TILE, Case, i64, launch, on_cpu, out32, ptr, s32

SITE = "probe17.make"
STEPS = 4096
V8 = 64          # output groups per lane
F8 = 80          # time-major slabs
CHECK_STEPS = 1024  # past the wrap of gb (256 steps) and of the slabs (320)
# index = variant id of wg_probe_flush (csrc/probe_flush.cu)
VARIANTS = ("none", "rmw", "mstore", "rmw3", "window8", "tmajor", "read64")


def make(x: torch.Tensor, variant: str, steps: int = STEPS) -> torch.Tensor:
    _build.check_tensor(x, "x", TILE)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if on_cpu(x):
        return make_plain(x, variant, steps)
    out = torch.empty_like(x)
    out_buf = torch.zeros((V8, 8, *TILE), dtype=torch.int32, device=x.device)
    tm_buf = torch.zeros((F8, 8, *TILE), dtype=torch.int32, device=x.device)
    launch(SITE, "wg_probe_flush", VARIANTS.index(variant), ptr(x), ptr(out),
           ptr(out_buf), ptr(tm_buf), steps, V8, F8, like=x)
    return out


def make_plain(x: torch.Tensor, variant: str, steps: int = STEPS
               ) -> torch.Tensor:
    dev = x.device
    n = x.numel()
    lane = torch.arange(n, device=dev)
    out_buf = torch.zeros((V8, 8, n), dtype=torch.int64, device=dev)
    tm_buf = torch.zeros((F8, 8, n), dtype=torch.int64, device=dev)
    stw = torch.zeros((16, n), dtype=torch.int64, device=dev)
    wcur = i64(x).reshape(-1) & 7
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    j8 = torch.arange(8, device=dev)[:, None]

    def bank(gb):
        # the stage bank of group gb: words 0..7 or 8..15, (8, n)
        return torch.where((gb & 1) == 0, stw[:8], stw[8:])

    def place(g, vals):
        # group g of each lane (where 0 <= g < V8) takes the (8, n) vals
        ok = (g >= 0) & (g < V8)
        out_buf[g[ok], :, lane[ok]] = vals[:, ok].T

    for step in range(steps):
        for u in range(2):
            wt = wcur + u
            slot = ((wt >> 3) & 1) * 8 + (wt & 7)
            stw[slot, lane] = wt * 3
        wcur = wcur + 2
        flush_now = (step & 3) == 3
        gb = torch.remainder(torch.clamp((wcur >> 3) - 1, min=0), V8)
        if variant in ("rmw", "mstore") and flush_now:
            place(gb, bank(gb))
        elif variant == "rmw3" and (step & 11) == 11:
            place(gb, stw[:8])
            place(gb - 1, stw[8:])
            place(gb - 2, stw[(torch.arange(8, device=dev) + 1) & 7])
        elif variant == "window8" and flush_now:
            lo = min(max(int(gb.max()) - 7, 0), V8 - 8)
            place(torch.where((gb - lo >= 0) & (gb - lo < 8), gb, -1),
                  bank(gb))
        elif variant == "tmajor" and flush_now:
            tm_buf[(step >> 2) % F8] = bank(gb)
        elif variant == "read64":
            gsel = torch.remainder(wcur * 7, V8)
            acc = s32(acc + out_buf[gsel, j8, lane].sum(0))
    res = s32(acc + wcur + out_buf[0, 0] + tm_buf[0, 0])
    return out32(res).reshape(x.shape)


def cases(device, rng: np.random.Generator) -> list[Case]:
    x = torch.zeros(TILE, dtype=torch.int32, device=device)
    return [Case(SITE, f"{v:9s}", make, make_plain, (x,), steps=STEPS,
                 check_steps=CHECK_STEPS, kw=dict(variant=v), reps=3)
            for v in VARIANTS]


if __name__ == "__main__":
    sys.exit(C.main(cases))
