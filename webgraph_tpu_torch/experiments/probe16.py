"""Port of ``experiments/pallas_probe16.py``: the floor of a loop step
against the number of carries.

``make(x, nc, sweep_rows)`` runs ``STEPS`` steps over the lanes of ``x``
(``(8, 128)`` int32) with ``nc`` int32 carries, ``c[k] = x + k`` at the
start, each + 1 a step; with ``sweep_rows``, each step then adds
``buf[c[0] % sweep_rows] & 1`` to ``c[0]``, from a zero-filled scratch
``buf`` of ``sweep_rows`` tiles.  The result is ``c[0]``.  The kernel keeps
every carry live in a register each step, so a step costs what ``nc``
carries cost.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe16``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import common as C
from .common import Case, i64, out32, s32

SITE = "probe16.make"
STEPS = 8192
CARRIES = (4, 40, 64)
MAX_SWEEP = 48            # the sweep's scratch lives in shared memory


def make(x: torch.Tensor, nc: int, sweep_rows: int = 0, steps: int = STEPS
         ) -> torch.Tensor:
    if nc not in CARRIES:
        raise ValueError(f"the kernel is built for {CARRIES} carries")
    if not 0 <= sweep_rows <= MAX_SWEEP:
        raise ValueError(f"sweep_rows must lie in 0..{MAX_SWEEP}")
    if C.check_lanes(x, steps):
        return make_plain(x, nc, sweep_rows, steps)
    return C.loop(SITE, C.LOOP_CARRIES, x, steps, param=nc, sweep=sweep_rows)


def make_plain(x: torch.Tensor, nc: int, sweep_rows: int = 0,
               steps: int = STEPS) -> torch.Tensor:
    xi = i64(x).reshape(-1)
    c = xi[None] + torch.arange(nc, device=x.device)[:, None]
    buf = torch.zeros((max(sweep_rows, 1), xi.numel()), dtype=torch.int64,
                      device=x.device)
    lane = torch.arange(xi.numel(), device=x.device)
    for _ in range(steps):
        c = s32(c + 1)
        if sweep_rows:
            row = torch.remainder(c[0], sweep_rows)
            c[0] = s32(c[0] + (buf[row, lane] & 1))
    return out32(c[0]).reshape(x.shape)


def cases(device, rng: np.random.Generator) -> list[Case]:
    x = torch.ones((8, 128), dtype=torch.int32, device=device)
    return [Case(SITE, f"carries {nc:3d} sweep   0", make, make_plain, (x,),
                 steps=STEPS, kw=dict(nc=nc)) for nc in CARRIES]


if __name__ == "__main__":
    sys.exit(C.main(cases))
