"""Port of ``experiments/pallas_probe6.py``: the decode kernel's lane
machine, end to end.

``build(col, steps)`` runs, over one ``(8, 128)`` tile for at most
``steps`` steps (while any lane's ``acc >= 0``), the whole primitive set
of the decode: a refill of lanes with ``avail <= 64`` from their column of
``col`` (``(R, 8, 128)``), the pair of variable shifts, a copy-head read
from the lane's ``(V, 8, 128)`` output column at
``(acc + step) % max(wcur, 1)`` (a row at or past ``V`` reads 0), and a
write at ``wcur % V``.  It returns the output column and the
``(2, 8, 128)`` diag (acc, wcur).  It is probe 9's body with every piece
on (``lanes.py`` ``p9_all``); kernel in ``csrc/probe_lane.cu``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe6``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import common as C
from . import lanes
from .common import Case

SITE = "probe6.build"
R, V = 64, 640
STEPS = (100, 1100)


def build(col: torch.Tensor, steps: int, V: int = V):
    return lanes.run(SITE, "p9_all", col, steps, V)


def build_plain(col: torch.Tensor, steps: int, V: int = V):
    return lanes.run_plain("p9_all", col, steps, V)


def cases(device, rng: np.random.Generator) -> list[Case]:
    col = lanes.column(rng, device, R)
    return [Case(SITE, f"steps={s}", build, build_plain, (col,), steps=s)
            for s in STEPS]


if __name__ == "__main__":
    sys.exit(C.main(cases))
