"""Port of ``experiments/pallas_probe10.py``: five forms of the refill's
column load.

The refill and shift pair over one ``(8, 128)`` tile, ``STEPS`` steps, with
the column word loaded as one indexed load (``sum``), behind an
optimisation barrier on the word (``barrier``) or on the shift amount
(``barrier_k``), as a loop over all ``R`` rows (``fori``), and as a max
over rows (``max``).  ``acc`` lands in row 0 of a ``(V, 8, 128)`` output.
Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe10``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe10.build"
R, V, STEPS = 64, 640, 200

load_sum, load_sum_plain = lanes.pair(SITE, "p10_sum", V, STEPS)
load_barrier, load_barrier_plain = lanes.pair(SITE, "p10_barrier", V, STEPS)
load_barrier_k, load_barrier_k_plain = lanes.pair(
    SITE, "p10_barrier_k", V, STEPS)
load_fori, load_fori_plain = lanes.pair(SITE, "p10_fori", V, STEPS)
load_max, load_max_plain = lanes.pair(SITE, "p10_max", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (load_sum, load_sum_plain, "sum"),
    (load_barrier, load_barrier_plain, "barrier"),
    (load_barrier_k, load_barrier_k_plain, "barrier_k"),
    (load_fori, load_fori_plain, "fori"),
    (load_max, load_max_plain, "max"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
