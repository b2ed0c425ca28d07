"""Port of ``experiments/pallas_probe15.py``: which data dependence of the
load index the loop carries.

Four bodies over one ``(8, 128)`` tile, ``STEPS`` steps, the column staged
in a scratch copy (device memory): a self-advancing index (``r1``), a
data-dependent choice of the index (``r2``), a data-dependent advance
(``r3``), and ``r1`` writing the scratch each step (``r4``).  The result is
``acc``.  Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe15``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe15.run"
R, STEPS = 64, 200
V = 1  # no output column

r1, r1_plain = lanes.pair(SITE, "p15_r1", V, STEPS)
r2, r2_plain = lanes.pair(SITE, "p15_r2", V, STEPS)
r3, r3_plain = lanes.pair(SITE, "p15_r3", V, STEPS)
r4, r4_plain = lanes.pair(SITE, "p15_r4", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (r1, r1_plain, "r1"),
    (r2, r2_plain, "r2"),
    (r3, r3_plain, "r3"),
    (r4, r4_plain, "r4"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS, high=1 << 20)


if __name__ == "__main__":
    sys.exit(C.main(cases))
