"""Port of ``experiments/pallas_probe14.py``: the column read in place or
staged through scratch, with a data- or step-dependent ``avail``.

Probe 12's ``p2`` body over one ``(8, 128)`` tile, ``STEPS`` steps, its
column read from the input or from a scratch copy made at the start, and
``avail`` lowered by the shift amount or by ``4 + step % 3``.  The scratch
(``(R, 8, 128)``, 256 KB a tile) lives in device memory.  The result is
``b0``.  Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe14``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe14.run"
R, STEPS = 64, 200
V = 1  # no output column

q8, q8_plain = lanes.pair(SITE, "p14_q8", V, STEPS)
q6, q6_plain = lanes.pair(SITE, "p14_q6", V, STEPS)
q9, q9_plain = lanes.pair(SITE, "p14_q9", V, STEPS)
q10, q10_plain = lanes.pair(SITE, "p14_q10", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (q8, q8_plain, "q8  scratch copy + data-dep avail"),
    (q6, q6_plain, "q6  input + step-dep avail"),
    (q9, q9_plain, "q9  scratch copy + step-dep avail"),
    (q10, q10_plain, "q10 input + data-dep avail (control=FAIL)"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
