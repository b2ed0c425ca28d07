"""Port of ``experiments/pallas_probe9.py``: the lane machine of probe 6
with each piece switched on or off.

Seven combinations of the refill, the shift pair, the copy-head read and
the write, ``STEPS`` steps over one ``(8, 128)`` tile; each returns the
``(V, 8, 128)`` output column and the ``(2, 8, 128)`` diag (acc, wcur).
Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe9``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe9.build"
R, V, STEPS = 64, 640, 200

all_pieces, all_pieces_plain = lanes.pair(SITE, "p9_all", V, STEPS)
no_refill, no_refill_plain = lanes.pair(SITE, "p9_no_refill", V, STEPS)
no_shift, no_shift_plain = lanes.pair(SITE, "p9_no_shift", V, STEPS)
no_read, no_read_plain = lanes.pair(SITE, "p9_no_read", V, STEPS)
no_write, no_write_plain = lanes.pair(SITE, "p9_no_write", V, STEPS)
refill_shift, refill_shift_plain = lanes.pair(
    SITE, "p9_refill_shift", V, STEPS)
read_write, read_write_plain = lanes.pair(SITE, "p9_read_write", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (all_pieces, all_pieces_plain, "all"),
    (no_refill, no_refill_plain, "no refill"),
    (no_shift, no_shift_plain, "no shift"),
    (no_read, no_read_plain, "no read"),
    (no_write, no_write_plain, "no write"),
    (refill_shift, refill_shift_plain, "refill+shift only"),
    (read_write, read_write_plain, "read+write only"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
