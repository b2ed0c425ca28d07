"""Port of ``experiments/pallas_probe7.py``: while loops that write and read
the lane's output column.

Six bodies over one ``(8, 128)`` tile and a ``(V, 8, 128)`` output column,
``STEPS`` steps (``while`` forms: while any lane's ``acc < 10**9``): a write
to a fixed row; a write at row ``acc % V`` (in a while and in a fori loop); a
column load at row ``acc % R``; a read and write back at ``acc % V``; and
uint32 variable shifts.  Kernels in ``csrc/probe_lane.cu``, plain twins in
``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe7``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe7.run"
R, V, STEPS = 64, 640, 200

while_refwrite, while_refwrite_plain = lanes.pair(
    SITE, "p7_refwrite", V, STEPS)
while_maskedwrite, while_maskedwrite_plain = lanes.pair(
    SITE, "p7_maskedwrite", V, STEPS)
fori_maskedwrite, fori_maskedwrite_plain = lanes.pair(
    SITE, "p7_fori_maskedwrite", V, STEPS)
while_maskedsum_col, while_maskedsum_col_plain = lanes.pair(
    SITE, "p7_maskedsum_col", V, STEPS)
while_maskedread_out, while_maskedread_out_plain = lanes.pair(
    SITE, "p7_maskedread_out", V, STEPS)
uintshift_while, uintshift_while_plain = lanes.pair(
    SITE, "p7_uintshift", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (while_refwrite, while_refwrite_plain, "while + static ref write"),
    (while_maskedwrite, while_maskedwrite_plain, "while + masked RMW write"),
    (fori_maskedwrite, fori_maskedwrite_plain, "fori  + masked RMW write"),
    (while_maskedsum_col, while_maskedsum_col_plain,
     "while + masked-sum col load"),
    (while_maskedread_out, while_maskedread_out_plain,
     "while + masked read+write out"),
    (uintshift_while, uintshift_while_plain, "while + uint32 var shifts"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
