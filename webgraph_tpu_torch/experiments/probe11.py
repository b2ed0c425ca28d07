"""Port of ``experiments/pallas_probe11.py``: seven forms of a variable
shift after a column load.

Each step loads the lane's column word at ``rp`` and updates two uint32
carries with one shift form; ``STEPS`` steps over one ``(8, 128)`` tile
while any lane's ``b0`` is below ``0xffffffff``; the result is ``b0``.
Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe11``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe11.run"
R, STEPS = 64, 200
V = 1  # no output column

v3_no_varshift, v3_no_varshift_plain = lanes.pair(SITE, "p11_v3", V, STEPS)
v4_varshift_const_amount, v4_varshift_const_amount_plain = lanes.pair(
    SITE, "p11_v4", V, STEPS)
v1_shift_by_loaded, v1_shift_by_loaded_plain = lanes.pair(
    SITE, "p11_v1", V, STEPS)
v2_shift_by_carry_mixed, v2_shift_by_carry_mixed_plain = lanes.pair(
    SITE, "p11_v2", V, STEPS)
v5_varshift_int32, v5_varshift_int32_plain = lanes.pair(
    SITE, "p11_v5", V, STEPS)
v6_unrolled_select_shift, v6_unrolled_select_shift_plain = lanes.pair(
    SITE, "p11_v6", V, STEPS)
(v7_shift_of_unloaded_by_loaded,
 v7_shift_of_unloaded_by_loaded_plain) = lanes.pair(
    SITE, "p11_v7", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (v3_no_varshift, v3_no_varshift_plain, "v3 no varshift (control)"),
    (v4_varshift_const_amount, v4_varshift_const_amount_plain,
     "v4 const-amount shift of loaded"),
    (v1_shift_by_loaded, v1_shift_by_loaded_plain,
     "v1 shift by loaded amount"),
    (v2_shift_by_carry_mixed, v2_shift_by_carry_mixed_plain,
     "v2 shift by carry|loaded amount"),
    (v5_varshift_int32, v5_varshift_int32_plain, "v5 int32 lax.shift_left"),
    (v6_unrolled_select_shift, v6_unrolled_select_shift_plain,
     "v6 unrolled select shift"),
    (v7_shift_of_unloaded_by_loaded, v7_shift_of_unloaded_by_loaded_plain,
     "v7 shift unloaded val by loaded amount"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
