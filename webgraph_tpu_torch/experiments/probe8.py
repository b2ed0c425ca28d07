"""Port of ``experiments/pallas_probe8.py``: vector modulo, scalar
broadcast, two outputs, mixed carries and a shift by ``32 - k``.

Five bodies over one ``(8, 128)`` tile for ``STEPS`` steps (while any lane's
condition holds); each writes its result to row 0 of a zero-filled
``(V, 8, 128)`` output, and ``two_outputs`` also to a ``(2, 8, 128)`` diag.
Kernels in ``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe8``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe8.run"
R, V, STEPS = 64, 640, 200

vec_mod_vec, vec_mod_vec_plain = lanes.pair(SITE, "p8_vec_mod_vec", V, STEPS)
scalar_bcast, scalar_bcast_plain = lanes.pair(
    SITE, "p8_scalar_bcast", V, STEPS)
two_outputs, two_outputs_plain = lanes.pair(SITE, "p8_two_outputs", V, STEPS)
mixed_carry_dtypes, mixed_carry_dtypes_plain = lanes.pair(
    SITE, "p8_mixed_carry", V, STEPS)
shift_by_32_minus, shift_by_32_minus_plain = lanes.pair(
    SITE, "p8_shift_by_32_minus", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (vec_mod_vec, vec_mod_vec_plain, "vector %% vector in while"),
    (scalar_bcast, scalar_bcast_plain, "scalar step broadcast into vec carry"),
    (two_outputs, two_outputs_plain, "two outputs (tuple out_shape)"),
    (mixed_carry_dtypes, mixed_carry_dtypes_plain,
     "mixed uint32/int32 carry + where"),
    (shift_by_32_minus, shift_by_32_minus_plain, "shift by (32-k)"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
