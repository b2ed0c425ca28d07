"""Port of ``experiments/pallas_probe13.py``: five variants of the
conditional refill with a variable shift.

Five bodies over one ``(8, 128)`` tile, ``STEPS`` steps while any lane's
``avail > -2**30``: the masked index redirected to -1, the row index
masked instead of reduced, an unconditional load, a constant shift, and a
refill condition from the step's parity.  The result is ``b0``.  Kernels in
``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe13``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe13.run"
R, STEPS = 64, 200
V = 1  # no output column

q4_const_shift, q4_const_shift_plain = lanes.pair(SITE, "p13_q4", V, STEPS)
q1_neg_redirect, q1_neg_redirect_plain = lanes.pair(SITE, "p13_q1", V, STEPS)
q2_no_mod, q2_no_mod_plain = lanes.pair(SITE, "p13_q2", V, STEPS)
q3_uncond_load, q3_uncond_load_plain = lanes.pair(SITE, "p13_q3", V, STEPS)
q5_cond_from_const, q5_cond_from_const_plain = lanes.pair(
    SITE, "p13_q5", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (q4_const_shift, q4_const_shift_plain, "q4 cond refill, const shift"),
    (q1_neg_redirect, q1_neg_redirect_plain,
     "q1 cond refill (idx -1), var shift"),
    (q2_no_mod, q2_no_mod_plain, "q2 cond refill (mask mod), var shift"),
    (q3_uncond_load, q3_uncond_load_plain, "q3 uncond load, var shift"),
    (q5_cond_from_const, q5_cond_from_const_plain,
     "q5 cond-from-step, var shift"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
