"""Port of ``experiments/pallas_probe12.py``: the conditional refill and the
shift pair, together and apart.

Four bodies over one ``(8, 128)`` tile, ``STEPS`` steps while any lane's
``avail > -2**30``; the result is ``b0``.  Kernels in
``csrc/probe_lane.cu``, plain twins in ``lanes.py``.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe12``.
"""

from __future__ import annotations

import sys

import numpy as np

from . import common as C
from . import lanes
from .common import Case

SITE = "probe12.run"
R, STEPS = 64, 200
V = 1  # no output column

p1_shiftpair, p1_shiftpair_plain = lanes.pair(SITE, "p12_p1", V, STEPS)
p2_condrefill, p2_condrefill_plain = lanes.pair(SITE, "p12_p2", V, STEPS)
p3_both, p3_both_plain = lanes.pair(SITE, "p12_p3", V, STEPS)
p4_pair_int32amount, p4_pair_int32amount_plain = lanes.pair(
    SITE, "p12_p4", V, STEPS)

# (kernel, plain twin, its line in the probe's output)
BODIES = (
    (p1_shiftpair, p1_shiftpair_plain, "p1 shift-pair, k from loaded"),
    (p2_condrefill, p2_condrefill_plain, "p2 cond refill, single shift"),
    (p3_both, p3_both_plain, "p3 cond refill + shift pair (uint k)"),
    (p4_pair_int32amount, p4_pair_int32amount_plain,
     "p4 cond refill + shift pair (int k cast)"),
)


def cases(device, rng: np.random.Generator) -> list[Case]:
    return lanes.cases(SITE, BODIES, device, rng, R, STEPS)


if __name__ == "__main__":
    sys.exit(C.main(cases))
