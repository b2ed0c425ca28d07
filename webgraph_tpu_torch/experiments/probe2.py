"""Port of ``experiments/pallas_probe2.py``: what a loop step costs, by body
and by the number of lanes.

``loop_kernel(x, steps, body)`` runs ``steps`` steps of one body over the
lanes of ``x`` (``(S, 128)`` int32, from 1..4) from ``acc = 0``: ``add``
(``acc + x``), ``add10`` (ten times ``acc + (x ^ acc)``), ``mul``
(``acc + x * acc``), ``shift`` (``((acc + x) >> 1) | (acc << 1)``, ``>>``
arithmetic) and ``gather_tile`` (``acc + x[acc & 7, col]``, a gather from
the first 8 rows of the lane's own column).  int32 arithmetic wraps.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe2``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import common as C
from .common import Case, i64, out32, s32, sar

SITE = "probe2.loop_kernel"
BODIES = {"add": C.LOOP_ADD, "add10": C.LOOP_XORADD, "mul": C.LOOP_MUL,
          "shift": C.LOOP_SHIFT, "gather_tile": C.LOOP_GATHER_TILE}


def loop_kernel(x: torch.Tensor, steps: int, body: str = "add",
                site: str = SITE) -> torch.Tensor:
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}")
    if body == "gather_tile" and x.shape[0] < 8:
        raise ValueError("gather_tile reads rows 0..7: need 8 or more rows")
    if C.check_lanes(x, steps):
        return loop_kernel_plain(x, steps, body)
    return C.loop(site, BODIES[body], x, steps,
                  param=10 if body == "add10" else 0)


def step_plain(body: str, acc: torch.Tensor, x: torch.Tensor, col,
               ops: int = 10) -> torch.Tensor:
    """One step of ``body`` on int32 carriers (``add10`` is ``ops`` times
    ``acc + (x ^ acc)``)."""
    if body == "add":
        return s32(acc + x)
    if body == "add10":
        for _ in range(ops):
            acc = s32(acc + (x ^ acc))
        return acc
    if body == "mul":
        return s32(acc + x * acc)
    if body == "shift":
        return s32(sar(acc + x, 1) | s32(acc << 1))
    if body == "gather_tile":
        return s32(acc + x[acc & 7, col])
    raise ValueError(f"unknown body {body!r}")


def loop_kernel_plain(x: torch.Tensor, steps: int, body: str = "add"
                      ) -> torch.Tensor:
    xi = i64(x)
    acc = torch.zeros_like(xi)
    col = torch.arange(x.shape[1], device=x.device)
    for _ in range(steps):
        acc = step_plain(body, acc, xi, col)
    return out32(acc)


def inputs(rng: np.random.Generator, device, shape=(8, 128)) -> torch.Tensor:
    return torch.from_numpy(rng.integers(1, 5, shape).astype(np.int32)
                            ).to(device)


def _case(rng, device, name, steps, body, shape=(8, 128)) -> Case:
    lanes = shape[0] * shape[1]
    return Case(SITE, name, loop_kernel, loop_kernel_plain,
                (inputs(rng, device, shape),), steps=steps, kw=dict(body=body),
                check_steps=min(steps, 2000), lanes=lanes,
                tiles=max(1, lanes // C.LANES))


def cases(device, rng: np.random.Generator) -> list[Case]:
    out = [_case(rng, device, f"add body, {s} steps", s, "add")
           for s in (100, 1000, 10000)]
    out += [
        _case(rng, device, "add10 body (10 ops), 1000 steps", 1000, "add10"),
        _case(rng, device, "mul body, 1000 steps", 1000, "mul"),
        _case(rng, device, "shift body, 1000 steps", 1000, "shift"),
        _case(rng, device, "same-shape tile gather (8,128), 1000 steps",
              1000, "gather_tile"),
        _case(rng, device, "same-shape tile gather (16,128), 1000 steps",
              1000, "gather_tile", (16, 128)),
        _case(rng, device, "add body, (64,128) tile, 1000 steps", 1000,
              "add", (64, 128)),
    ]
    return out


if __name__ == "__main__":
    sys.exit(C.main(cases))
