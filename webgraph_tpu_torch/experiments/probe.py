"""Port of ``experiments/pallas_probe.py``: a trivial kernel, and which
per-lane gather forms work and what a gather step costs.

Five loops of ``STEPS`` steps over ``(8, 128)`` lanes (``gather_32``:
``(32, 128)``): ``acc += tbl[(idx + acc) & (W - 1), col]`` from a
``(W, 128)`` table (``gather_sublane``, ``gather_ref``, ``gather_32``),
``acc += tbl[(idx + acc) & (W - 1)]`` from a ``(W,)`` table
(``gather_1d``), and the same number of steps with no gather
(``vpu_loop``).  On the card the ``(4096, 128)`` table (2 MB) is read from
device memory and the 16 KB one from shared memory; the TPU's distinction
between gathering from a loaded value and from the ref has no counterpart,
so ``gather_sublane`` and ``gather_ref`` run the same kernel.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import common as C
from .common import Case, i64, out32, s32, sar

W = 4096
STEPS = 1000


def trivial(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` (int32, wrapping)."""
    if C.check_lanes(x):
        return trivial_plain(x)
    return C.loop("probe.trivial", C.LOOP_TRIVIAL, x, 0)


def trivial_plain(x: torch.Tensor) -> torch.Tensor:
    return out32(i64(x) * 2)


def _gather(site: str, tbl, idx, steps):
    if tbl.dim() != 2 or tbl.shape[1] != 128:
        raise ValueError(f"tbl: need a (W, 128) table, got {tuple(tbl.shape)}")
    if C.check_lanes(idx, steps, tbl):
        return gather_plain(tbl, idx, steps)
    return C.loop(site, C.LOOP_GATHER_TBL, idx, steps, tbl=tbl)


def gather_plain(tbl: torch.Tensor, idx: torch.Tensor, steps: int = STEPS
                 ) -> torch.Tensor:
    """``steps`` times ``acc += tbl[(idx + acc) & (W - 1), col]``."""
    t = i64(tbl)
    i = i64(idx)
    col = torch.arange(128, device=idx.device)
    acc = torch.zeros_like(i)
    for _ in range(steps):
        acc = s32(acc + t[(i + acc) & (t.shape[0] - 1), col])
    return out32(acc)


def gather_sublane(tbl, idx, steps: int = STEPS):
    return _gather("probe.gather_sublane", tbl, idx, steps)


def gather_ref(tbl, idx, steps: int = STEPS):
    return _gather("probe.gather_ref", tbl, idx, steps)


def gather_32(tbl, idx, steps: int = STEPS):
    return _gather("probe.gather_32", tbl, idx, steps)


gather_sublane_plain = gather_ref_plain = gather_32_plain = gather_plain


def gather_1d(tbl: torch.Tensor, idx: torch.Tensor, steps: int = STEPS
              ) -> torch.Tensor:
    """``steps`` times ``acc += tbl1d[(idx + acc) & (W - 1)]``; ``tbl`` is
    ``(W, 1)`` or ``(W,)``."""
    if C.check_lanes(idx, steps, tbl.reshape(-1)):
        return gather_1d_plain(tbl, idx, steps)
    return C.loop("probe.gather_1d", C.LOOP_GATHER_1D, idx, steps,
                  tbl=tbl.reshape(-1))


def gather_1d_plain(tbl, idx, steps: int = STEPS):
    t = i64(tbl.reshape(-1))
    i = i64(idx)
    acc = torch.zeros_like(i)
    for _ in range(steps):
        acc = s32(acc + t[(i + acc) & (t.shape[0] - 1)])
    return out32(acc)


def vpu_loop(idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """``steps`` times ``acc += ((idx * acc + 12345) >> 3) & 7``."""
    if C.check_lanes(idx, steps):
        return vpu_loop_plain(idx, steps)
    return C.loop("probe.vpu_loop", C.LOOP_VPU, idx, steps)


def vpu_loop_plain(idx, steps: int = STEPS):
    i = i64(idx)
    acc = torch.zeros_like(i)
    for _ in range(steps):
        acc = s32(acc + (sar(s32(i * acc + 12345), 3) & 7))
    return out32(acc)


def inputs(rng: np.random.Generator, device, rows: int = 8, table: str = "2d"):
    """The probe's inputs, drawn in its order: the table (``(W, 128)`` or
    ``(W, 1)``), then the ``(rows, 128)`` indices."""
    shape = (W, 128) if table == "2d" else (W, 1)
    tbl = rng.integers(0, 7, shape).astype(np.int32)
    idx = rng.integers(0, W, (rows, 128)).astype(np.int32)
    return (torch.from_numpy(tbl).to(device),
            torch.from_numpy(idx).to(device))


def cases(device, rng: np.random.Generator) -> list[Case]:
    x = torch.arange(8 * 128, dtype=torch.int32, device=device).reshape(8, 128)
    idx = torch.from_numpy(rng.integers(0, W, (8, 128)).astype(np.int32)
                           ).to(device)
    return [
        Case("probe.trivial", "trivial kernel", trivial, trivial_plain, (x,)),
        Case("probe.vpu_loop", "vpu loop 1000 steps (no gather)", vpu_loop,
             vpu_loop_plain, (idx,), steps=STEPS),
        Case("probe.gather_sublane",
             "take_along_axis sublane gather in fori_loop (8x128)",
             gather_sublane, gather_plain, inputs(rng, device), steps=STEPS),
        Case("probe.gather_ref", "same but indexing ref each step",
             gather_ref, gather_plain, inputs(rng, device), steps=STEPS),
        Case("probe.gather_1d", "1-D jnp.take gather in fori_loop",
             gather_1d, gather_1d_plain, inputs(rng, device, table="1d"),
             steps=STEPS),
        Case("probe.gather_32", "take_along_axis gather (32x128 lanes)",
             gather_32, gather_plain, inputs(rng, device, rows=32),
             steps=STEPS, lanes=32 * 128, tiles=4),
    ]


if __name__ == "__main__":
    sys.exit(C.main(cases))
