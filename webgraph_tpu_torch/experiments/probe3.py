"""Port of ``experiments/pallas_probe3.py``: the cost of a loop step from
200 to 100,000 steps, beside chained matrix products and chains of small
dispatches.

``loop_kernel(x, steps)`` is ``steps`` times ``acc += x`` over the lanes of
``x`` (``(8, 128)`` int32).  The probe's matrix-product chains and small
dispatches were XLA, not Pallas; here they are plain torch operations
(``matmul_chain``, ``many_dispatches``), timed beside the kernel.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe3``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import common as C
from . import probe2
from .common import Case

SITE = "probe3.loop_kernel"
LOOP_STEPS = (200, 400, 600, 800, 1000, 2000, 100000)
MATMULS = ((1024, 1), (2048, 4), (4096, 8), (4096, 32), (8192, 32))
DISPATCHES = (10, 100, 300)


def loop_kernel(x: torch.Tensor, steps: int) -> torch.Tensor:
    return probe2.loop_kernel(x, steps, "add", site=SITE)


def loop_kernel_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    return probe2.loop_kernel_plain(x, steps, "add")


def matmul_chain(a: torch.Tensor, chain: int) -> torch.Tensor:
    """``chain`` times ``x = x @ a`` in ``a``'s type, each product scaled
    by its largest magnitude."""
    x = a
    for _ in range(chain):
        x = torch.matmul(x, a)
        x = x / x.abs().max()
    return x


def many_dispatches(a: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` small dependent operations, ``x * 1.00001 + 1``."""
    x = a
    for _ in range(k):
        x = x * 1.00001 + 1.0
    return x


def cases(device, rng: np.random.Generator) -> list[Case]:
    x = probe2.inputs(rng, device)
    return [Case(SITE, f"pallas loop {s:>7} steps", loop_kernel,
                 loop_kernel_plain, (x,), steps=s, check_steps=min(s, 2000))
            for s in LOOP_STEPS]


def extras(device, rng: np.random.Generator) -> list[str]:
    lines = []
    for size, chain in MATMULS:
        a = torch.from_numpy(rng.standard_normal((size, size)).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)
        ms = C.device_ms(lambda: matmul_chain(a, chain), reps=3)
        lines.append(f"torch matmul {size}x{size} x{chain}: {ms:8.3f} ms "
                     f"({2 * chain * size ** 3 / ms / 1e9:.1f} Tflop/s bf16)")
    a = torch.ones((256, 256), dtype=torch.float32, device=device)
    many_dispatches(a, 1)
    for k in DISPATCHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many_dispatches(a, k)
        torch.cuda.synchronize()
        lines.append(f"{k} chained small dispatches: "
                     f"{(time.perf_counter() - t0) * 1e3:8.3f} ms")
    return lines


if __name__ == "__main__":
    sys.exit(C.main(cases, extras))
