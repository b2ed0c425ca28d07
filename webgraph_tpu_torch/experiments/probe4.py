"""Port of ``experiments/pallas_probe4.py``: loop cost by steps, by
operations a step and by lanes, beside a no-op round trip, chained matrix
products, a two-key sort and a gather of 3.2M elements.

``loop_kernel(x, steps, body_ops)`` is ``steps`` steps of ``body_ops``
times ``acc = acc + (x ^ acc)`` (int32, wrapping) over the lanes of ``x``.
The round trip, products, sort and gather were XLA in the probe and are
plain torch operations here (``noop_roundtrip``, ``sort_2key``,
``gather``), timed beside the kernel.

Run on the card: ``python -m webgraph_tpu_torch.experiments.probe4``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import common as C
from . import probe2
from .common import Case, i64, out32

SITE = "probe4.loop_kernel"
ARCS, NODES = 3_216_152, 325_557       # cnr-2000's arcs and nodes


def loop_kernel(x: torch.Tensor, steps: int, body_ops: int = 1
                ) -> torch.Tensor:
    if body_ops not in (1, 10, 50):
        raise ValueError("the kernel is built for 1, 10 or 50 ops a step")
    if C.check_lanes(x, steps):
        return loop_kernel_plain(x, steps, body_ops)
    return C.loop(SITE, C.LOOP_XORADD, x, steps, param=body_ops)


def loop_kernel_plain(x: torch.Tensor, steps: int, body_ops: int = 1
                      ) -> torch.Tensor:
    xi = i64(x)
    acc = torch.zeros_like(xi)
    for _ in range(steps):
        acc = probe2.step_plain("add10", acc, xi, None, ops=body_ops)
    return out32(acc)


def noop_roundtrip(a: torch.Tensor) -> int:
    """``a + 1`` and one element read back to the host."""
    return int((a + 1)[0, 0])


def sort_2key(k1: torch.Tensor, k2: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """``v`` in the order of the keys ``(k1, k2)`` (both non-negative
    int32), ties in their original order."""
    key = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    return v[torch.sort(key, stable=True).indices]


def gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t[idx]


def cases(device, rng: np.random.Generator) -> list[Case]:
    def case(name, steps, ops=1, shape=(8, 128)):
        lanes = shape[0] * shape[1]
        return Case(SITE, name, loop_kernel, loop_kernel_plain,
                    (probe2.inputs(rng, device, shape),), steps=steps,
                    kw=dict(body_ops=ops),
                    check_steps=min(steps, max(100, 5000 // ops)),
                    lanes=lanes, tiles=max(1, lanes // C.LANES))

    out = [case(f"pallas loop {s:>7} steps x1op", s)
           for s in (100, 1000, 10000, 100000)]
    out += [case(f"pallas loop 10000 steps x{ops}ops", 10000, ops)
            for ops in (10, 50)]
    out.append(case("pallas loop 10000 steps (32,128)", 10000,
                    shape=(32, 128)))
    return out


def _host_ms(fn, reps: int = 5) -> float:
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e3


def extras(device, rng: np.random.Generator) -> list[str]:
    a = torch.ones((8, 128), dtype=torch.int32, device=device)
    lines = [f"noop roundtrip: {_host_ms(lambda: noop_roundtrip(a)):8.3f} ms"]
    for size, chain in ((2048, 4), (4096, 8)):
        m = torch.from_numpy((rng.standard_normal((size, size)) * 0.01)
                             .astype(np.float32)).to(device=device,
                                                     dtype=torch.bfloat16)

        def chain_fn(m=m, chain=chain):
            x = m
            for _ in range(chain):
                x = torch.matmul(x, m)
            return x
        ms = C.device_ms(chain_fn, reps=3)
        lines.append(f"torch matmul {size} x{chain}: {ms:8.3f} ms "
                     f"({2 * chain * size ** 3 / ms / 1e9:.1f} Tflop/s bf16)")
    k1, k2 = (torch.from_numpy(rng.integers(0, NODES, ARCS).astype(np.int32))
              .to(device) for _ in range(2))
    v = torch.from_numpy(rng.integers(0, 1 << 30, ARCS).astype(np.int32)
                         ).to(device)
    lines.append(f"torch 2-key sort of 3.2M:  "
                 f"{C.device_ms(lambda: sort_2key(k1, k2, v)):8.3f} ms")
    idx = torch.from_numpy(rng.integers(0, ARCS, ARCS)).to(device)
    lines.append(f"torch gather of 3.2M:      "
                 f"{C.device_ms(lambda: gather(v, idx)):8.3f} ms")
    return lines


if __name__ == "__main__":
    sys.exit(C.main(cases, extras))
