"""HyperBall: one round of HyperLogLog register max-merges over a device CSR.

Counterpart of ``webgraph_tpu/algo/hyperball.py`` (``hyperloglog_init`` and
``estimate_counts`` ``:57-95``, ``device_round`` ``:296``).  The two host
functions are numpy copies of the JAX module's (that module imports jax).
A round is c'[x] = max(c[x], max over successors y of c[y]) on uint8
registers (HyperBall.java:654-900): a gather of the successors' register
rows and a scatter-max into their sources, in PyTorch ops (in the JAX
package it is an XLA program, not a Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hyperloglog_init", "estimate_counts", "device_round"]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# arcs per gather/scatter slice: bounds the (arcs, registers) transient
ARC_SLICE = 1 << 26


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    z = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return z ^ (z >> np.uint64(31))


def _alpha(m: int) -> float:
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))


def hyperloglog_init(n: int, log2m: int, seed: int = 0) -> np.ndarray:
    """Initial registers: each node's counter holds only itself
    (HyperBall.init :571).  uint8 (n, 2^log2m)."""
    m = 1 << log2m
    regs = np.zeros((n, m), dtype=np.uint8)
    with np.errstate(over="ignore"):   # the seed's mix wraps mod 2^64
        h = _splitmix64(np.arange(n, dtype=np.uint64)
                        + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    j = (h & np.uint64(m - 1)).astype(np.int64)
    w = h >> np.uint64(log2m)
    zero = w == 0
    v = np.where(zero, np.uint64(1), w)
    tz = np.zeros(n, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        low = (v & ((np.uint64(1) << np.uint64(shift)) - np.uint64(1))) == 0
        tz = np.where(low, tz + shift, tz)
        v = np.where(low, v >> np.uint64(shift), v)
    rho = np.where(zero, 64 - log2m, tz) + 1
    regs[np.arange(n), j] = rho.astype(np.uint8)
    return regs


def estimate_counts(regs: np.ndarray) -> np.ndarray:
    """Per-node HLL cardinality estimates with small-range correction."""
    regs = np.asarray(regs)
    m = regs.shape[1]
    est = _alpha(m) * m * m / np.sum(np.exp2(-regs.astype(np.float64)),
                                     axis=1)
    zeros = np.sum(regs == 0, axis=1)
    small = (est <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lin = m * np.log(m / np.maximum(zeros, 1e-300))
    return np.where(small, lin, est)


def device_round(csr_off, succ: torch.Tensor,
                 regs: torch.Tensor) -> torch.Tensor:
    """One HyperBall iteration over a device CSR; returns new registers.

    ``csr_off``: host int64[n+1]; ``succ``: int32/int64[m] on the device;
    ``regs``: uint8 (n, 2^log2m) on the same device."""
    if regs.dtype != torch.uint8 or regs.dim() != 2:
        raise ValueError("regs must be uint8 (n, 2^log2m)")
    dev = regs.device
    co = torch.as_tensor(np.asarray(csr_off, dtype=np.int64), device=dev)
    n, R = regs.shape
    if co.shape[0] != n + 1 or succ.device != dev:
        raise ValueError("csr_off must have n+1 entries; succ on regs' device")
    m = succ.shape[0]
    src = torch.repeat_interleave(
        torch.arange(n, device=dev, dtype=torch.int32), co[1:] - co[:-1],
        output_size=m)
    out = regs.clone()
    for lo in range(0, m, ARC_SLICE):
        hi = min(lo + ARC_SLICE, m)
        idx = src[lo:hi].to(torch.int64)[:, None].expand(-1, R)
        out.scatter_reduce_(0, idx, regs[succ[lo:hi].to(torch.int64)],
                            "amax", include_self=True)
    return out
