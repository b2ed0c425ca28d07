"""Plain reference of a HyperBall run.

HyperBall (Boldi and Vigna, HyperBall.java) keeps one HyperLogLog counter
of 2^log2m uint8 registers per node.  Node x starts with only itself: one
register, chosen by a 64-bit hash of x, holds the position of the lowest
set bit of the rest of the hash.  A round sets every counter to the
register-wise maximum of itself and its successors' counters as they were
before the round.  The run ends with the first round that changes nothing.
The neighbourhood function holds n, then after each round the sum of the
counters' HyperLogLog estimates (Flajolet et al.'s, with the small-range
correction).  The hash is splitmix64 of ``x + seed * 0x9E3779B97F4A7C15``,
the port's choice, so registers compare exactly.

Plain torch, in blocks of arcs and rows; nothing of the program.  A round
merges only the arcs whose target changed in the round before: a target
that did not change brings nothing new, so this is exact.
"""

from __future__ import annotations

import torch

_I64 = torch.int64
GOLDEN = 0x9E3779B97F4A7C15
ARC_BLOCK = 1 << 24
ROW_BLOCK = 1 << 20


def _wrap(c: int) -> int:
    """A 64-bit pattern as an int64 value."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def init_registers(n: int, log2m: int, seed: int, device) -> torch.Tensor:
    m = 1 << log2m
    x = torch.arange(n, dtype=_I64, device=device) + _wrap(seed * GOLDEN)
    x = x + _wrap(GOLDEN)
    x = (x ^ _srl(x, 30)) * _wrap(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _wrap(0x94D049BB133111EB)
    h = x ^ _srl(x, 31)
    del x
    j = h & (m - 1)
    w = _srl(h, log2m)                       # below 2^(64 - log2m)
    low = (w & -w).to(torch.float64)         # a power of two, exact
    tz = torch.log2(torch.where(w == 0, 1.0, low)).round().to(_I64)
    rho = torch.where(w == 0, 64 - log2m, tz) + 1
    regs = torch.zeros((n, m), dtype=torch.uint8, device=device)
    regs[torch.arange(n, device=device), j] = rho.to(torch.uint8)
    return regs


def estimates(regs: torch.Tensor, dtype) -> torch.Tensor:
    """HyperLogLog estimate of each row, in ``dtype``."""
    m = regs.shape[1]
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    r = regs.to(dtype)
    raw = alpha * m * m / torch.exp2(-r).sum(1)
    zeros = (regs == 0).sum(1).to(dtype)
    small = (raw <= 2.5 * m) & (zeros > 0)
    lin = m * torch.log(m / torch.clamp(zeros, min=1.0))
    return torch.where(small, lin, raw)


def _update(counts: torch.Tensor, regs: torch.Tensor, rows: torch.Tensor):
    for lo in range(0, rows.numel(), ROW_BLOCK):
        r = rows[lo:lo + ROW_BLOCK]
        counts[r] = estimates(regs[r], counts.dtype)


def run(offsets: torch.Tensor, succ: torch.Tensor, log2m: int, seed: int,
        dtype=torch.float64) -> tuple:
    """(neighbourhood function, final registers) of a run to the end, on
    ``succ``'s device; estimates and their sums in ``dtype``."""
    dev = succ.device
    off = offsets.to(dev, _I64)
    n = off.numel() - 1
    m_arcs = succ.numel()
    regs = init_registers(n, log2m, seed, dev)
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), off[1:] - off[:-1],
        output_size=m_arcs)
    counts = torch.empty(n, dtype=dtype, device=dev)
    _update(counts, regs, torch.arange(n, device=dev))
    nf = [float(n)]
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    width = regs.shape[1]
    while True:
        new = regs.clone()
        for lo in range(0, m_arcs, ARC_BLOCK):
            t = succ[lo:lo + ARC_BLOCK].to(_I64)
            sel = changed[t]
            s = src[lo:lo + ARC_BLOCK][sel].to(_I64)
            t = t[sel]
            if s.numel():
                new.scatter_reduce_(0, s[:, None].expand(-1, width), regs[t],
                                    "amax", include_self=True)
        rows = torch.nonzero((new != regs).any(1)).squeeze(1)
        regs = new
        _update(counts, regs, rows)
        nf.append(float(counts.sum()))
        if rows.numel() == 0:
            return nf, regs
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        changed[rows] = True
