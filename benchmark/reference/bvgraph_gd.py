"""Plain reference of BVGraph's gap-coded setting: γ outdegrees, δ gaps,
no reference window and no intervals.

Written from the format as webgraph's ``BVGraph`` defines it (the entry
layout BVGraph.java:123-233; the reference part written only when the
window is not 0, :687-720; the interval part only when minIntervalLength
is not 0, :1040-1059 and :2092-2121; the residual coding chosen by the
flag nibble at shift 8, :476-524), and independent of the program.  With
windowSize 0, minIntervalLength 0 (``NO_INTERVALS``) and
``RESIDUALS_DELTA`` a node x's entry is, in MSB-first bit order:

1. its outdegree d, γ-coded;
2. if d > 0, its successors s_0 < ... < s_{d-1} as residuals: first
   ``int2nat(s_0 - x)``, then each gap ``s_i - s_{i-1} - 1``, δ-coded.

γ(v) is floor(log2(v + 1)) zeros, then v + 1 in binary; δ(v) is
γ(floor(log2(v + 1))), then the low floor(log2(v + 1)) bits of v + 1;
``int2nat(x)`` is 2x for x >= 0, else -2x - 1.

Plain Python integers per list, and torch for the closed form over every
node at once.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

CHUNK_ARCS = 1 << 24


def _msb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of each int64 x >= 1, -1 for 0: six halvings."""
    r = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        x = torch.where(big, x >> s, x)
        r = r + big.to(r.dtype) * s
    return torch.where(x > 0, r, -1)


def _gamma_bits(v: torch.Tensor) -> torch.Tensor:
    return 2 * _msb(v + 1) + 1


def _delta_bits(v: torch.Tensor) -> torch.Tensor:
    k = _msb(v + 1)
    return _gamma_bits(k) + k


def entry_bits(offsets: torch.Tensor, succ: torch.Tensor,
               chunk_arcs: int = CHUNK_ARCS) -> torch.Tensor:
    """Bits of each node's entry (int64[n]), in closed form from the CSR
    (both on one device): γ of the outdegree plus δ of each residual, the
    arcs taken ``chunk_arcs`` at a time."""
    off = offsets.to(torch.int64)
    out = _gamma_bits(off[1:] - off[:-1])
    for a0 in range(0, int(off[-1]), chunk_arcs):
        pos = torch.arange(a0, min(a0 + chunk_arcs, int(off[-1])),
                           dtype=torch.int64, device=off.device)
        x = torch.searchsorted(off[1:], pos, right=True)
        s = succ[pos].to(torch.int64)
        prev = succ[(pos - 1).clamp(min=0)].to(torch.int64)
        first = pos == off[x]
        r = s - x
        v = torch.where(first, torch.where(r >= 0, 2 * r, -2 * r - 1),
                        s - prev - 1)
        out.index_add_(0, x, _delta_bits(v))
    return out


def _gamma(bits: list, v: int) -> None:
    w = (v + 1).bit_length()
    bits.extend([0] * (w - 1))
    bits.extend((v + 1) >> k & 1 for k in range(w - 1, -1, -1))


def _delta(bits: list, v: int) -> None:
    k = (v + 1).bit_length() - 1
    _gamma(bits, k)
    bits.extend((v + 1) >> j & 1 for j in range(k - 1, -1, -1))


def encode_list(x: int, lst) -> list:
    """The entry of node ``x`` whose successors are ``lst`` (ascending,
    distinct, non-negative) as a list of bits, stream order."""
    lst = [int(v) for v in lst]
    if any(b <= a for a, b in zip(lst, lst[1:])) or (lst and lst[0] < 0):
        raise ValueError("a list must be ascending, distinct, non-negative")
    bits = []
    _gamma(bits, len(lst))
    for i, s in enumerate(lst):
        if i == 0:
            r = s - x
            _delta(bits, 2 * r if r >= 0 else -2 * r - 1)
        else:
            _delta(bits, s - lst[i - 1] - 1)
    return bits


class _Reader:
    def __init__(self, bits):
        self.bits, self.pos = bits, 0

    def bit(self) -> int:
        if self.pos >= len(self.bits):
            raise IndexError("the entry ends inside a code")
        self.pos += 1
        return self.bits[self.pos - 1]

    def fixed(self, w: int) -> int:
        v = 0
        for _ in range(w):
            v = v << 1 | self.bit()
        return v

    def gamma(self) -> int:
        z = 0
        while not self.bit():
            z += 1
        return (1 << z | self.fixed(z)) - 1

    def delta(self) -> int:
        k = self.gamma()
        return (1 << k | self.fixed(k)) - 1


def decode_entry(bits, x: int) -> list:
    """The list that node ``x``'s entry holds, read from ``bits`` (stream
    order, the entry's alone): γ outdegree, then the δ residuals.  Raises
    ``ValueError`` where bits are left over, ``IndexError`` where the
    entry ends inside a code."""
    r = _Reader(bits)
    d = r.gamma()
    out = []
    for i in range(d):
        v = r.delta()
        if i == 0:
            out.append(x + (v >> 1 if v % 2 == 0 else -((v + 1) >> 1)))
        else:
            out.append(out[-1] + v + 1)
    if r.pos != len(bits):
        raise ValueError(f"{len(bits) - r.pos} bits after the entry")
    return out


def stored_bits(data, start: int, end: int) -> list:
    """Bits [start, end) of a byte stream (``uint8`` array or bytes),
    MSB-first within each byte, in stream order."""
    start, end = int(start), int(end)
    if not 0 <= start <= end <= 8 * len(memoryview(data).cast("B")):
        raise IndexError(f"bits [{start}, {end}) outside the stream")
    raw = bytes(memoryview(data).cast("B")[start >> 3:(end + 7) >> 3])
    v = int.from_bytes(raw, "big")
    total = 8 * len(raw)
    lo = start & 7
    return [(v >> (total - 1 - lo - k)) & 1 for k in range(end - start)]
