"""Plain reference of the EFGraph format: a per-list encoder and decoder.

Written from the format as webgraph-big's ``EFGraph`` defines it (entry
layout EFGraph.java:140-168, the list accumulator :477-532, LSB-first
longword output :294-340), and independent of the program.  Per node the
stream holds, from its offset on, bits in LSB-first order:

1. the outdegree d as writeNonZeroGamma(d + 1): msb zeros, a one, then the
   msb low bits of d + 1 (msb = floor(log2(d + 1)));
2. the list extended by a sentinel u (the upper bound), cl = d + 1 values
   v_0 < ... < v_d = u, split at l = max(0, floor(log2(u / cl))) bits;
3. skip pointers: (u >> l) >> q of them when the pointer size
   ceil(log2(cl + (u >> l))) is not 0, each of that many bits; pointer k
   (1-based) is k * 2^q plus the number of values whose upper part
   v >> l lies below k * 2^q (one past the (k * 2^q)-th zero below);
4. the lower l bits of each value, in order;
5. the upper bits: (u >> l) + cl bits, value i's one at (v_i >> l) + i.

Plain Python integers per list, and torch for the closed form over every
node at once.  Imports nothing of the program.
"""

from __future__ import annotations

from bisect import bisect_left

import torch


def _msb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of each int64 x >= 1, -1 for 0: six halvings."""
    r = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        x = torch.where(big, x >> s, x)
        r = r + big.to(r.dtype) * s
    return torch.where(x > 0, r, -1)


def entry_bits(d: torch.Tensor, u: int, log2_quantum: int) -> torch.Tensor:
    """Bits of each node's entry, from its outdegree ``d`` (int64), in
    closed form: gamma + pointers + lower + upper."""
    d = d.to(torch.int64)
    cl = d + 1
    gamma = 2 * _msb(cl) + 1
    l = _msb(u // cl).clamp(min=0)
    shifted = torch.full_like(d, u) >> l
    psize = _msb(cl + shifted - 1) + 1          # ceil(log2(cl + shifted))
    pointers = (shifted >> log2_quantum) * psize
    return gamma + pointers + cl * l + shifted + cl


def _put(bits: list, value: int, width: int) -> None:
    bits.extend((value >> k) & 1 for k in range(width))


def _params(d: int, u: int, log2_quantum: int):
    cl = d + 1
    l = max(0, (u // cl).bit_length() - 1)
    shifted = u >> l
    psize = (cl + shifted - 1).bit_length()
    npointers = shifted >> log2_quantum if psize else 0
    return cl, l, shifted, psize, npointers


def encode_list(succ, u: int, log2_quantum: int) -> list:
    """The entry of one list (ascending, distinct, below ``u``) as a list
    of bits, LSB-first stream order."""
    succ = [int(v) for v in succ]
    if any(b <= a for a, b in zip(succ, succ[1:])) or (
            succ and (succ[0] < 0 or succ[-1] >= u)):
        raise ValueError(f"a list must be ascending, distinct, in [0, {u})")
    d = len(succ)
    cl, l, shifted, psize, npointers = _params(d, u, log2_quantum)
    bits = []
    msb = cl.bit_length() - 1
    _put(bits, 1 << msb, msb + 1)
    _put(bits, cl - (1 << msb), msb)
    values = succ + [u]
    highs = [v >> l for v in values]
    for k in range(1, npointers + 1):
        zero = k << log2_quantum
        _put(bits, zero + bisect_left(highs, zero), psize)
    for v in values:
        _put(bits, v & ((1 << l) - 1), l)
    upper = [0] * (shifted + cl)
    for i, h in enumerate(highs):
        upper[h + i] = 1
    return bits + upper


def decode_entry(bits, u: int, log2_quantum: int) -> list:
    """The list one entry (bits in stream order, at least the entry's)
    holds: read the gamma outdegree, skip the pointers, then pair the
    i-th one of the upper bits with the i-th lower field."""
    msb = 0
    while not bits[msb]:
        msb += 1
    cl = (1 << msb) | sum(bits[msb + 1 + k] << k for k in range(msb))
    d = cl - 1
    _, l, shifted, psize, npointers = _params(d, u, log2_quantum)
    pos = 2 * msb + 1 + npointers * psize
    lows = [sum(bits[pos + i * l + k] << k for k in range(l))
            for i in range(cl)]
    pos += cl * l
    out, i = [], 0
    for p in range(shifted + cl):
        if bits[pos + p]:
            out.append(((p - i) << l) | lows[i])
            i += 1
            if i == cl:
                break
    if out[-1:] != [u]:
        raise ValueError("the entry's last value is not the sentinel")
    return out[:-1]


def stored_bits(words, start: int, end: int) -> list:
    """Bits [start, end) of a stream of little-endian 64-bit words (a
    ``uint64`` array or bytes), in stream order."""
    raw = bytes(memoryview(words).cast("B")[(start >> 6) * 8:
                                            ((end + 63) >> 6) * 8])
    v = int.from_bytes(raw, "little") >> (start & 63)
    return [(v >> k) & 1 for k in range(end - start)]
