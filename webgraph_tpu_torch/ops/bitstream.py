"""The packed bit stream on the device, and plain readers of its codes.

The BVGraph stream is MSB-first; on the device it is one int32 tensor of
big-endian packed 32-bit words (``pack_words_u32``: stream bit i is bit
31 - i % 32 of word i // 32, with 16 zero guard words).  Every lane of the
decode reads the same copy at its own absolute bit offset.

The readers here are the plain PyTorch twin of the kernel's code reader
(``csrc/bv_decode.cu``, ``Stream::read``): vectorised over lanes, one code per
lane at a per-lane bit position and of a per-lane kind.  Words are held in
int64 and masked to 32 bits, because CPU tensors have no uint32 shifts.
Reads past the end of the stream see zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu.ops.packed import pack_words_u32

K_NONE, K_DELTA, K_GAMMA, K_UNARY, K_ZETA = 0, 1, 2, 5, 6
E_UNARY, E_WIDTH = 1, 2
M32 = 0xFFFFFFFF


def stream_words(data, device) -> torch.Tensor:
    """uint8 stream bytes -> int32 tensor of packed words on ``device``."""
    w = pack_words_u32(np.asarray(data, dtype=np.uint8))
    return torch.from_numpy(w.view(np.int32)).to(device)


def words_i64(words: torch.Tensor) -> torch.Tensor:
    """int32 packed words -> int64 holding the unsigned word values."""
    return words.to(torch.int64) & M32


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (32 for 0)."""
    _, e = torch.frexp(v.to(torch.float64))
    return torch.where(v == 0, 32, 32 - e.to(torch.int64))


def top64(w: torch.Tensor, pos: torch.Tensor):
    """The 64 stream bits at ``pos`` as (high, low) 32-bit halves."""
    # the last 16 words are zero guards, so clamping the word index into
    # them reads the zeros that lie past the end of the stream
    i = torch.clamp(pos >> 5, max=w.shape[0] - 3)
    r = pos & 31
    a, b, c = w[i], w[i + 1], w[i + 2]
    hi = ((a << r) | (b >> (32 - r))) & M32
    lo = ((b << r) | (c >> (32 - r))) & M32
    return hi, lo


def bits(w: torch.Tensor, pos: torch.Tensor, nb: torch.Tensor):
    """``nb`` (0..32) bits at ``pos`` as int64."""
    hi, _ = top64(w, pos)
    return torch.where(nb > 0, hi >> torch.clamp(32 - nb, 0, 32), 0)


def read_code(w: torch.Tensor, pos: torch.Tensor, kind: torch.Tensor,
              zk: int, kinds=(K_DELTA, K_GAMMA, K_UNARY, K_ZETA)):
    """One code per lane: (value, advance, error bits), all int64.

    Lanes with ``kind == K_NONE`` read nothing (value 0, advance 0, no
    error).  ``kinds`` limits the work to the kinds that can occur."""
    zero = torch.zeros_like(pos)
    active = kind != K_NONE
    hi, lo = top64(w, pos)
    empty = active & (hi == 0) & (lo == 0)
    err = torch.where(empty, E_UNARY, zero)
    u = torch.where(hi != 0, _clz32(hi), 32 + _clz32(lo))
    u = torch.where(empty | ~active, 0, u)
    val, adv = zero, zero
    if K_UNARY in kinds:
        m = kind == K_UNARY
        val = torch.where(m, u, val)
        adv = torch.where(m, u + 1, adv)
    if K_GAMMA in kinds or K_DELTA in kinds:
        m = (kind == K_GAMMA) | (kind == K_DELTA)
        wide = m & (u > 31)
        err = err | torch.where(wide, E_WIDTH, 0)
        um = torch.where(m & ~wide, u, 0)
        g = ((1 << um) | bits(w, pos + um + 1, um)) - 1
        adv_g = 2 * um + 1
        if K_GAMMA in kinds:
            mg = kind == K_GAMMA
            val = torch.where(mg, g, val)
            adv = torch.where(mg, adv_g, adv)
        if K_DELTA in kinds:
            md = (kind == K_DELTA) & ~wide
            wide_e = md & (g > 31)
            err = err | torch.where(wide_e, E_WIDTH, 0)
            eb = torch.where(md & ~wide_e, g, 0)
            dv = ((1 << eb) | bits(w, pos + adv_g, eb)) - 1
            val = torch.where(md, dv, val)
            adv = torch.where(md, adv_g + eb, adv)
    if K_ZETA in kinds:
        m = kind == K_ZETA
        l1 = u * zk + (zk - 1)
        wide = m & (l1 > 32)
        err = err | torch.where(wide, E_WIDTH, 0)
        l1 = torch.where(m & ~wide, l1, 0)
        mm = bits(w, pos + u + 1, l1)
        left = 1 << torch.where(m & ~wide, u * zk, 0)
        short = mm < left
        eb = bits(w, pos + u + 1 + l1, torch.where(short, 0, 1) * m)
        zv = torch.where(short, mm + left - 1, (mm << 1) + eb - 1)
        val = torch.where(m, zv, val)
        adv = torch.where(m, u + 1 + l1 + torch.where(short, 0, 1), adv)
    bad = err != 0
    return (torch.where(bad, 0, val), torch.where(bad, 0, adv), err)
