"""Elias-Fano monotone list: the offsets index, and word-level select.

The port's own copy of ``webgraph_tpu/ops/ef_index.py``: the analogue of
sux4j's ``EliasFanoMonotoneLongBigList`` that the reference wraps its
offsets in (BVGraph.java:1556-1558) and caches as ``.obl``
(BVGraph.java:1545-1555).  n monotone values with upper bound u are split at
ell = max(0, floor(log2(u/n))) into

- ``lower``: n * ell bits, packed little-endian into uint64 words;
- ``upper``: a bit vector of n ones among n + (u >> ell) bits, the i-th one
  at position i + (value_i >> ell);
- ``rank``: ones-before-word counts (one int64 per upper word), making
  select_1 a searchsorted plus an in-word select.

The host side is vectorised numpy.  The device side is torch ops on the
tensors' own device: ``popcount64``, ``select_in_word`` and ``bits_at`` are
shared with the EF graph decode (``ops/efdecode.py``), and ``device_select``
is the batched get.  Every torch helper works on int64 tensors of any sign
(an int64 holds a uint64 word's bits) and avoids signed overflow: shifts
are torch's (defined for every count), sums stay below 2^63.

Serialisation (``.obl``): the JAX package's little-endian format (magic
WGOBL1), byte for byte; like the reference, a cache is trusted only when
newer than the ``.offsets`` file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["EliasFanoMonotoneList", "build_ef", "device_select",
           "popcount64", "select_in_word", "low_rank", "bits_at"]

_MAGIC = b"WGOBL1\x00\x00"
M32 = 0xFFFFFFFF


def _pack_fields(vals: np.ndarray, ell: int) -> np.ndarray:
    """Pack n ell-bit fields (little-endian bit order) into uint64 words."""
    n = len(vals)
    if ell == 0 or n == 0:
        return np.zeros(1, dtype=np.uint64)
    nbits = n * ell
    words = np.zeros((nbits + 63) // 64 + 1, dtype=np.uint64)
    pos = np.arange(n, dtype=np.int64) * ell
    w = pos >> 6
    sh = (pos & 63).astype(np.uint64)
    v = vals.astype(np.uint64) & np.uint64((1 << ell) - 1)
    np.bitwise_or.at(words, w, v << sh)
    spill = sh > 0
    np.bitwise_or.at(words, w[spill] + 1,
                     v[spill] >> (np.uint64(64) - sh[spill]))
    return words


def _unpack_fields(words: np.ndarray, idx: np.ndarray, ell: int) -> np.ndarray:
    if ell == 0:
        return np.zeros(len(idx), dtype=np.int64)
    pos = idx.astype(np.int64) * ell
    w = pos >> 6
    sh = (pos & 63).astype(np.uint64)
    lo = words[w] >> sh
    hi = np.where(sh > 0, words[w + 1] << (np.uint64(64) - sh), 0)
    mask = np.uint64((1 << ell) - 1)
    return ((lo | hi) & mask).astype(np.int64)


def _select_byte_table() -> np.ndarray:
    """(256, 8) table: position of the k-th set bit in a byte (8 if none)."""
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
    t = np.full((256, 8), 8, dtype=np.uint8)
    rows, cols = np.nonzero(bits)
    k = np.cumsum(bits, axis=1)[rows, cols] - 1
    t[rows, k] = cols
    return t


_SELECT_BYTE = _select_byte_table()


def _select_in_word_np(words: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Position (0..63) of the k-th (0-based) set bit of each uint64."""
    b = words.view(np.uint8).reshape(-1, 8)  # little-endian byte order
    cnt = np.unpackbits(b, axis=1, bitorder="little").reshape(-1, 8, 8).sum(2)
    ccnt = np.zeros((len(words), 8), dtype=np.int64)
    np.cumsum(cnt[:, :7], axis=1, out=ccnt[:, 1:])
    byte_i = (ccnt <= k[:, None]).sum(1) - 1
    rem = (k - ccnt[np.arange(len(words)), byte_i]).astype(np.int64)
    sel = _SELECT_BYTE[b[np.arange(len(words)), byte_i], rem]
    return byte_i * 8 + sel


# -- torch ops on any device ------------------------------------------------


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (its 64 bits as a word), as int64."""
    x = (x & 0x5555555555555555) + ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x & 0x0F0F0F0F0F0F0F0F) + ((x >> 4) & 0x0F0F0F0F0F0F0F0F)
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def select_in_word(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Position (0..63) of the k-th (0-based) set bit of each int64 word;
    ``k`` must be below the word's popcount.  Halves the word three times
    by popcounts, then reads a (256, 8) byte table."""
    lo = x & M32
    c = popcount64(lo)
    go = k >= c
    k = k - torch.where(go, c, 0)
    v = torch.where(go, (x >> 32) & M32, lo)
    base = torch.where(go, 32, 0)
    for sh in (16, 8):
        lo = v & ((1 << sh) - 1)
        c = popcount64(lo)
        go = k >= c
        k = k - torch.where(go, c, 0)
        v = torch.where(go, v >> sh, lo)
        base = base + torch.where(go, sh, 0)
    table = torch.as_tensor(_SELECT_BYTE.reshape(-1).astype(np.int64),
                            device=x.device)
    return base + table[v * 8 + k]


def low_rank(x: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Set bits among the ``sh`` (0..63) lowest of each int64 word."""
    top = popcount64(x << (64 - sh).clamp(max=63))
    return torch.where(sh == 0, 0, top)


def bits_at(w32: torch.Tensor, pos: torch.Tensor, nb) -> torch.Tensor:
    """``nb`` (0..32) bits at stream bit ``pos`` of an LSB-first stream held
    as int32 words (an int64 word array's ``view(torch.int32)`` on a
    little-endian device), as int64.  Reads words pos // 32 and the next,
    so the stream needs one guard word."""
    q = pos >> 5
    a = w32[q].to(torch.int64) & M32
    b = w32[q + 1].to(torch.int64) & M32
    # bit 63 may be set here; the arithmetic shift's fill never reaches
    # the nb <= 32 low bits kept, since pos % 32 + nb <= 63
    v = (a | (b << 32)) >> (pos & 31)
    return v & ((1 << nb) - 1)


@dataclass
class EliasFanoMonotoneList:
    """n monotone int64 values in ~n*(2 + log2(u/n)) bits, random access."""

    n: int
    u: int  # upper bound: every value is <= u
    ell: int
    lower: np.ndarray   # uint64 words, n*ell bits
    upper: np.ndarray   # uint64 words, bit i + (v_i >> ell) set
    rank: np.ndarray    # int64[len(upper)+1]: ones before each word

    def __len__(self) -> int:
        return self.n

    def get_batch(self, idx) -> np.ndarray:
        """Vectorised select: values at (an array of) indices."""
        idx = np.asarray(idx, dtype=np.int64)
        scalar = idx.ndim == 0
        k = idx.reshape(-1)
        if self.n == 0:
            return np.zeros(len(k), dtype=np.int64)
        w = np.searchsorted(self.rank, k, side="right") - 1
        p = _select_in_word_np(self.upper[w], k - self.rank[w])
        hi = (w * 64 + p) - k
        out = (hi << self.ell) | _unpack_fields(self.lower, k, self.ell)
        return out[0] if scalar else out.reshape(idx.shape)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.get_batch(np.arange(*idx.indices(self.n)))
        return self.get_batch(idx)

    def to_array(self) -> np.ndarray:
        return self.get_batch(np.arange(self.n, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.lower.nbytes + self.upper.nbytes + self.rank.nbytes

    # -- serialisation (.obl cache) ---------------------------------------

    def dump(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<qqqqq", self.n, self.u, self.ell,
                                len(self.lower), len(self.upper)))
            f.write(self.lower.tobytes())
            f.write(self.upper.tobytes())
            f.write(self.rank.tobytes())

    @classmethod
    def load(cls, path: str) -> "EliasFanoMonotoneList":
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise IOError(f"{path}: not a WGOBL1 offsets cache")
            head = f.read(40)
            if len(head) != 40:
                raise IOError(f"{path}: truncated WGOBL1 header")
            n, u, ell, nl, nu = struct.unpack("<qqqqq", head)
            body = [f.read(k * 8) for k in (nl, nu, nu + 1)]
        if [len(b) for b in body] != [nl * 8, nu * 8, (nu + 1) * 8]:
            raise IOError(f"{path}: truncated WGOBL1 cache")
        lower, upper = (np.frombuffer(b, dtype=np.uint64) for b in body[:2])
        rank = np.frombuffer(body[2], dtype=np.int64)
        return cls(n, u, ell, lower, upper, rank)

    # -- device view -------------------------------------------------------

    def device_arrays(self, device):
        """(lower int32 words, upper int64 words, rank int64) on ``device``
        for :func:`device_select`; the lower words get a guard word."""
        lower = np.concatenate([self.lower, np.zeros(1, np.uint64)])
        return (torch.from_numpy(lower.view(np.int32)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.upper)
                                 .view(np.int64)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.rank)).to(device))


def build_ef(values: np.ndarray, u: int | None = None
             ) -> EliasFanoMonotoneList:
    """Build from a nondecreasing int64 array (vectorised)."""
    vals = np.asarray(values, dtype=np.int64)
    n = len(vals)
    if u is None:
        u = int(vals[-1]) + 1 if n else 1
    ell = max(0, int(np.floor(np.log2(max(u, 1) / max(n, 1))))) if n else 0
    hi = vals >> ell if ell else vals
    pos = np.arange(n, dtype=np.int64) + hi
    nbits = n + (u >> ell) + 1
    upper = np.zeros((nbits + 63) // 64, dtype=np.uint64)
    np.bitwise_or.at(upper, pos >> 6,
                     np.uint64(1) << (pos & 63).astype(np.uint64))
    byts = upper.view(np.uint8).reshape(-1, 8)
    pcnt = np.unpackbits(byts, axis=1, bitorder="little").reshape(
        len(upper), 64).sum(1).astype(np.int64)
    rank = np.zeros(len(upper) + 1, dtype=np.int64)
    np.cumsum(pcnt, out=rank[1:])
    return EliasFanoMonotoneList(n, u, ell, _pack_fields(vals, ell),
                                 upper, rank)


def device_select(lower32: torch.Tensor, upper: torch.Tensor,
                  rank: torch.Tensor, ell: int, idx) -> torch.Tensor:
    """Batched EF select on ``device_arrays()``: the values at ``idx``, as
    int64 on the arrays' device (``ell`` up to 62)."""
    if ell > 62:
        raise ValueError("device_select supports ell <= 62")
    k = torch.as_tensor(idx, device=upper.device).to(torch.int64)
    w = torch.searchsorted(rank, k, right=True) - 1
    hi = w * 64 + select_in_word(upper[w], k - rank[w]) - k
    pos = k * ell
    if ell <= 32:
        lo = bits_at(lower32, pos, ell)
    else:
        lo = bits_at(lower32, pos, 32) | (bits_at(lower32, pos + 32,
                                                  ell - 32) << 32)
    return (hi << ell) | lo
