"""Scalar MSB-first bit streams and instantaneous codes.

The port's own copy of ``webgraph_tpu/ops/bitio.py``: a dsiutils-compatible
implementation of the bit-stream discipline of the BVGraph format (unary,
Elias gamma/delta, Boldi-Vigna zeta_k, Golomb and base-8 "nibble" codes,
with the signed-to-natural zig-zag map int2nat).

Bit order: MSB-first within each byte -- bit 0 of the stream is the most
significant bit of byte 0.  (EFGraph uses a different, LSB-first longword
discipline; see ``ops/longword.py``.)

These scalar readers and writers are host code: the oracle of the encoder
(``codecs/bvgraph.py`` ``_Encoder``) and the random-access decoder.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BitReader",
    "BitWriter",
    "CountingBitWriter",
    "int2nat",
    "nat2int",
]


def int2nat(x: int) -> int:
    """Zig-zag map of a signed integer to a natural number: 0,-1,1,-2,... -> 0,1,2,3,..."""
    return (x << 1) ^ (x >> 63) if x < 0 else x << 1


def nat2int(z: int) -> int:
    """Inverse of int2nat."""
    return (z >> 1) ^ -(z & 1)


class BitReader:
    """MSB-first bit reader over a byte buffer.

    Backed by a big-endian uint64 word view so that ``read_bits`` touches at
    most two words.  All values are Python ints (the format requires 64-bit
    node ids — "big" semantics).
    """

    __slots__ = ("_words", "_nbits", "pos")

    def __init__(self, data):
        if isinstance(data, (bytes, bytearray, memoryview)):
            buf = np.frombuffer(bytes(data), dtype=np.uint8)
        else:
            buf = np.asarray(data, dtype=np.uint8)
        self._nbits = len(buf) * 8
        pad = (-len(buf)) % 8
        if pad:
            buf = np.concatenate([buf, np.zeros(pad + 8, dtype=np.uint8)])
        else:
            buf = np.concatenate([buf, np.zeros(8, dtype=np.uint8)])
        # big-endian words: stream bit i == bit (63 - i % 64) of word i // 64
        self._words = buf.view(">u8").astype(np.uint64)
        self.pos = 0

    # -- positioning ------------------------------------------------------

    def position(self, bitpos: int) -> None:
        self.pos = bitpos

    def tell(self) -> int:
        return self.pos

    # -- primitive reads --------------------------------------------------

    def read_bits(self, n: int) -> int:
        """Read the next ``n`` (0..64) bits as an unsigned integer, MSB first."""
        if n == 0:
            return 0
        pos = self.pos
        w, o = pos >> 6, pos & 63
        words = self._words
        v = (int(words[w]) << o) & 0xFFFFFFFFFFFFFFFF
        if o + n > 64:
            v |= int(words[w + 1]) >> (64 - o)
        self.pos = pos + n
        return v >> (64 - n)

    def read_unary(self) -> int:
        """Count zeroes up to (and consuming) the next one bit."""
        pos = self.pos
        words = self._words
        w, o = pos >> 6, pos & 63
        x = (int(words[w]) << o) & 0xFFFFFFFFFFFFFFFF
        count = 0
        while x == 0:
            count += 64 - o
            w += 1
            o = 0
            if w >= len(words):
                raise EOFError("unary code ran off the end of the stream")
            x = int(words[w])
        z = 64 - x.bit_length()  # leading zeroes of the 64-bit window
        count += z
        self.pos = pos + count + 1
        return count

    # -- instantaneous codes ---------------------------------------------

    def read_gamma(self) -> int:
        u = self.read_unary()
        if u == 0:
            return 0
        return ((1 << u) | self.read_bits(u)) - 1

    def read_delta(self) -> int:
        b = self.read_gamma()
        if b == 0:
            return 0
        return ((1 << b) | self.read_bits(b)) - 1

    def read_zeta(self, k: int) -> int:
        h = self.read_unary()
        left = 1 << (h * k)
        m = self.read_bits(h * k + k - 1)
        if m < left:
            return m + left - 1
        return (m << 1) + self.read_bits(1) - 1

    def read_minimal_binary(self, b: int) -> int:
        """Minimal binary (truncated) code for a value in [0, b)."""
        s = b.bit_length() - 1  # floor(log2 b)
        m = (1 << (s + 1)) - b
        v = self.read_bits(s)
        if v < m:
            return v
        return (v << 1) + self.read_bits(1) - m

    def read_golomb(self, b: int) -> int:
        if b == 0:
            return 0
        q = self.read_unary()
        return q * b + self.read_minimal_binary(b)

    def read_nibble(self) -> int:
        acc = 0
        while True:
            nib = self.read_bits(4)
            acc = (acc << 3) | (nib & 7)
            if nib & 8:
                return acc


class BitWriter:
    """MSB-first bit writer mirroring BitReader."""

    __slots__ = ("_out", "_buf", "_fill")

    def __init__(self):
        self._out = bytearray()
        self._buf = 0  # bit accumulator, MSB-first, _fill bits valid
        self._fill = 0

    # -- state ------------------------------------------------------------

    @property
    def written_bits(self) -> int:
        return len(self._out) * 8 + self._fill

    def to_bytes(self) -> bytes:
        """Flush (zero-padding the final byte) and return the stream."""
        out = bytearray(self._out)
        if self._fill:  # _fill is always < 8 between calls
            out.append((self._buf << (8 - self._fill)) & 0xFF)
        return bytes(out)

    # -- primitive writes -------------------------------------------------

    def write_bits(self, value: int, n: int) -> int:
        if n == 0:
            return 0
        assert 0 <= value < (1 << n), (value, n)
        self._buf = (self._buf << n) | value
        self._fill += n
        while self._fill >= 8:
            self._fill -= 8
            self._out.append((self._buf >> self._fill) & 0xFF)
        self._buf &= (1 << self._fill) - 1
        return n

    def write_unary(self, x: int) -> int:
        n = x + 1
        if x >= 64:
            # emit whole zero bytes directly once the accumulator is aligned
            head = (8 - self._fill) % 8
            x -= head
            self.write_bits(0, head)
            self._out += b"\x00" * (x >> 3)
            x &= 7
        self.write_bits(1, x + 1)
        return n

    # -- instantaneous codes ---------------------------------------------

    def write_gamma(self, x: int) -> int:
        z = x + 1
        b = z.bit_length() - 1
        return self.write_unary(b) + self.write_bits(z - (1 << b), b)

    def write_delta(self, x: int) -> int:
        z = x + 1
        b = z.bit_length() - 1
        return self.write_gamma(b) + self.write_bits(z - (1 << b), b)

    def write_zeta(self, x: int, k: int) -> int:
        z = x + 1
        h = (z.bit_length() - 1) // k
        left = 1 << (h * k)
        t = self.write_unary(h)
        if z - left < left:
            return t + self.write_bits(z - left, h * k + k - 1)
        return t + self.write_bits(z, h * k + k)

    def write_minimal_binary(self, x: int, b: int) -> int:
        s = b.bit_length() - 1
        m = (1 << (s + 1)) - b
        if x < m:
            return self.write_bits(x, s)
        return self.write_bits(x + m, s + 1)

    def write_golomb(self, x: int, b: int) -> int:
        if b == 0:
            return 0
        t = self.write_unary(x // b)
        return t + self.write_minimal_binary(x % b, b)

    def write_nibble(self, x: int) -> int:
        if x == 0:
            return self.write_bits(8, 4)
        h = (x.bit_length() - 1) // 3
        n = h + 1
        while h >= 0:
            g = (x >> (h * 3)) & 7
            self.write_bits(g | 8 if h == 0 else g, 4)
            h -= 1
        return n * 4


class CountingBitWriter(BitWriter):
    """A bit writer that only counts bits (the encoder's sizing pass).

    Mirrors the reference's OutputBitStream-over-NullOutputStream used for
    greedy reference-candidate sizing (BVGraph.java:2168, :2259).
    """

    __slots__ = ("_bits",)

    def __init__(self):
        self._bits = 0

    @property
    def written_bits(self) -> int:
        return self._bits

    def write_bits(self, value: int, n: int) -> int:
        self._bits += n
        return n

    def write_unary(self, x: int) -> int:
        self._bits += x + 1
        return x + 1
