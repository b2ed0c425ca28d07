"""LSB-first longword bit streams (the EFGraph stream discipline).

The port's own copy of ``webgraph_tpu/ops/longword.py``.  EFGraph does not
use the MSB-first byte discipline of BVGraph: its stream is a sequence of
64-bit longwords filled LSB-first (stream bit i is bit (i % 64) of word
i // 64), serialized with a configurable byte order (reference
EFGraph.java:294-414 writer, :852-990 reader).  Gamma codes in this
discipline store the unary part as trailing zeros.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LongWordWriter", "LongWordReader"]


class LongWordWriter:
    """LSB-first bit appender producing a uint64 word array."""

    __slots__ = ("words", "_buffer", "_free")

    def __init__(self):
        self.words = []
        self._buffer = 0
        self._free = 64

    @property
    def written_bits(self) -> int:
        return len(self.words) * 64 + (64 - self._free)

    def append(self, value: int, width: int) -> int:
        """Append the ``width`` low bits of ``value``."""
        assert width == 64 or (value >> width) == 0, (value, width)
        self._buffer |= (value << (64 - self._free)) & 0xFFFFFFFFFFFFFFFF
        if width < self._free:
            self._free -= width
        else:
            self.words.append(self._buffer)
            if width == self._free:
                self._buffer = 0
                self._free = 64
            else:
                self._buffer = value >> self._free
                self._free = 64 - width + self._free
        return width

    def append_bits(self, values, total_bits: int) -> int:
        """Append ``total_bits`` bits packed LSB-first in an iterable of words."""
        left = total_bits
        for w in values:
            if left <= 0:
                break
            width = min(left, 64)
            self.append(int(w) & ((1 << width) - 1) if width < 64 else int(w),
                        width)
            left -= width
        return total_bits

    def write_unary(self, x: int) -> int:
        while x >= 64:
            self.append(0, 64)
            x -= 64
        self.append(1 << x, x + 1)
        return x + 1

    def write_non_zero_gamma(self, value: int) -> int:
        assert value > 0
        msb = value.bit_length() - 1
        self.append(1 << msb, msb + 1)
        self.append(value ^ (1 << msb), msb)
        return 2 * msb + 1

    def write_gamma(self, value: int) -> int:
        return self.write_non_zero_gamma(value + 1)

    def to_words(self) -> np.ndarray:
        """Close the stream (flushing the partial word) and return uint64[]."""
        out = list(self.words)
        out.append(self._buffer)  # reference close() always flushes the buffer
        return np.asarray(out, dtype=np.uint64)

    def to_bytes(self, byte_order: str = "little") -> bytes:
        words = self.to_words()
        dt = "<u8" if byte_order == "little" else ">u8"
        return words.astype(dt).tobytes()


class LongWordReader:
    """LSB-first bit reader over a uint64 word array."""

    __slots__ = ("words", "_buffer", "_filled", "_curr")

    def __init__(self, words: np.ndarray):
        self.words = np.ascontiguousarray(words, dtype=np.uint64)
        self._buffer = 0
        self._filled = 0
        self._curr = -1

    def _word(self, i: int) -> int:
        return int(self.words[i]) if i < len(self.words) else 0

    def position(self, bitpos: int) -> None:
        self._curr = bitpos >> 6
        b = bitpos & 63
        self._buffer = self._word(self._curr) >> b
        self._filled = 64 - b

    def tell(self) -> int:
        return self._curr * 64 + 64 - self._filled

    def extract(self, width: int) -> int:
        """Read ``width`` (0..63) bits LSB-first."""
        if width == 0:
            return 0
        if width <= self._filled:
            result = self._buffer & ((1 << width) - 1)
            self._filled -= width
            self._buffer >>= width
            return result
        result = self._buffer
        self._curr += 1
        self._buffer = self._word(self._curr)
        remainder = width - self._filled
        result |= (self._buffer & ((1 << remainder) - 1)) << self._filled
        self._buffer >>= remainder
        self._filled = 64 - remainder
        return result

    def read_unary(self) -> int:
        acc = 0
        while True:
            if self._buffer != 0:
                t = (self._buffer & -self._buffer).bit_length() - 1  # ctz
                self._filled -= t + 1
                self._buffer >>= t + 1
                return t + acc
            acc += self._filled
            self._curr += 1
            self._buffer = self._word(self._curr)
            self._filled = 64

    def read_non_zero_gamma(self) -> int:
        msb = self.read_unary()
        return self.extract(msb) | (1 << msb)

    def read_gamma(self) -> int:
        return self.read_non_zero_gamma() - 1
