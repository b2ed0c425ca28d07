"""EFGraph: the Elias-Fano successor-list codec, on disk and to a device.

The port's own copy of ``webgraph_tpu/codecs/efgraph.py`` (reference
EFGraph.java: format parameters :140-168, Accumulator :416-540, store
:773-849, LongWordBitReader :852-990, EliasFanoSuccessorReader
:1017-1166), plus the device entry :meth:`EFGraph.to_device`.

Per node the stream (LSB-first longwords, ``ops/longword.py``) holds:

1. gamma-coded outdegree d;
2. skip pointers: numberOfPointers(d+1, u, q) entries of pointerSize(d+1, u)
   bits; pointer k is 1 + the (region-relative) position of the (k*2^q)-th
   zero of the upper-bits array;
3. lower bits: (d+1) * l bits, l = max(0, floor(log2(u / (d+1))));
4. upper bits: unary-coded gaps of "one positions"; the i-th one sits at
   position (v_i >> l) + i where v_i is the i-th successor; a sentinel
   value u (the upper bound) terminates every list.

The offsets file is a delta-coded gap stream (n+1 entries, leading 0) in the
MSB-first discipline of BVGraph offsets.  Properties: nodes, arcs,
upperbound, quantum, byteorder, version (EFGraph.java:686-698).

``store`` writes every node at once with numpy: each entry's layout is
closed-form in its outdegree, so the fields are packed in bulk
(:func:`ef_stream`); ``backend="cuda"`` packs the same way with torch ops
on the graph's device (:func:`ef_stream_device`, under the spans
``wg.ef.store`` > ``.layout``, ``.lists``, ``.pointers``, ``.write``);
``backend="python"`` is the per-arc loop of the JAX package, the plain
version the tests hold the bulk writers to.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from ..core.graph import (CSRGraph, ImmutableGraph, host_csr, host_lists,
                          register_graph_class, sync)
from ..device import require_cuda
from ..ops.bitio import BitWriter
from ..ops.longword import LongWordReader, LongWordWriter
from ..ops.vencode import msb64, pack_gaps
from ..settings import CompressionFlags as _C
from ..utils import properties as javaprops
from ..utils.trace import span

__all__ = ["EFGraph", "ef_stream", "ef_stream_device", "lower_bits",
           "pointer_size", "number_of_pointers"]

GRAPH_EXTENSION = ".graph"
OFFSETS_EXTENSION = ".offsets"
PROPERTIES_EXTENSION = ".properties"
EFGRAPH_VERSION = 0
DEFAULT_LOG2_QUANTUM = 8
# nodes of a bulk-store chunk are added until it holds this many arcs
_STORE_CHUNK_ARCS = 1 << 23


def lower_bits(length: int, upper_bound: int) -> int:
    """l = max(0, floor(log2(u/length))) (EFGraph.java:140-142)."""
    if length == 0:
        return 0
    q = upper_bound // length
    return max(0, q.bit_length() - 1)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 0 else 0


def pointer_size(length: int, upper_bound: int) -> int:
    return max(0, _ceil_log2(length + (upper_bound
                                       >> lower_bits(length, upper_bound))))


def number_of_pointers(length: int, upper_bound: int, log2_quantum: int) -> int:
    if length == 0:
        return 0
    return (upper_bound >> lower_bits(length, upper_bound)) >> log2_quantum


class _Accumulator:
    """Per-list Elias-Fano accumulator (EFGraph.java:416-540 semantics):
    the per-arc writer of ``backend="python"``."""

    def __init__(self, log2_quantum: int):
        self.log2_quantum = log2_quantum

    def init(self, length: int, upper_bound: int):
        self.length = length
        self.quantum = 1 << self.log2_quantum
        self.corrected_upper_bound = upper_bound
        corrected_length = length + 1  # with the final sentinel
        self.current_prefix_sum = 0
        self.current_length = 0
        self.last_one_position = -1
        self.l = lower_bits(corrected_length, upper_bound)
        self.pointer_size = pointer_size(corrected_length, upper_bound)
        self.expected_pointers = number_of_pointers(
            corrected_length, upper_bound, self.log2_quantum)
        self.lower: List[Tuple[int, int]] = []     # (value, width)
        self.upper: List[int] = []                 # unary gap values
        self.pointers: List[int] = []

    def add(self, gap: int) -> None:
        if self.current_length != 0 and gap == 0:
            raise ValueError("duplicate successor")
        self.current_prefix_sum += gap
        if self.current_prefix_sum > self.corrected_upper_bound:
            raise ValueError("prefix sum exceeds upper bound")
        if self.l != 0:
            self.lower.append(
                (self.current_prefix_sum & ((1 << self.l) - 1), self.l))
        one_position = (self.current_prefix_sum >> self.l) + self.current_length
        self.upper.append(one_position - self.last_one_position - 1)
        zeroes_before = self.last_one_position - self.current_length + 1
        position = (self.last_one_position
                    + (zeroes_before & -(1 << self.log2_quantum))
                    + self.quantum - zeroes_before)
        while position < one_position:
            self.pointers.append(position + 1)
            position += self.quantum
        self.last_one_position = one_position
        self.current_length += 1

    def dump(self, writer: LongWordWriter) -> int:
        if self.current_length != self.length:
            raise RuntimeError("list length mismatch")
        self.add(self.corrected_upper_bound - self.current_prefix_sum)
        if self.pointer_size > 0 and len(self.pointers) != \
                self.expected_pointers:
            raise RuntimeError(f"{len(self.pointers)} pointers, expected "
                               f"{self.expected_pointers}")
        start = writer.written_bits
        if self.pointer_size > 0:
            for p in self.pointers:
                writer.append(p, self.pointer_size)
        for v, w in self.lower:
            writer.append(v, w)
        for gap in self.upper:
            writer.write_unary(gap)
        return writer.written_bits - start


# -- the bulk writer -----------------------------------------------------------


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Bits of each non-negative int64 below 2^53 (0 for 0), exactly."""
    return np.frexp(np.asarray(v, dtype=np.float64))[1].astype(np.int64)


def _or_by_word(words: np.ndarray, w: np.ndarray, v: np.ndarray) -> None:
    """words[w] |= v for non-decreasing ``w`` whose values within one word
    share no bit: a sum per word, then one OR per word touched."""
    if not len(w):
        return
    first = np.flatnonzero(np.concatenate([[True], w[1:] != w[:-1]]))
    words[w[first]] |= np.add.reduceat(v, first)


def _or_fields_lsb(words: np.ndarray, pos: np.ndarray, val: np.ndarray,
                   width: np.ndarray) -> None:
    """OR fields of ``width`` (0..63) bits into LSB-first uint64 words;
    positions ascending, fields disjoint."""
    w = pos >> 6
    sh = (pos & 63).astype(np.uint64)
    v = val.astype(np.uint64)
    _or_by_word(words, w, v << sh)
    spill = (pos & 63) + width > 64
    _or_by_word(words, w[spill] + 1,
                v[spill] >> (np.uint64(64) - sh[spill]))


def pack_msb_codes(codes: np.ndarray, lengths: np.ndarray
                   ) -> Tuple[bytes, int]:
    """Concatenate codes of ``lengths`` (1..64) bits, each MSB first, into
    an MSB-first byte stream (the discipline of ``ops/bitio.BitWriter``,
    the last byte zero-padded): (bytes, bits)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    pos = np.cumsum(lengths) - lengths
    words = np.zeros(total // 64 + 2, dtype=np.uint64)
    w = pos >> 6
    end = (pos & 63) + lengths
    c = np.asarray(codes, dtype=np.int64).astype(np.uint64)
    fits = end <= 64
    head = np.where(fits, c << (64 - np.minimum(end, 64)).astype(np.uint64),
                    c >> (np.maximum(end, 64) - 64).astype(np.uint64))
    _or_by_word(words, w, head)
    sp = ~fits
    _or_by_word(words, w[sp] + 1,
                c[sp] << (128 - end[sp]).astype(np.uint64))
    return words.astype(">u8").tobytes()[:(total + 7) // 8], total


def delta_codes(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Elias delta codes of non-negative ``x`` below 2^57 as (code, bits),
    the code MSB first: gamma(b) then the b low bits of x + 1."""
    z = np.asarray(x, dtype=np.int64) + 1
    b = _bit_length(z) - 1
    b2 = _bit_length(b + 1) - 1
    return ((b + 1) << b) | (z - (1 << b)), 2 * b2 + 1 + b


def _layout(d: np.ndarray, u: int, log2_quantum: int):
    """Per node with outdegree ``d``: gamma bits, l, pointer size, pointer
    count, and the entry's bits (EFGraph.java:140-168 in closed form)."""
    cl = d + 1
    msb = _bit_length(cl) - 1
    l = np.maximum(_bit_length(u // cl) - 1, 0)
    shifted = u >> l
    psize = _bit_length(cl + shifted - 1)
    npt = np.where(psize > 0, shifted >> log2_quantum, 0)
    gamma = 2 * msb + 1
    entry = gamma + npt * psize + cl * l + shifted + cl
    return msb, l, psize, npt, entry


def ef_stream(co: np.ndarray, su: np.ndarray, upper_bound: int,
              log2_quantum: int):
    """The EFGraph stream of a CSR graph, every node at once.

    Returns (uint64 words as ``LongWordWriter.to_words`` gives them,
    int64[n] entry bits, outdegree bits, successor bits).  Successors must
    be strictly increasing within a list and below ``upper_bound``."""
    co = np.asarray(co, dtype=np.int64)
    su = np.asarray(su, dtype=np.int64)
    n = len(co) - 1
    u = int(upper_bound)
    d = np.diff(co)
    if len(su):
        rows = np.repeat(np.arange(n, dtype=np.int64), d)
        if su.min() < 0 or su.max() >= u:
            raise ValueError(f"successors must lie in [0, {u})")
        if (np.diff(su)[rows[1:] == rows[:-1]] <= 0).any():
            raise ValueError("successor lists must be strictly increasing")
        del rows
    msb, l, psize, npt, entry = _layout(d, u, log2_quantum)
    start = np.cumsum(entry) - entry
    total = int(entry.sum())
    words = np.zeros(total // 64 + 1, dtype=np.uint64)
    gamma = 2 * msb + 1
    # the outdegree: msb zeros, a one, then the msb low bits of d + 1
    _or_fields_lsb(words, start + msb, np.ones(n, np.int64),
                   np.ones(n, np.int64))
    _or_fields_lsb(words, start + msb + 1, (d + 1) - (1 << msb), msb)
    low_base = start + gamma + npt * psize
    up_base = low_base + (d + 1) * l
    for x0, x1 in _chunks(co):
        _store_chunk(words, co, su, d, l, psize, npt, start + gamma,
                     low_base, up_base, u, log2_quantum, x0, x1)
    return words, entry, int(gamma.sum()), total - int(gamma.sum())


def _chunks(co: np.ndarray) -> Iterator[Tuple[int, int]]:
    """Node bounds [x0, x1) of the store's chunks: nodes are added to a
    chunk until it holds ``_STORE_CHUNK_ARCS`` arcs, one node at least."""
    n = len(co) - 1
    x0 = 0
    while x0 < n:
        x1 = int(np.searchsorted(co, co[x0] + _STORE_CHUNK_ARCS,
                                 side="right")) - 1
        x1 = min(max(x1, x0 + 1), n)
        yield x0, x1
        x0 = x1


def _store_chunk(words, co, su, d, l, psize, npt, ptr_base, low_base,
                 up_base, u, log2_quantum, x0, x1) -> None:
    """Pointers, lower and upper bits of nodes [x0, x1)."""
    nn = x1 - x0
    a0, a1 = int(co[x0]), int(co[x1])
    cl = d[x0:x1] + 1
    # each list followed by its sentinel u
    ext_off = co[x0:x1] - a0 + np.arange(nn, dtype=np.int64)
    ext = np.empty(a1 - a0 + nn, dtype=np.int64)
    row = np.repeat(np.arange(nn, dtype=np.int64), cl)
    i = np.arange(len(ext), dtype=np.int64) - ext_off[row]
    last = i == cl[row] - 1
    ext[~last] = su[a0:a1]
    ext[last] = u
    lx = l[x0:x1][row]
    _or_fields_lsb(words, low_base[x0:x1][row] + i * lx,
                   ext & ((1 << lx) - 1), lx)
    _or_fields_lsb(words, up_base[x0:x1][row] + (ext >> lx) + i,
                   np.ones(len(ext), np.int64), np.ones(len(ext), np.int64))
    # pointer k of a list: k * 2^q plus its successors whose upper part
    # is below k * 2^q (one past the (k * 2^q)-th zero)
    pn = np.flatnonzero(npt[x0:x1])
    if not len(pn):
        return
    cnt = npt[x0:x1][pn]
    prow = np.repeat(pn, cnt)
    k = (np.arange(int(cnt.sum()), dtype=np.int64)
         - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1)
    thr = k << log2_quantum
    key = (row << 32) | (ext >> lx)       # ascending: by node, then value
    below = np.searchsorted(key, (prow << 32) | thr) - ext_off[prow]
    ps = psize[x0:x1][prow]
    _or_fields_lsb(words, ptr_base[x0:x1][prow] + (k - 1) * ps, thr + below,
                   ps)


# -- the device writer ---------------------------------------------------------
#
# ``ef_stream`` as torch ops on the graph's device.  The words are int64
# tensors holding the uint64 words' bits; every field goes in by
# ``index_add_``, one add for each word it touches: fields share no bit,
# so the add is the OR and never carries.


def _or_ones(words: torch.Tensor, pos: torch.Tensor) -> None:
    """Set the bits at ``pos`` (each in its own field)."""
    words.index_add_(0, pos >> 6, torch.ones_like(pos) << (pos & 63))


def _or_fields_dev(words: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
                   width: torch.Tensor) -> None:
    """OR fields of ``width`` (0..63) bits, values below 2^width, into
    LSB-first words; fields disjoint."""
    w = pos >> 6
    sh = pos & 63
    words.index_add_(0, w, val << sh)
    spill = torch.nonzero(sh + width > 64).squeeze(1)
    if spill.numel():
        words.index_add_(0, w[spill] + 1, val[spill] >> (64 - sh[spill]))


def _layout_dev(d: torch.Tensor, u: int, log2_quantum: int):
    """``_layout`` of outdegrees ``d`` (an int64 tensor)."""
    cl = d + 1
    msb = msb64(cl)
    l = msb64(u // cl).clamp(min=0)
    shifted = torch.full_like(l, u) >> l
    psize = msb64(cl + shifted - 1) + 1
    npt = torch.where(psize > 0, shifted >> log2_quantum, 0)
    entry = 2 * msb + 1 + npt * psize + cl * l + shifted + cl
    return msb, l, psize, npt, entry


def ef_stream_device(co: torch.Tensor, su: torch.Tensor, upper_bound: int,
                     log2_quantum: int):
    """:func:`ef_stream` on the tensors' device, in the same chunks of
    whole nodes: (int64 words, int64[n] entry bits, outdegree bits,
    successor bits), each equal to what :func:`ef_stream` gives (the words
    as int64 of the same bits).  The upper bound must be below 2^32."""
    u = int(upper_bound)
    if not 0 <= u < 1 << 32:
        raise ValueError("the device store needs an upper bound below 2^32")
    co = co.to(torch.int64)
    dev = co.device
    with span("ef.store.layout"):
        co_h = co.cpu().numpy()
        d = co[1:] - co[:-1]
        msb, l, psize, npt, entry = _layout_dev(d, u, log2_quantum)
        start = torch.cumsum(entry, 0) - entry
        total = int(entry.sum())
        words = torch.zeros(total // 64 + 1, dtype=torch.int64, device=dev)
        # the outdegree: msb zeros, a one, then the msb low bits of d + 1
        _or_ones(words, start + msb)
        _or_fields_dev(words, start + msb + 1, (d + 1) - (1 << msb), msb)
        ptr_base = start + 2 * msb + 1
        low_base = ptr_base + npt * psize
        up_base = low_base + (d + 1) * l
        bits_out = int((2 * msb + 1).sum())
        del start, msb
    for x0, x1 in _chunks(co_h):
        a0, a1 = int(co_h[x0]), int(co_h[x1])
        nn = x1 - x0
        with span("ef.store.lists"):
            cl = d[x0:x1] + 1
            ext_off = co[x0:x1] - a0 + torch.arange(nn, device=dev)
            size = a1 - a0 + nn
            row = torch.repeat_interleave(torch.arange(nn, device=dev), cl,
                                          output_size=size)
            i = torch.arange(size, device=dev) - ext_off[row]
            last = i == cl[row] - 1
            ext = torch.full((size,), u, dtype=torch.int64, device=dev)
            ext[~last] = su[a0:a1].to(torch.int64)
            # each list and its sentinel u strictly increasing, from 0 up
            bad = ((ext[:-1] >= ext[1:]) & ~last[:-1]).any() | (ext < 0).any()
            if bool(bad):
                raise ValueError(f"successor lists must be strictly "
                                 f"increasing and lie in [0, {u})")
            lx = l[x0:x1][row]
            _or_fields_dev(words, low_base[x0:x1][row] + i * lx,
                           ext & ((1 << lx) - 1), lx)
            _or_ones(words, up_base[x0:x1][row] + (ext >> lx) + i)
        with span("ef.store.pointers"):
            # pointer k of a list: k * 2^q plus its successors whose upper
            # part is below k * 2^q (one past the (k * 2^q)-th zero)
            pn = torch.nonzero(npt[x0:x1]).squeeze(1)
            if pn.numel():
                cnt = npt[x0:x1][pn]
                tot = int(cnt.sum())
                prow = torch.repeat_interleave(pn, cnt, output_size=tot)
                k = (torch.arange(tot, device=dev) - torch.repeat_interleave(
                    torch.cumsum(cnt, 0) - cnt, cnt, output_size=tot) + 1)
                thr = k << log2_quantum
                key = (row << 32) | (ext >> lx)   # by node, then value
                below = torch.searchsorted(key, (prow << 32) | thr) \
                    - ext_off[prow]
                ps = psize[x0:x1][prow]
                _or_fields_dev(words, ptr_base[x0:x1][prow] + (k - 1) * ps,
                               thr + below, ps)
    return words, entry, bits_out, total - bits_out


# -- the codec ----------------------------------------------------------------


@register_graph_class(
    "it.unimi.dsi.big.webgraph.EFGraph",
    "it.unimi.dsi.webgraph.EFGraph",
)
class EFGraph(ImmutableGraph):
    """An EFGraph loaded from ``basename.graph``+``.offsets``+``.properties``."""

    def __init__(self, words: np.ndarray, n: int, m: int, upper_bound: int,
                 log2_quantum: int, offsets: Optional[np.ndarray] = None,
                 properties: Optional[Dict[str, str]] = None,
                 basename: Optional[str] = None):
        self.words = words
        self._n = n
        self._m = m
        self.upper_bound = upper_bound
        self.log2_quantum = log2_quantum
        self.offsets = offsets
        self.properties = properties or {}
        self.basename = basename

    # -- loading ----------------------------------------------------------

    @classmethod
    def load(cls, basename: str, mode: str = "standard") -> "EFGraph":
        props = javaprops.load(basename + PROPERTIES_EXTENSION)
        if int(props.get("version", "0")) > EFGRAPH_VERSION:
            raise IOError("unsupported EFGraph version")
        n = int(props["nodes"])
        m = int(props["arcs"])
        upper_bound = int(props.get("upperbound", n))
        quantum = int(props.get("quantum", 1 << DEFAULT_LOG2_QUANTUM))
        log2_quantum = quantum.bit_length() - 1
        byteorder = props.get("byteorder", "LITTLE_ENDIAN")
        dt = "<u8" if "LITTLE" in byteorder else ">u8"
        raw = np.fromfile(basename + GRAPH_EXTENSION, dtype=np.uint8)
        pad = (-len(raw)) % 8
        if pad:
            raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
        words = raw.view(dt).astype(np.uint64)
        g = cls(words, n, m, upper_bound, log2_quantum, properties=props,
                basename=basename)
        if mode not in ("offline", "once", "sequential"):
            g.offsets = g._load_offsets(basename)
        return g

    def _load_offsets(self, basename: str) -> np.ndarray:
        """The delta-coded gap stream, decoded by the native library."""
        raw = np.fromfile(basename + OFFSETS_EXTENSION, dtype=np.uint8)
        return _native.decode_offset_stream(raw, self._n, _C.DELTA)

    # -- core contract ----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        return self._m

    @property
    def random_access(self) -> bool:
        return self.offsets is not None

    def _entry_params(self, d: int):
        cl = d + 1
        l = lower_bits(cl, self.upper_bound)
        psize = pointer_size(cl, self.upper_bound)
        npointers = number_of_pointers(cl, self.upper_bound, self.log2_quantum)
        return cl, l, psize, npointers

    def _reader_at(self, x: int):
        """Position a reader; return (reader, d, l, ptr_base, low_base,
        up_base)."""
        r = LongWordReader(self.words)
        r.position(int(self.offsets[x]))
        d = r.read_gamma()
        cl, l, psize, npointers = self._entry_params(d)
        ptr_base = r.tell()
        low_base = ptr_base + npointers * psize
        up_base = low_base + cl * l
        return r, d, l, ptr_base, low_base, up_base

    def outdegree(self, x: int) -> int:
        r = LongWordReader(self.words)
        r.position(int(self.offsets[x]))
        return r.read_gamma()

    def successors(self, x: int) -> np.ndarray:
        r, d, l, _, low_base, up_base = self._reader_at(x)
        out = np.empty(d, dtype=np.int64)
        # read the d ones of the upper-bits array (the d+1-th is the sentinel)
        r.position(up_base)
        one_pos = -1
        lowr = LongWordReader(self.words)
        for i in range(d):
            one_pos += r.read_unary() + 1
            upper = one_pos - i
            if l:
                lowr.position(low_base + i * l)
                out[i] = (upper << l) | lowr.extract(l)
            else:
                out[i] = upper
        return out

    def successors_from(self, x: int, lower_bound: int) -> np.ndarray:
        """All successors >= lower_bound (the skipTo access path,
        EFGraph.java:1098-1160: a skip pointer jumps over quantum-sized zero
        runs, then a linear one-scan finishes)."""
        r, d, l, ptr_base, low_base, up_base = self._reader_at(x)
        if d == 0:
            return np.zeros(0, dtype=np.int64)
        zeroes_to_skip = max(0, lower_bound) >> l
        start_rel = 0       # resume position within the upper-bits region
        i = 0               # ones before start_rel
        p = zeroes_to_skip >> self.log2_quantum
        if p > 0:
            cl, _, psize, npointers = self._entry_params(d)
            p = min(p, npointers)
            if psize and p > 0:
                pr = LongWordReader(self.words)
                pr.position(ptr_base + (p - 1) * psize)
                pos = pr.extract(psize) - 1  # position of the (p<<q)-th zero
                start_rel = pos + 1
                i = start_rel - (p << self.log2_quantum)  # ones before it
        r.position(up_base + start_rel)
        lowr = LongWordReader(self.words)
        vals: List[int] = []
        emitting = False
        while i < d:
            r.read_unary()
            one_rel = (r.tell() - up_base) - 1
            upper = one_rel - i
            if l:
                lowr.position(low_base + i * l)
                v = (upper << l) | lowr.extract(l)
            else:
                v = upper
            if emitting or v >= lower_bound:
                emitting = True
                vals.append(v)
            i += 1
        return np.asarray(vals, dtype=np.int64)

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        if self.offsets is not None:
            for x in range(start, self._n):
                yield x, self.successors(x)
            return
        # sequential scan without offsets
        r = LongWordReader(self.words)
        r.position(0)
        for x in range(self._n):
            d = r.read_gamma()
            cl, l, psize, npointers = self._entry_params(d)
            base = r.tell()
            low_base = base + npointers * psize
            up_base = low_base + cl * l
            succ = np.empty(d, dtype=np.int64)
            rr = LongWordReader(self.words)
            rr.position(up_base)
            one_pos = -1
            lowr = LongWordReader(self.words)
            for i in range(cl):
                one_pos += rr.read_unary() + 1
                if i < d:
                    upper = one_pos - i
                    if l:
                        lowr.position(low_base + i * l)
                        succ[i] = (upper << l) | lowr.extract(l)
                    else:
                        succ[i] = upper
            r.position(rr.tell())
            if x >= start:
                yield x, succ

    # -- the device entry -------------------------------------------------

    def to_device(self, device=None) -> CSRGraph:
        """The whole graph as a ``CSRGraph`` on ``device`` (the GPU when
        None; the CPU only when named), decoded there by
        ``ops/efdecode.EFDevicePlan``.  The result's ``report`` holds the
        route ("torch") and ``ef_decode_s``."""
        from ..ops.efdecode import EFDevicePlan

        dev = require_cuda() if device is None else torch.device(device)
        if self.offsets is None:
            raise RuntimeError("the device decode needs the offsets: load "
                               "with mode='standard'")
        t0 = time.perf_counter()
        plan = EFDevicePlan(self.words, self.offsets, self.upper_bound,
                            self.log2_quantum, device=dev)
        co, su = plan.decode()
        del plan
        g = CSRGraph(co, su, num_nodes=self._n, device=dev)
        sync(dev)
        g.report = dict(format="EFGraph", route="torch",
                        ef_decode_s=time.perf_counter() - t0)
        return g

    # -- encoding ---------------------------------------------------------

    @classmethod
    def store(cls, graph, basename: str, upper_bound: int = -1,
              log2_quantum: int = DEFAULT_LOG2_QUANTUM,
              byte_order: str = "little",
              comment: str = "EFGraph properties",
              backend: str = "numpy", device=None) -> Dict[str, str]:
        """Write ``graph`` (a ``CSRGraph`` on any device, or any host graph
        with ``iter_nodes``) to ``basename.{graph,offsets,properties}``.
        ``backend``: "numpy" packs every node at once (:func:`ef_stream`),
        "python" is the JAX package's per-arc loop, "cuda" packs on
        ``device`` (:func:`ef_stream_device`; the card when None, "cpu"
        runs the same torch ops there), where a ``CSRGraph`` already on it
        stays; the bytes are equal."""
        n = graph.num_nodes
        if upper_bound < 0:
            upper_bound = n
        if backend == "cuda":
            with span("ef.store"):
                return cls._store_device(graph, basename, upper_bound,
                                         log2_quantum, byte_order, comment,
                                         device)
        if backend == "numpy":
            co, su = host_csr(graph)
            words, entry, bits_out, bits_succ = ef_stream(
                co, su, upper_bound, log2_quantum)
            m = len(su)
            del co, su
            codes, lens = delta_codes(np.concatenate([[0], entry]))
            offs_b, _ = pack_msb_codes(codes, lens)
            del entry, codes, lens
        elif backend == "python":
            words, offs_b, m, bits_out, bits_succ = cls._encode_plain(
                graph, upper_bound, log2_quantum)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        return cls._write(basename, words, offs_b, n, m, upper_bound,
                          log2_quantum, byte_order, comment, bits_out,
                          bits_succ)

    @classmethod
    def _store_device(cls, graph, basename: str, upper_bound: int,
                      log2_quantum: int, byte_order: str, comment: str,
                      device) -> Dict[str, str]:
        """The device pack (:func:`ef_stream_device`) and the offsets
        packed there; only the words and the offsets' bytes come to the
        host."""
        dev = require_cuda() if device is None else torch.device(device)
        if isinstance(graph, CSRGraph):
            co, su = graph.offsets.to(dev), graph.succ.to(dev)
        else:
            co_h, su_h = host_csr(graph)
            co = torch.from_numpy(co_h).to(dev)
            su = torch.from_numpy(su_h).to(dev)
        words, entry, bits_out, bits_succ = ef_stream_device(
            co, su, upper_bound, log2_quantum)
        with span("ef.store.write"):
            offs_b, _ = pack_gaps(torch.cat([entry.new_zeros(1), entry]),
                                  _C.DELTA)
            del entry
            words = words.cpu().numpy().view(np.uint64)
            return cls._write(basename, words, offs_b, graph.num_nodes,
                              su.numel(), upper_bound, log2_quantum,
                              byte_order, comment, bits_out, bits_succ)

    @staticmethod
    def _write(basename: str, words: np.ndarray, offs_b: bytes, n: int,
               m: int, upper_bound: int, log2_quantum: int, byte_order: str,
               comment: str, bits_out: int, bits_succ: int) -> Dict[str, str]:
        """The three files of a packed stream; returns the properties."""
        dt = "<u8" if byte_order == "little" else ">u8"
        with open(basename + GRAPH_EXTENSION, "wb") as f:
            f.write(words.astype(dt).tobytes())
        del words
        with open(basename + OFFSETS_EXTENSION, "wb") as f:
            f.write(offs_b)
        written_bits = os.path.getsize(basename + GRAPH_EXTENSION) * 8

        def fmt(v):
            s = f"{v:.3f}".rstrip("0").rstrip(".")
            return s or "0"

        props: Dict[str, str] = {"nodes": str(n), "arcs": str(m)}
        if upper_bound != n:
            props["upperbound"] = str(upper_bound)
        props["quantum"] = str(1 << log2_quantum)
        props["byteorder"] = ("LITTLE_ENDIAN" if byte_order == "little"
                              else "BIG_ENDIAN")
        props["bitsperlink"] = fmt(written_bits / m) if m else "0"
        props["bitspernode"] = fmt(written_bits / n) if n else "0"
        props["avgbitsforoutdegrees"] = fmt(bits_out / n) if n else "0"
        props["bitsforoutdegrees"] = str(bits_out)
        props["bitsforsuccessors"] = str(bits_succ)
        props["graphclass"] = "it.unimi.dsi.big.webgraph.EFGraph"
        props["version"] = str(EFGRAPH_VERSION)
        javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
        return props

    @staticmethod
    def _encode_plain(graph, upper_bound: int, log2_quantum: int):
        """The per-arc loop: (words, offsets bytes, m, outdegree bits,
        successor bits)."""
        acc = _Accumulator(log2_quantum)
        w = LongWordWriter()
        offsets_w = BitWriter()
        offsets_w.write_delta(0)
        m = 0
        bits_for_outdegrees = 0
        bits_for_successors = 0
        for _x, succ in host_lists(graph):
            d = len(succ)
            m += d
            entry_start = w.written_bits
            bits_for_outdegrees += w.write_gamma(d)
            acc.init(d, upper_bound)
            last = 0
            for s in succ.tolist():
                acc.add(s - last)
                last = s
            bits_for_successors += acc.dump(w)
            offsets_w.write_delta(w.written_bits - entry_start)
        return (w.to_words(), offsets_w.to_bytes(), m, bits_for_outdegrees,
                bits_for_successors)

