"""Label streams on an explicit device: pack and unpack ``.labels`` and
``.labeloffsets``.

Counterpart of the per-arc loops of ``webgraph_tpu/labelling/graph.py``
(``BitStreamArcLabelledGraph.store`` ``:196-213``, ``labels_of``
``:134-142``) and of the fused store's label writes
(``webgraph_tpu/codecs/bvgraph.py:883-891``).  The format
(BitStreamArcLabelledImmutableGraph.java:66-120): per node, the labels of
its arcs in successor order, one MSB-first stream; ``.labeloffsets`` is the
gamma-coded gap stream of each node's bit total, with a leading 0 (n + 1
codes; a node of outdegree 0 writes a gap of 0).

The labels of a graph are tensors aligned with its ``CSRGraph.succ``: an
int64 value per arc for the scalar labels (``FixedWidthIntLabel``,
``GammaCodedIntLabel``), a ragged pair (``counts[m]``, ``entries``) for the
list labels.  Every label is one or more tokens (value, length):

- FixedWidthInt: ``w`` bits of the value;
- GammaCodedInt: the gamma code of the value;
- list labels: the gamma code of the length, then ``w`` bits per entry.

*Pack*: token lengths -> bit positions by one exclusive cumsum -> the
tokens added into 32-bit words with ``vencode._emit`` (tokens share no
bit), in chunks of arcs; each node's bit total is the difference of the
positions at its CSR offsets, and ``.labeloffsets`` is ``pack_gaps`` of
those totals.  *Unpack*: a fixed-width label of arc j sits at bit
``labeloffsets[src(j)] + (j - offsets[src(j)]) * w``, read with an
MSB-first extract on the device; a gamma stream is m gamma codes back to
back, so the port's native offset-stream decoder gives their prefix sums
on the host (one upload); list labels are read by the port's threaded
native decode on the host (one upload; ``unpack_lists_plain``, the
scalar ``BitReader`` per arc, is its plain version).  Every unpack checks
the stream against ``.labeloffsets``: each node's labels must end where the next
node's begin, and the last entry must equal the bits consumed and lie
within the stream; any mismatch raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from ..labelling.labels import (FixedWidthIntLabel, GammaCodedIntLabel,
                                Label, _FixedWidthListLabel)
from ..settings import CompressionFlags as _C
from .bitio import BitReader
from .vencode import (_PAD_WORDS, _Split, _code, _emit, _words_to_bytes,
                      msb64, pack_gaps)

__all__ = ["label_format", "pack_labels", "unpack_labels",
           "gamma_prefix_sums", "unpack_lists_plain"]

_I64 = torch.int64
# arcs per chunk of the pack and of the fixed-width extract
CHUNK_ARCS = 1 << 25


def label_format(prototype: Label) -> Tuple[str, int]:
    """("fixed", w), ("gamma", 0) or ("list", w) of a label prototype."""
    if isinstance(prototype, FixedWidthIntLabel):
        return "fixed", prototype.width
    if isinstance(prototype, GammaCodedIntLabel):
        return "gamma", 0
    if isinstance(prototype, _FixedWidthListLabel):
        return "list", prototype.width
    raise TypeError(f"no stream format for {type(prototype).__name__}")


def _gamma_len(v: torch.Tensor) -> torch.Tensor:
    """Length of the gamma code of each v >= 0 (int64), v + 1 below 2**53
    so that ``msb64`` is exact; anything else raises ``ValueError``."""
    z = v.to(_I64) + 1
    if z.numel() and (bool((z <= 0).any()) or int(z.max()) >= 1 << 53):
        raise ValueError("a gamma-coded value lies outside [0, 2**53 - 1)")
    return 2 * msb64(z) + 1


def _check_width(v: torch.Tensor, w: int, what: str) -> None:
    if v.numel() and (int(v.min()) < 0 or int(v.max()) >= 1 << w):
        bad = v[(v < 0) | (v >= 1 << w)][0]
        raise ValueError(f"{what} out of range: {int(bad)} (width {w})")


def arc_bits(values, kind: str, w: int) -> torch.Tensor:
    """Bits each arc's label takes in the stream, int64 [m], after checking
    every value against its type: a w-bit value below 2**w, a gamma value
    nonnegative, a list entry below 2**w."""
    if kind == "fixed":
        _check_width(values, w, "Value")
        return torch.full_like(values, w, dtype=_I64)
    if kind == "gamma":
        return _gamma_len(values)
    counts, entries = values
    _check_width(entries, w, "List entry")
    return _gamma_len(counts) + w * counts.to(_I64)


def pack_labels(values, offsets: torch.Tensor, prototype: Label,
                chunk_arcs: int = CHUNK_ARCS, split: Optional[dict] = None):
    """The ``.labels`` and ``.labeloffsets`` streams of a labelled CSR, on
    the device of ``offsets`` (the CSR's int64[n + 1]).

    ``values``: int64 [m] for scalar labels, ``(counts[m], entries)`` for
    list labels.  ``split``: a dict to fill with the seconds of the stages
    (each ending in a synchronise).  Returns (labels bytes, labels bits,
    labeloffsets bytes, per-node bit starts int64 [n + 1] on the device)."""
    dev = offsets.device
    kind, w = label_format(prototype)
    tick = _Split(split, dev)
    if kind == "list":
        counts = values[0].to(dev, _I64)
        entries = values[1].to(dev, _I64)
        values = (counts, entries)
        list_off = torch.zeros(counts.numel() + 1, dtype=_I64, device=dev)
        torch.cumsum(counts, 0, out=list_off[1:])
        m = counts.numel()
    else:
        values = values.to(dev, _I64)
        m = values.numel()
    if m != int(offsets[-1]):
        raise ValueError(f"{m} labels for {int(offsets[-1])} arcs")
    lens = arc_bits(values, kind, w)
    at = torch.zeros(m + 1, dtype=_I64, device=dev)
    torch.cumsum(lens, 0, out=at[1:])
    total = int(at[-1])
    starts = at[offsets]
    gaps = torch.zeros_like(starts)
    gaps[1:] = starts[1:] - starts[:-1]
    tick("positions_s")
    out = torch.zeros(_PAD_WORDS + -(-total // 32) + 1, dtype=_I64,
                      device=dev)
    for a in range(0, m, chunk_arcs):
        b = min(a + chunk_arcs, m)
        pos = at[a:b]                  # each arc's first bit
        if kind == "fixed":
            _emit(out, pos, values[a:b], lens[a:b],
                  torch.ones(b - a, dtype=torch.bool, device=dev))
            continue
        head = counts[a:b] if kind == "list" else values[a:b]
        bits, ln = _code(_C.GAMMA, head, 1)
        ok = torch.ones(b - a, dtype=torch.bool, device=dev)
        _emit(out, pos, bits, ln, ok)
        if kind == "list" and w:
            c = counts[a:b]
            e0, e1 = int(list_off[a]), int(list_off[b])
            arc = torch.repeat_interleave(
                torch.arange(b - a, device=dev), c, output_size=e1 - e0)
            k = torch.arange(e0, e1, device=dev) - list_off[a:b][arc]
            _emit(out, pos[arc] + ln[arc] + k * w, entries[e0:e1],
                  torch.full((e1 - e0,), w, dtype=_I64, device=dev),
                  torch.ones(e1 - e0, dtype=torch.bool, device=dev))
    del lens, at
    tick("emit_s")
    data = _words_to_bytes(out, total)
    del out
    tick("to_bytes_s")
    offs_b, _ = pack_gaps(gaps, _C.GAMMA)
    tick("offsets_s")
    return data, total, offs_b, starts


def gamma_prefix_sums(data: np.ndarray, count: int) -> np.ndarray:
    """The prefix sums of the first ``count`` gamma codes of ``data``
    (int64[count]; the port's native offset-stream decoder).  The stream is
    followed by 1-bits, each a code of 0, so a stream cut short decodes
    into that run and never past the buffer; the caller's checks against
    ``.labeloffsets`` then fail."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    pad = np.full((count + 7) // 8 + 16, 0xFF, dtype=np.uint8)
    data = np.concatenate([np.asarray(data, dtype=np.uint8), pad])
    return _native.decode_offset_stream(data, count - 1, _C.GAMMA)


def read_msb(data: torch.Tensor, pos: torch.Tensor, w: int) -> torch.Tensor:
    """The ``w``-bit (w <= 31) MSB-first field at each bit position ``pos``
    of the byte stream ``data`` (uint8 with >= 5 guard bytes): five bytes
    from ``pos >> 3`` make a 40-bit window holding it."""
    b = pos >> 3
    win = torch.zeros_like(pos)
    for i in range(5):
        win = (win << 8) | data[b + i].to(_I64)
    return (win >> (40 - (pos & 7) - w)) & ((1 << w) - 1)


def _mismatch(what: str) -> ValueError:
    return ValueError(f".labels disagrees with .labeloffsets: {what}")


def unpack_labels(data: np.ndarray, label_offsets, offsets: torch.Tensor,
                  prototype: Label, split: Optional[dict] = None):
    """The labels of a stream on the device of ``offsets`` (the CSR's
    int64[n + 1]): int64 [m], or ``(counts[m], entries)`` for list labels.

    ``data``: the ``.labels`` bytes; ``label_offsets``: the decoded
    ``.labeloffsets`` (n + 1 bit positions).  ``split``: a dict to fill
    with the seconds of the stages (each ending in a synchronise): the
    native decode, the upload and the device part."""
    dev = offsets.device
    kind, w = label_format(prototype)
    tick = _Split(split, dev)
    data = np.asarray(data, dtype=np.uint8)
    lo_h = np.asarray(label_offsets, dtype=np.int64)
    m = int(offsets[-1])
    if len(lo_h) != offsets.numel():
        raise _mismatch(f"{len(lo_h)} offsets for {offsets.numel() - 1} "
                        f"nodes")
    if lo_h[-1] > 8 * len(data):
        raise _mismatch(f"the last offset {lo_h[-1]} lies past the "
                        f"{8 * len(data)} bits of the stream")
    if kind == "list":
        return _unpack_lists(data, lo_h, offsets, w, tick)
    lo = torch.from_numpy(lo_h).to(dev)
    if kind == "fixed":
        if not torch.equal(lo, lo[0] + offsets * w):
            raise _mismatch(f"a node's labels do not take {w} bits an arc")
        stream = torch.from_numpy(
            np.concatenate([data, np.zeros(8, np.uint8)])).to(dev)
        tick("upload_s")
        out = torch.empty(m, dtype=_I64, device=dev)
        for a in range(0, m, CHUNK_ARCS):
            b = min(a + CHUNK_ARCS, m)
            pos = lo_h[0] + torch.arange(a, b, device=dev) * w
            out[a:b] = read_msb(stream, pos, w)
        tick("device_s")
        return out
    if lo_h[0] != 0:
        raise _mismatch("the stream does not start at bit 0")
    sums = gamma_prefix_sums(data, m)
    tick("native_s")
    sums_d = torch.from_numpy(sums).to(dev)
    tick("upload_s")
    vals = torch.diff(sums_d, prepend=sums_d.new_zeros(1))
    ends = torch.zeros(m + 1, dtype=_I64, device=dev)
    torch.cumsum(_gamma_len(vals), 0, out=ends[1:])
    if not torch.equal(ends[offsets], lo):
        raise _mismatch("a node's gamma codes do not end at the next "
                        "node's offset")
    tick("device_s")
    return vals


def _unpack_lists(data: np.ndarray, lo: np.ndarray, offsets: torch.Tensor,
                  w: int, tick):
    """List labels: the port's threaded native decode on the host
    (``native.decode_list_labels``: node ranges of equal arc shares, a
    pass of lengths and checks, then one of entries), written into pinned
    buffers when the device is a card, and uploaded once."""
    dev = offsets.device
    keep = []

    def alloc(k: int) -> np.ndarray:
        t = torch.empty(k, dtype=_I64, pin_memory=dev.type == "cuda")
        keep.append(t)
        return t.numpy()

    try:
        _native.decode_list_labels(data, lo, offsets.cpu().numpy(), w,
                                   alloc=alloc)
    except ValueError as e:
        raise _mismatch(str(e)) from None
    tick("native_s")
    counts, entries = (t.to(dev, non_blocking=True) for t in keep)
    tick("upload_s")
    return counts, entries


def unpack_lists_plain(data: np.ndarray, lo: np.ndarray,
                       offsets: torch.Tensor, w: int):
    """The plain version of the list decode: per node and per arc, the
    scalar ``BitReader`` on the host, then one upload.  The tests hold the
    native decode against it; nothing else calls it."""
    dev = offsets.device
    offs = offsets.cpu().numpy()
    r = BitReader(np.asarray(data, dtype=np.uint8))
    counts = np.empty(int(offs[-1]), dtype=np.int64)
    entries = []
    for x in range(len(offs) - 1):
        r.position(int(lo[x]))
        for j in range(int(offs[x]), int(offs[x + 1])):
            c = r.read_gamma()
            counts[j] = c
            entries.extend(r.read_bits(w) for _ in range(c))
        if r.tell() != lo[x + 1]:
            raise _mismatch(f"node {x}'s labels end at bit {r.tell()}, its "
                            f"successor's start at {lo[x + 1]}")
    return (torch.from_numpy(counts).to(dev),
            torch.tensor(entries, dtype=_I64).to(dev))
