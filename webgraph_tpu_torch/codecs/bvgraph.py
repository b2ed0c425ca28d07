"""BVGraph on disk: load, store, scan, and decode a basename to a device.

The port's own copy of the host file layer of ``webgraph_tpu/codecs/
bvgraph.py`` (format spec: reference BVGraph.java:123-233; decode semantics
:995-1097; encode semantics :1977-2328; properties surface :2490-2567).
Per node x the stream holds:

1. outdegree d (gamma by default); if d == 0 the entry ends;
2. if windowSize > 0, a reference r in [0, windowSize] (unary by default);
   if r > 0, a block count b (gamma) and b copy-blocks (gamma; alternating
   copy/skip run lengths over the successor list of node x - r; blocks after
   the first are stored decremented by one; if b is even the tail of the
   reference list is implicitly copied);
3. if minIntervalLength != 0, an interval count (gamma) and per interval its
   left extreme (first: int2nat(left0 - x) gamma; later: gap - 1 gamma) and
   length - minIntervalLength (gamma);
4. residuals (zeta_k by default): int2nat(res0 - x), then gaps - 1.

Host pieces: ``load`` (the stream as an array or a memmap, the offsets from
a fresh ``.obl`` or from the ``.offsets`` gap stream), random access and
sequential scans (the scalar oracle), the sliced native scan
``iter_csr_slices``, and ``store`` (the native encoder, its streaming form
for sequential sources, the ``"python"`` oracle ``_Encoder``, or the device
encoder of ``ops/vencode.py`` with ``backend="cuda"``).

The device entry :meth:`BVGraph.to_device` takes the files to a
``CSRGraph``: a cold ``plan_kernel_decode`` -> ``resolve_halos`` ->
``decode_to_csr`` (the hand-written kernels B1 and B2), or, outside the
kernel's envelope, the native sequential decoder, uploaded.  The result's
``report`` names the route taken and times each stage.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from ..core.graph import (CSRGraph, ImmutableGraph, host_csr, host_lists,
                          register_graph_class, sync)
from ..device import require_cuda
from ..ops.bitio import BitReader, BitWriter, CountingBitWriter, int2nat, nat2int
from ..ops.csr import decode_to_csr
from ..ops.ef_index import EliasFanoMonotoneList, build_ef
from ..ops.kplan import plan_kernel_decode
from ..ops.resolve import resolve_halos
from ..settings import BVGraphSettings, CompressionFlags
from ..settings import CompressionFlags as _C
from ..utils import properties as javaprops
from ..utils.trace import span

__all__ = ["BVGraph", "BVGraphSettings", "CompressionFlags"]

GRAPH_EXTENSION = ".graph"
OFFSETS_EXTENSION = ".offsets"
OUTDEGREES_EXTENSION = ".outdegrees"
OFFSETS_BIG_LIST_EXTENSION = ".obl"
PROPERTIES_EXTENSION = ".properties"
BVGRAPH_VERSION = 0

NO_INTERVALS = 0
# arcs a streaming store buffers before it pushes them to the encoder
_STREAM_SLICE_ARCS = 8 << 20


def _apply_copy_blocks(ref_list: np.ndarray, blocks: List[int]) -> np.ndarray:
    """Masked copy of a reference list by alternating copy/skip run lengths.

    Semantics of MaskedLongIterator.java:38: blocks alternate keep/skip
    starting with keep; the tail beyond the blocks is kept iff the number of
    blocks is even.
    """
    if not blocks:
        return ref_list
    keep = np.zeros(len(ref_list), dtype=bool)
    pos = 0
    for i, b in enumerate(blocks):
        if i % 2 == 0:
            keep[pos:pos + b] = True
        pos += b
    if len(blocks) % 2 == 0:
        keep[pos:] = True
    return ref_list[keep]


@dataclass
class _NodeEntry:
    """Parsed wire data of one node's entry (before reference resolution)."""

    outdegree: int
    reference: int
    blocks: List[int]
    interval_left: np.ndarray
    interval_len: np.ndarray
    residuals: np.ndarray
    copied: int  # number of successors copied from the reference list


@register_graph_class(
    "it.unimi.dsi.big.webgraph.BVGraph",
    "it.unimi.dsi.webgraph.BVGraph",
)
class BVGraph(ImmutableGraph):
    """A BVGraph loaded from ``basename.graph`` + ``.offsets`` +
    ``.properties``.

    The bit stream is a numpy uint8 array (a memmap in mode "mapped");
    the offsets an int64[n + 1] array of bit positions, or a packed
    ``EliasFanoMonotoneList`` (the analogue of the reference's
    EliasFanoMonotoneLongBigList index, BVGraph.java:1556-1558).
    """

    def __init__(self, data: np.ndarray, n: int, m: int,
                 settings: BVGraphSettings,
                 offsets=None,
                 properties: Optional[Dict[str, str]] = None,
                 basename: Optional[str] = None):
        self.data = data
        self._n = n
        self._m = m
        self.settings = settings
        self.offsets = offsets  # int64[n + 1] bit positions, EF list or None
        self.properties = properties or {}
        self.basename = basename
        self._reader = BitReader(data)

    # -- loading ----------------------------------------------------------

    @classmethod
    def load(cls, basename: str, mode: str = "standard",
             offsets: str = "array") -> "BVGraph":
        """Load ``basename.{graph,offsets,properties}``.

        ``mode``: "standard" reads the stream into memory, "mapped"
        memory-maps it, "offline"/"once"/"sequential" load no offsets.
        ``offsets``: "array" materialises the index as int64[n+1]; "ef"
        keeps it as a packed ``EliasFanoMonotoneList`` (~4x smaller).  A
        fresh ``basename.obl`` cache is used when present.
        """
        props = javaprops.load(basename + PROPERTIES_EXTENSION)
        version = int(props.get("version", "0"))
        if version > BVGRAPH_VERSION:
            raise IOError(f"Unsupported BVGraph version {version}")
        n = int(props["nodes"])
        m = int(props["arcs"])
        settings = BVGraphSettings.from_flags_string(
            props.get("compressionflags", ""))
        settings.window_size = int(props.get("windowsize", settings.window_size))
        settings.max_ref_count = int(props.get("maxrefcount", settings.max_ref_count))
        settings.min_interval_length = int(
            props.get("minintervallength", settings.min_interval_length))
        if "zetak" in props:
            settings.zeta_k = int(props["zetak"])

        if mode == "mapped":
            data = np.memmap(basename + GRAPH_EXTENSION, dtype=np.uint8, mode="r")
        else:
            data = np.fromfile(basename + GRAPH_EXTENSION, dtype=np.uint8)

        g = cls(data, n, m, settings, properties=props, basename=basename)
        if mode not in ("offline", "once", "sequential"):
            g.offsets = g._load_offsets_cached(basename, offsets)
        return g

    def _load_offsets_cached(self, basename: str, rep: str = "array"):
        """Offsets index, preferring a fresh ``.obl`` Elias-Fano cache
        (BVGraph.java:1545-1555: trusted only when newer than .offsets)."""
        obl = basename + OFFSETS_BIG_LIST_EXTENSION
        offs = basename + OFFSETS_EXTENSION
        if os.path.exists(obl) and (not os.path.exists(offs)
                                    or os.path.getmtime(obl)
                                    >= os.path.getmtime(offs)):
            try:
                ef = EliasFanoMonotoneList.load(obl)
                if len(ef) != self._n + 1:
                    raise IOError(f"{obl}: stale cache ({len(ef)} entries "
                                  f"for {self._n} nodes)")
                return ef if rep == "ef" else ef.to_array()
            except IOError:
                # a foreign (e.g. Java-serialised, BVGraph.java:1545-1555)
                # or stale cache: the cache is derived data, so the
                # .offsets stream stands in for it when present
                if not os.path.exists(offs):
                    raise
        arr = self._load_offsets(basename)
        return build_ef(arr) if rep == "ef" else arr

    def write_offsets_cache(self, basename: Optional[str] = None) -> str:
        """Write the ``.obl`` Elias-Fano offsets cache (BVGraph.main -L)."""
        base = basename or self.basename
        path = base + OFFSETS_BIG_LIST_EXTENSION
        ef = (self.offsets if isinstance(self.offsets, EliasFanoMonotoneList)
              else build_ef(np.asarray(self.offsets)))
        ef.dump(path)
        return path

    def _load_offsets(self, basename: str) -> np.ndarray:
        """Decode the offsets gap stream (n+1 gamma/delta gaps with a leading
        zero, BVGraph.java:869-898) into absolute bit positions: natively
        for gamma and delta, with ``BitReader`` otherwise."""
        raw = np.fromfile(basename + OFFSETS_EXTENSION, dtype=np.uint8)
        if self.settings.offset_coding in (_C.GAMMA, _C.DELTA):
            return _native.decode_offset_stream(raw, self._n,
                                                self.settings.offset_coding)
        r = BitReader(raw)
        read = self.settings.read_offset
        out = np.empty(self._n + 1, dtype=np.int64)
        acc = 0
        for i in range(self._n + 1):
            acc += read(r)
            out[i] = acc
        return out

    def offsets_array(self) -> np.ndarray:
        """The offsets index as int64[n + 1] (whatever its form)."""
        if self.offsets is None:
            raise RuntimeError("no offsets: load with mode='standard' or "
                               "'mapped'")
        if isinstance(self.offsets, EliasFanoMonotoneList):
            return self.offsets.to_array()
        return np.asarray(self.offsets, dtype=np.int64)

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

    def outdegree(self, x: int) -> int:
        r = self._reader
        r.position(int(self.offsets[x]))
        return self.settings.read_outdegree(r)

    # -- decoding ---------------------------------------------------------

    def _parse_entry(self, r: BitReader, x: int,
                     ref_outdegree) -> _NodeEntry:
        """Parse one node entry at the reader's position.

        ``ref_outdegree``: callable giving the outdegree of node ``x - ref``
        (needed to size the implicit tail copy when the block count is even,
        BVGraph.java:1028-1030).
        """
        s = self.settings
        d = s.read_outdegree(r)
        if d == 0:
            return _NodeEntry(0, -1, [], _EMPTY, _EMPTY, _EMPTY, 0)
        ref = s.read_reference(r) if s.window_size > 0 else -1

        blocks: List[int] = []
        copied = 0
        if ref > 0:
            block_count = s.read_block_count(r)
            total = 0
            for i in range(block_count):
                b = s.read_block(r) + (0 if i == 0 else 1)
                blocks.append(b)
                total += b
                if i % 2 == 0:
                    copied += b
            if block_count % 2 == 0:
                copied += ref_outdegree(x - ref) - total
        extra_count = d - copied

        interval_count = 0
        left = lens = _EMPTY
        if extra_count > 0 and s.min_interval_length != NO_INTERVALS:
            interval_count = r.read_gamma()
            if interval_count:
                left = np.empty(interval_count, dtype=np.int64)
                lens = np.empty(interval_count, dtype=np.int64)
                prev = nat2int(r.read_gamma()) + x
                left[0] = prev
                lens[0] = r.read_gamma() + s.min_interval_length
                prev += lens[0]
                extra_count -= lens[0]
                for i in range(1, interval_count):
                    prev = r.read_gamma() + prev + 1
                    left[i] = prev
                    lens[i] = r.read_gamma() + s.min_interval_length
                    prev += lens[i]
                    extra_count -= lens[i]

        residuals = _EMPTY
        if extra_count > 0:
            residuals = np.empty(extra_count, dtype=np.int64)
            prev = x + nat2int(s.read_residual(r))
            residuals[0] = prev
            for i in range(1, extra_count):
                prev += s.read_residual(r) + 1
                residuals[i] = prev
        return _NodeEntry(d, ref, blocks, left, lens, residuals, copied)

    @staticmethod
    def _expand(entry: _NodeEntry, ref_list: Optional[np.ndarray]) -> np.ndarray:
        """Compose the final successor list from parsed parts + reference list."""
        parts = []
        if entry.reference > 0:
            parts.append(_apply_copy_blocks(ref_list, entry.blocks))
        if len(entry.interval_left):
            parts.append(np.concatenate([
                np.arange(l, l + ln, dtype=np.int64)
                for l, ln in zip(entry.interval_left, entry.interval_len)
            ]))
        if len(entry.residuals):
            parts.append(entry.residuals)
        if not parts:
            return _EMPTY
        if len(parts) == 1:
            out = parts[0]
        else:
            out = np.unique(np.concatenate(parts))
        assert len(out) == entry.outdegree, \
            f"decoded {len(out)} successors, expected {entry.outdegree}"
        return out

    def successors(self, x: int) -> np.ndarray:
        """Random-access decode (recursion over the reference chain,
        BVGraph.java:995-1097)."""
        if self.offsets is None:
            raise RuntimeError("random access requires offsets")
        r = BitReader(self.data)
        r.position(int(self.offsets[x]))
        entry = self._parse_entry(r, x, self.outdegree)
        ref_list = None
        if entry.reference > 0:
            ref_list = self.successors(x - entry.reference)
        return self._expand(entry, ref_list)

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        """Sequential scan with a cyclic window of decoded lists
        (BVGraphNodeIterator, BVGraph.java:1100-1245)."""
        s = self.settings
        cyclic = s.window_size + 1
        window: List[Optional[np.ndarray]] = [None] * cyclic
        r = BitReader(self.data)
        if start > 0:
            # Warm up the window by random access, exactly like
            # BVGraphNodeIterator(from) (BVGraph.java:1137-1146).
            if self.offsets is None:
                raise RuntimeError("starting mid-stream requires offsets")
            for i in range(1, min(start + 1, cyclic)):
                window[(start - i) % cyclic] = self.successors(start - i)
            r.position(int(self.offsets[start]))
        for x in range(start, self._n):
            entry = self._parse_entry(
                r, x, lambda y: len(window[y % cyclic]))
            ref_list = (window[(x - entry.reference) % cyclic]
                        if entry.reference > 0 else None)
            succ = self._expand(entry, ref_list)
            window[x % cyclic] = succ
            yield x, succ

    def iter_csr_slices(self, slice_nodes: int = 1 << 22):
        """Sequential decode in bounded memory: yields (x0, x1, csr_off,
        succ) per contiguous node slice, for graphs of any size (the
        BVGraphSlowTest.java:30-97 regime).

        Needs no offsets index: each native range decode reports the bit
        offsets of its trailing halo nodes (``native.bv_decode_range``'s
        tail), which seed the next slice's halo warm-up -- the
        sliding-window discipline of BVGraphNodeIterator
        (BVGraph.java:1100-1245) carried across slices.
        """
        s = self.settings
        W = s.window_size
        halo_n = W * max(s.max_ref_count, 1) if W > 0 else 0
        if slice_nodes <= halo_n:
            raise ValueError(f"slice_nodes must exceed {halo_n}")
        data = np.concatenate([np.ascontiguousarray(self.data,
                                                    dtype=np.uint8),
                               np.zeros(16, dtype=np.uint8)])
        n = self._n
        avg_d = max(1, -(-self._m // max(n, 1)))
        x0 = 0
        p = 0
        start_bit = 0
        hist = np.zeros(0, dtype=np.int64)  # outdegrees of trailing nodes
        while x0 < n:
            x1 = min(x0 + slice_nodes, n)
            init = np.zeros(W, dtype=np.int64)  # init[j] = outdegree(p-1-j)
            for j in range(W):
                y = p - 1 - j
                if x0 - len(hist) <= y < x0 and y >= 0:
                    init[j] = hist[y - (x0 - len(hist))]
            cap = max((x1 - x0 + halo_n) * avg_d * 2, 1 << 16)
            tail_n = halo_n if x1 < n else 0
            while True:
                try:
                    co, su, tail = _native.bv_decode_range(
                        data, s, p, x0, x1, start_bit, init,
                        cap, tail_n=tail_n, padded=True)
                    break
                except RuntimeError as err:
                    if str(err).endswith("-3"):  # buffer too small: grow
                        cap *= 4
                        continue
                    raise
            yield x0, x1, co, su
            outd = np.diff(co)
            hist = np.concatenate([hist, outd])[-(halo_n + W):]
            x0 = x1
            p = max(x1 - halo_n, 0)
            start_bit = int(tail[0]) if tail_n else 0

    def decode_offsets_from_stream(self) -> np.ndarray:
        """Recompute offsets by a full sequential scan (BVGraph.main -O)."""
        s = self.settings
        cyclic = s.window_size + 1
        window: List[Optional[np.ndarray]] = [None] * cyclic
        r = BitReader(self.data)
        out = np.empty(self._n + 1, dtype=np.int64)
        for x in range(self._n):
            out[x] = r.tell()
            entry = self._parse_entry(r, x, lambda y: len(window[y % cyclic]))
            ref_list = (window[(x - entry.reference) % cyclic]
                        if entry.reference > 0 else None)
            window[x % cyclic] = self._expand(entry, ref_list)
        out[self._n] = r.tell()
        return out

    # -- the device entry -------------------------------------------------

    def to_device(self, device=None) -> CSRGraph:
        """The whole graph as a ``CSRGraph`` on ``device``: the GPU when
        None, the CPU only when the caller names it.

        Outdegrees -> a cold ``plan_kernel_decode`` -> ``resolve_halos`` ->
        ``decode_to_csr`` -> ``CSRGraph.from_decoded``: the kernels B1 and
        B2 on a CUDA device, their plain versions on the CPU.  Outside the
        kernel's envelope (Golomb, skewed Golomb or nibble codes, a window
        above 7, node ids from 2^31) the planner returns None and the
        native sequential decoder runs on the host instead, its CSR
        uploaded: the reference's own semantics.  The result's ``report``
        says which ("kernel" or "host"; "empty" for n = 0, which reaches
        neither) and gives the stages' seconds on the host clock, each
        ending in a synchronise.

        The call is the span ``wg.to_device`` and each stage a child span
        (``utils/trace.py``), whose seconds the ``report`` gives:
        ``read_s`` is ``wg.files.read`` (a mapped stream read into memory),
        ``plan_s`` is ``wg.plan`` (bit offsets, outdegrees and the cold
        plan), ``resolve_s`` is ``wg.resolve``, ``decode_to_csr_s`` the rest
        (``wg.decode_to_csr`` and ``wg.from_decoded``); on the host route
        ``host_decode_s`` is ``wg.plan`` and ``wg.host_decode``."""
        dev = require_cuda() if device is None else torch.device(device)
        n, s = self._n, self.settings
        if n == 0:
            g = CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int64),
                         device=dev)
            g.report = dict(format="BVGraph", route="empty")
            return g
        with span("to_device") as whole:
            with span("files.read") as read:
                data = self.data
                if isinstance(data, np.memmap):   # read into memory once
                    data = np.array(data, dtype=np.uint8)
            with span("plan") as planned:
                with span("plan.offsets"):
                    offsets = self.offsets_array()
                with span("plan.outdegrees"):
                    outd = _native.decode_outdegrees(data, offsets,
                                                     s.outdegree_coding)
                plan = plan_kernel_decode(offsets, outd, s, data, device=dev)
                if plan is not None:
                    sync(dev)
            if plan is None:
                with span("host_decode") as host:
                    co, su = _native.bv_decode_all(data, n, self._m, s)
                    g = CSRGraph(co, su, device=dev)
                    sync(dev)
                g.report = dict(format="BVGraph", route="host",
                                read_s=read.seconds,
                                host_decode_s=planned.seconds + host.seconds)
                return g
            with span("resolve") as resolved:
                passes = resolve_halos(plan)
                sync(dev)
            co, succ, filled = decode_to_csr(plan)
            with span("from_decoded"):
                g = CSRGraph.from_decoded(co, succ)
                del plan, succ
                sync(dev)
        g.report = dict(format="BVGraph", route="kernel", read_s=read.seconds,
                        plan_s=planned.seconds, resolve_s=resolved.seconds,
                        resolve_passes=passes,
                        decode_to_csr_s=whole.seconds - read.seconds
                        - planned.seconds - resolved.seconds,
                        fallback_arcs=filled)
        return g

    # -- encoding ---------------------------------------------------------

    @classmethod
    def store(cls, graph, basename: str,
              window_size: int = -1, max_ref_count: int = -1,
              min_interval_length: int = -1, zeta_k: int = -1,
              settings: Optional[BVGraphSettings] = None,
              comment: str = "BVGraph properties",
              backend: str = "auto", num_threads: int = 0,
              device=None, report: Optional[dict] = None) -> Dict[str, str]:
        """Compress ``graph`` to ``basename.{graph,offsets,properties}``.

        ``graph``: a ``CSRGraph`` on any device or any graph with
        ``iter_nodes``.  The encoder follows the reference
        (CompressionThread.call + diffComp, BVGraph.java:1977-2328): greedy
        reference selection over the window by sizing every candidate,
        strict improvement, first minimum wins.

        ``backend``: "native" (or "auto") is the multithreaded C++ encoder
        for a ``CSRGraph``, its arrays brought to the host once as int64
        (per-thread window resets and bit-exact stream concatenation,
        BVGraph.java:2373-2483), and the streaming encoder for other
        graphs; "python" is the single-stream oracle; "cuda" is the device
        encoder (``ops/vencode.py``), single-stream and byte-identical to
        "python", on ``device`` (the card when None; "cpu" runs the same
        torch ops there).  ``num_threads``: 0 = the reference heuristic
        (#cores, at least 100,000 nodes per thread, BVGraph.java:2382-2386).
        ``report``: with "cuda", a dict to fill with the seconds of each
        stage of the encode (each ends in a synchronise) and its chunks.
        """
        s = settings or BVGraphSettings()
        if window_size >= 0:
            s = replace(s, window_size=window_size)
        if max_ref_count >= 0:
            s = replace(s, max_ref_count=max_ref_count)
        if min_interval_length >= 0:
            s = replace(s, min_interval_length=min_interval_length)
        if zeta_k >= 0:
            s = replace(s, zeta_k=zeta_k)
        if backend in ("auto", "native"):
            return cls._store_native(graph, basename, s, comment, num_threads)
        if backend == "cuda":
            return cls._store_cuda(graph, basename, s, comment, device, report)
        if backend != "python":
            raise ValueError(f"unknown backend {backend!r}")

        enc = _Encoder(s)
        graph_w = BitWriter()
        offsets_w = BitWriter()
        bit_offset = 0
        n = 0
        for x, succ in host_lists(graph):
            n = x + 1
            s.write_offset(offsets_w, graph_w.written_bits - bit_offset)
            bit_offset = graph_w.written_bits
            enc.encode_node(graph_w, x, succ)
        s.write_offset(offsets_w, graph_w.written_bits - bit_offset)
        _write(basename + GRAPH_EXTENSION, graph_w.to_bytes())
        _write(basename + OFFSETS_EXTENSION, offsets_w.to_bytes())
        props = enc.build_properties(n, graph_w.written_bits)
        javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
        return props

    @classmethod
    def store_slices(cls, slices, basename: str,
                     settings: Optional[BVGraphSettings] = None,
                     comment: str = "BVGraph properties",
                     progress=None) -> Dict[str, str]:
        """Compress an iterator of CSR slices (csr_off int64[k+1], succ):
        nothing beyond one slice is ever held, and the output is
        byte-identical to a single-stream encode."""
        s = settings or BVGraphSettings()
        enc = _native.StreamEncoder(s)
        for co, su in slices:
            enc.push(co, su)
            if progress is not None:
                progress(enc.nodes, enc.bits)
        return _finish_native(basename, s, comment, enc.nodes, enc.finish())

    @classmethod
    def _store_native(cls, graph, basename: str, s: BVGraphSettings,
                      comment: str, num_threads: int) -> Dict[str, str]:
        """Native encode: threaded from a ``CSRGraph``'s arrays, streamed in
        slices from any other graph -- its blocks of nodes where it has
        ``iter_blocks`` -- (bounded memory, byte-identical to the
        single-stream encode)."""
        if isinstance(graph, CSRGraph):
            csr_off, succ = host_csr(graph)
            n = len(csr_off) - 1
            if num_threads <= 0:
                # the reference heuristic: cores, >= 100k nodes/thread
                # (BVGraph.java:2382-2386)
                num_threads = max(1, min(os.cpu_count() or 1, n // 100_000))
            out = _native.bv_encode(csr_off, succ, s, threads=num_threads)
            del csr_off, succ
            return _finish_native(basename, s, comment, n, out)
        enc = _native.StreamEncoder(s)
        if hasattr(graph, "iter_blocks"):
            for _x, _hi, at, tgt in graph.iter_blocks():
                enc.push(at, tgt)
            return _finish_native(basename, s, comment, enc.nodes,
                                  enc.finish())
        offs = [0]
        bufs = []
        for _x, su in graph.iter_nodes():
            bufs.append(np.asarray(su, dtype=np.int64))
            offs.append(offs[-1] + len(bufs[-1]))
            if offs[-1] >= _STREAM_SLICE_ARCS:
                enc.push(np.asarray(offs, dtype=np.int64), np.concatenate(bufs))
                offs = [0]
                bufs = []
        if len(offs) > 1:
            enc.push(np.asarray(offs, dtype=np.int64),
                     np.concatenate(bufs) if bufs
                     else np.zeros(0, np.int64))
        return _finish_native(basename, s, comment, enc.nodes, enc.finish())

    @classmethod
    def _store_cuda(cls, graph, basename: str, s: BVGraphSettings,
                    comment: str, device, report: Optional[dict]
                    ) -> Dict[str, str]:
        """Device encode (``ops/vencode.py``): chunked cost matrices ->
        one native greedy selection over the cost matrix copied to the
        host -> token packing on the device, bit-exact chunk concatenation
        -> the offsets packed on the device.  A ``CSRGraph`` already on the
        device stays there: only the stream, the cost matrix and the
        offsets come to the host.  Byte-identical to the single-stream
        encoders."""
        from ..ops import vencode
        if not vencode.supported(s):
            raise ValueError("the cuda backend does not support this coding "
                             "combination; use backend='native'")
        dev = require_cuda() if device is None else torch.device(device)
        if isinstance(graph, CSRGraph):
            co, su = graph.offsets.to(dev), graph.succ.to(dev)
        else:
            co_h, su_h = host_csr(graph)
            if len(su_h) and int(su_h.max()) >= 1 << 31:
                raise ValueError("the cuda backend needs int32 node ids; "
                                 "use backend='native' beyond 2^31")
            co = torch.from_numpy(co_h).to(dev)
            su = torch.from_numpy(su_h).to(dev, torch.int32)
        n = co.numel() - 1
        split = {} if report is not None else None
        graph_b, gbits, starts, st = vencode.encode_csr_chunked(
            co, su, s, split=split)
        t0 = time.perf_counter()
        offs_b, _obits = vencode.offsets_stream(starts, gbits, s)
        t1 = time.perf_counter()
        _write(basename + GRAPH_EXTENSION, graph_b)
        _write(basename + OFFSETS_EXTENSION, offs_b)
        props = _properties(s, n, gbits, st)
        javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
        if report is not None:
            report.update(split, offsets_s=t1 - t0,
                          write_s=time.perf_counter() - t1)
        return props

    @classmethod
    def store_labelled(cls, labelled, basename: str,
                       label_basename: Optional[str] = None,
                       settings: Optional[BVGraphSettings] = None,
                       comment: str = "BVGraph properties",
                       backend: str = "auto", device=None,
                       report: Optional[dict] = None):
        """Labelled store (BVGraph.storeLabelled, BVGraph.java:1735-1853):
        the compressed graph and its offsets under ``basename``, the
        ``.labels`` stream, ``.labeloffsets`` and their properties under
        ``label_basename`` (``basename + "-labelled"`` when None), the
        latter naming ``os.path.basename(basename)`` as the underlying
        graph.  Byte-identical to the JAX package's fused single-pass store
        in every backend (the graph single-stream, as the reference's
        fused pass writes it).

        ``backend``: "python" is that fused pass itself -- one scan of any
        labelled source with ``iter_labelled`` (sequential-only ones too)
        writes the four streams at once, label by label; "auto" and
        "native" run the native single-stream encoder and pack the labels
        with ``ops/labelcodec.py`` on the labels' device; "cuda" runs the
        device encoder (``store(backend="cuda")``) and packs the labels on
        the same device (the card when ``device`` is None), the CSR never
        copied to the host.  A source that is not an ``ArcLabelledGraph``
        is brought to that device (the CPU for "auto"/"native") with its
        ``to_arc_labelled``.  ``report``: a dict to fill with the seconds
        of the graph's encode and of the label pack, and their stages.

        Returns (graph_properties, label_properties)."""
        from ..labelling import graph as lg
        from ..ops import labelcodec

        s = settings or BVGraphSettings()
        if label_basename is None:
            label_basename = basename + "-labelled"
        rep = {} if report is None else report
        if backend == "python":
            props, data, offs = cls._store_labelled_fused(labelled, basename,
                                                          s, comment)
            prototype = labelled.prototype
        elif backend in ("auto", "native", "cuda"):
            if device is not None:
                dev = torch.device(device)
            else:
                dev = require_cuda() if backend == "cuda" else None
            g = lg._as_arc_labelled(labelled, dev or "cpu")
            dev = dev or g.device
            t0 = time.perf_counter()
            if backend == "cuda":
                rep["graph_split"] = {}
                props = cls._store_cuda(g.graph, basename, s, comment, dev,
                                        rep["graph_split"])
            else:
                props = cls._store_native(g.graph, basename, s, comment, 1)
            sync(dev)
            t1 = time.perf_counter()
            rep["labels_split"] = {}
            data, _bits, offs, _ = labelcodec.pack_labels(
                g.values, g.graph.offsets.to(dev), g.prototype,
                split=rep["labels_split"])
            rep.update(graph_s=t1 - t0, labels_s=time.perf_counter() - t1)
            prototype = g.prototype
        else:
            raise ValueError(f"unknown backend {backend!r}")
        lab_props = lg._write_label_files(
            label_basename, data, offs, prototype, os.path.basename(basename),
            "BitStreamArcLabelledImmutableGraph properties")
        return props, lab_props

    @classmethod
    def _store_labelled_fused(cls, labelled, basename: str,
                              s: BVGraphSettings, comment: str):
        """The JAX package's fused pass (``bvgraph.py:852-912``): per node,
        its entry, then its labels, then its gaps in both offset streams.
        Writes the graph files; returns (properties, labels bytes,
        labeloffsets bytes)."""
        enc = _Encoder(s)
        graph_w, offsets_w, lab_w, laboffs_w = (BitWriter() for _ in range(4))
        laboffs_w.write_gamma(0)
        bit_offset = 0
        lab_last = 0
        n = 0
        for x, succ, labs in labelled.iter_labelled():
            n = x + 1
            s.write_offset(offsets_w, graph_w.written_bits - bit_offset)
            bit_offset = graph_w.written_bits
            if isinstance(succ, torch.Tensor):
                succ = succ.cpu()
            enc.encode_node(graph_w, x, np.asarray(succ, dtype=np.int64))
            for lab in labs:
                lab.to_bitstream(lab_w, x)
            laboffs_w.write_gamma(lab_w.written_bits - lab_last)
            lab_last = lab_w.written_bits
        s.write_offset(offsets_w, graph_w.written_bits - bit_offset)
        _write(basename + GRAPH_EXTENSION, graph_w.to_bytes())
        _write(basename + OFFSETS_EXTENSION, offsets_w.to_bytes())
        props = enc.build_properties(n, graph_w.written_bits)
        javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
        return props, lab_w.to_bytes(), laboffs_w.to_bytes()

    def write_outdegrees(self, path: str) -> None:
        """Dump the gamma-coded outdegree stream (BVGraph.main -d)."""
        w = BitWriter()
        for _, succ in self.iter_nodes():
            w.write_gamma(len(succ))
        _write(path, w.to_bytes())


def _write(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _finish_native(basename: str, s: BVGraphSettings, comment: str, n: int,
                   out) -> Dict[str, str]:
    """Write a native encode's streams and its properties (the stats words
    of ``native.STAT_WORDS`` feed ``_Encoder.build_properties``)."""
    graph_b, gbits, offs_b, _obits, st = out
    _write(basename + GRAPH_EXTENSION, graph_b.tobytes())
    _write(basename + OFFSETS_EXTENSION, offs_b.tobytes())
    props = _properties(s, n, gbits, st)
    javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
    return props


def _properties(s: BVGraphSettings, n: int, gbits: int,
                st) -> Dict[str, str]:
    """The properties of an encode from its ``native.STAT_WORDS`` stats
    words (the native and the device encoders' layout)."""
    enc = _Encoder(s)
    enc.tot_links = int(st[0] + st[1] + st[2])
    (enc.copied_arcs, enc.intervalised_arcs, enc.residual_arcs,
     enc.tot_ref, enc.tot_dist, enc.bits_for_outdegrees,
     enc.bits_for_references, enc.bits_for_blocks,
     enc.bits_for_intervals, enc.bits_for_residuals) = map(int, st[:10])
    enc.successor_gap_stats = [int(v) for v in st[10:74]]
    enc.residual_gap_stats = [int(v) for v in st[74:138]]
    return enc.build_properties(n, int(gbits))


_EMPTY = np.zeros(0, dtype=np.int64)


def _intervalize(vals: np.ndarray, min_interval: int):
    """Split a sorted list into maximal runs >= min_interval and residuals
    (BVGraph.java:1595-1618)."""
    left: List[int] = []
    lens: List[int] = []
    residuals: List[int] = []
    vl = len(vals)
    i = 0
    while i < vl:
        j = 0
        if i < vl - 1 and vals[i] + 1 == vals[i + 1]:
            j += 1
            while i + j < vl - 1 and vals[i + j] + 1 == vals[i + j + 1]:
                j += 1
            j += 1
            if j >= min_interval:
                left.append(int(vals[i]))
                lens.append(j)
                i += j - 1
        if j < min_interval:
            residuals.append(int(vals[i]))
        i += 1
    return left, lens, residuals


class _Encoder:
    """Stateful single-stream BVGraph encoder (one CompressionThread)."""

    def __init__(self, settings: BVGraphSettings):
        self.s = settings
        cyclic = settings.window_size + 1
        self.window: List[np.ndarray] = [_EMPTY] * cyclic
        self.window_len = [0] * cyclic
        self.ref_count = [0] * cyclic
        # stats (the properties surface, BVGraph.java:2490-2567)
        self.tot_links = 0
        self.tot_ref = 0
        self.tot_dist = 0
        self.copied_arcs = 0
        self.intervalised_arcs = 0
        self.residual_arcs = 0
        self.bits_for_outdegrees = 0
        self.bits_for_references = 0
        self.bits_for_blocks = 0
        self.bits_for_residuals = 0
        self.bits_for_intervals = 0
        self.successor_gap_stats = [0] * 64
        self.residual_gap_stats = [0] * 64

    # -- per-node ---------------------------------------------------------

    def encode_node(self, obs: BitWriter, x: int, succ: np.ndarray) -> None:
        s = self.s
        cyclic = s.window_size + 1
        curr_index = x % cyclic
        outd = len(succ)
        self.bits_for_outdegrees += s.write_outdegree(obs, outd)
        self.window[curr_index] = succ
        self.window_len[curr_index] = outd
        if outd == 0:
            return
        self._update_bins(x, succ, self.successor_gap_stats)

        best_comp = None
        best_cand = -1
        best_ref = -1
        self.ref_count[curr_index] = -1
        counter = CountingBitWriter()
        for ref in range(cyclic):
            cand = (x - ref + cyclic) % cyclic
            if self.ref_count[cand] < s.max_ref_count and self.window_len[cand] != 0:
                size = self._diff_comp(counter, x, ref, self.window[cand],
                                       self.window_len[cand], succ, False)
                if best_comp is None or size < best_comp:
                    best_comp = size
                    best_cand = cand
                    best_ref = ref
        assert best_cand >= 0
        self.ref_count[curr_index] = self.ref_count[best_cand] + 1
        self._diff_comp(obs, x, best_ref, self.window[best_cand],
                        self.window_len[best_cand], succ, True)
        self.tot_links += outd
        self.tot_ref += self.ref_count[curr_index]
        self.tot_dist += best_ref

    def _diff_comp(self, obs: BitWriter, curr_node: int, ref: int,
                   ref_list: np.ndarray, ref_len: int,
                   curr_list: np.ndarray, for_real: bool) -> int:
        """Differential compression of one list against a window candidate
        (BVGraph.java:1977-2159): two-pointer copy-block construction, then
        reference/blocks/intervals/residuals emission."""
        s = self.s
        written_at_start = obs.written_bits
        if ref == 0:
            ref_len = 0

        curr_len = len(curr_list)
        blocks: List[int] = []
        extras: List[int] = []
        j = k = 0
        curr_block_len = 0
        copying = True
        while j < curr_len and k < ref_len:
            if copying:
                if curr_list[j] > ref_list[k]:
                    blocks.append(curr_block_len)
                    copying = False
                    curr_block_len = 0
                elif curr_list[j] < ref_list[k]:
                    extras.append(int(curr_list[j]))
                    j += 1
                else:
                    j += 1
                    k += 1
                    curr_block_len += 1
                    if for_real:
                        self.copied_arcs += 1
            else:
                if curr_list[j] < ref_list[k]:
                    extras.append(int(curr_list[j]))
                    j += 1
                elif curr_list[j] > ref_list[k]:
                    k += 1
                    curr_block_len += 1
                else:
                    blocks.append(curr_block_len)
                    copying = True
                    curr_block_len = 0
        if copying and k < ref_len:
            blocks.append(curr_block_len)
        while j < curr_len:
            extras.append(int(curr_list[j]))
            j += 1

        if s.window_size > 0:
            t = s.write_reference(obs, ref)
            if for_real:
                self.bits_for_references += t

        if ref != 0:
            t = s.write_block_count(obs, len(blocks))
            if for_real:
                self.bits_for_blocks += t
            for i, b in enumerate(blocks):
                t = s.write_block(obs, b if i == 0 else b - 1)
                if for_real:
                    self.bits_for_blocks += t

        if extras:
            if s.min_interval_length != NO_INTERVALS:
                left, lens, residual = _intervalize(
                    np.asarray(extras, dtype=np.int64), s.min_interval_length)
                t = obs.write_gamma(len(left))
                if for_real:
                    self.bits_for_intervals += t
                prev = 0
                for i in range(len(left)):
                    if i == 0:
                        prev = left[i]
                        t = obs.write_gamma(int2nat(prev - curr_node))
                    else:
                        t = obs.write_gamma(left[i] - prev - 1)
                    if for_real:
                        self.bits_for_intervals += t
                    curr_int_len = lens[i]
                    prev = left[i] + curr_int_len
                    if for_real:
                        self.intervalised_arcs += curr_int_len
                    t = obs.write_gamma(curr_int_len - s.min_interval_length)
                    if for_real:
                        self.bits_for_intervals += t
            else:
                residual = extras

            if residual:
                if for_real:
                    self.residual_arcs += len(residual)
                    self._update_bins(curr_node,
                                      np.asarray(residual, dtype=np.int64),
                                      self.residual_gap_stats)
                prev = residual[0]
                t = s.write_residual(obs, int2nat(prev - curr_node))
                if for_real:
                    self.bits_for_residuals += t
                for i in range(1, len(residual)):
                    if residual[i] == prev:
                        raise ValueError(
                            f"Repeated successor {prev} in list of node {curr_node}")
                    t = s.write_residual(obs, residual[i] - prev - 1)
                    if for_real:
                        self.bits_for_residuals += t
                    prev = residual[i]

        return obs.written_bits - written_at_start

    @staticmethod
    def _msb(x: int) -> int:
        return x.bit_length() - 1

    def _update_bins(self, curr_node: int, vals: np.ndarray, bins) -> None:
        # exp-binned gap stats (BVGraph.java:1861-1865)
        for i in range(len(vals) - 1):
            bins[self._msb(int(vals[i + 1] - vals[i]))] += 1
        msb = self._msb(int2nat(int(vals[0]) - curr_node))
        if msb >= 0:
            bins[msb] += 1

    # -- properties -------------------------------------------------------

    def build_properties(self, n: int, written_bits: int) -> Dict[str, str]:
        s = self.s
        fmt = _java_decimal_format
        tot_links = self.tot_links

        def stirling(v: float) -> float:
            return v * math.log(v) - v + 0.5 * math.log(2 * math.pi * v)

        def per_node(v: float) -> str:
            # Java double division by zero yields NaN/Infinity and
            # DecimalFormat prints it verbatim
            return fmt(v / n) if n else "NaN"

        props: Dict[str, str] = {}
        props["nodes"] = str(n)
        props["arcs"] = str(tot_links)
        props["windowsize"] = str(s.window_size)
        props["maxrefcount"] = str(s.max_ref_count)
        props["minintervallength"] = str(s.min_interval_length)
        if s.residual_coding == _C.ZETA:
            props["zetak"] = str(s.zeta_k)
        props["compressionflags"] = s.flags_string()
        props["avgref"] = per_node(self.tot_ref)
        props["avgdist"] = per_node(self.tot_dist)
        props["copiedarcs"] = str(self.copied_arcs)
        props["intervalisedarcs"] = str(self.intervalised_arcs)
        props["residualarcs"] = str(self.residual_arcs)
        props["bitsperlink"] = fmt(written_bits / max(tot_links, 1))
        try:
            denom = (stirling(float(n) * n) - stirling(tot_links)
                     - stirling(float(n) * n - tot_links))
            props["compratio"] = fmt(written_bits * math.log(2) / denom)
        except (ValueError, ZeroDivisionError):
            # Java's DecimalFormat renders the resulting NaN as-is
            props["compratio"] = "NaN"
        props["bitspernode"] = per_node(written_bits)
        props["avgbitsforoutdegrees"] = per_node(self.bits_for_outdegrees)
        props["avgbitsforreferences"] = per_node(self.bits_for_references)
        props["avgbitsforblocks"] = per_node(self.bits_for_blocks)
        props["avgbitsforresiduals"] = per_node(self.bits_for_residuals)
        props["avgbitsforintervals"] = per_node(self.bits_for_intervals)
        props["bitsforoutdegrees"] = str(self.bits_for_outdegrees)
        props["bitsforreferences"] = str(self.bits_for_references)
        props["bitsforblocks"] = str(self.bits_for_blocks)
        props["bitsforresiduals"] = str(self.bits_for_residuals)
        props["bitsforintervals"] = str(self.bits_for_intervals)
        props["graphclass"] = "it.unimi.dsi.big.webgraph.BVGraph"
        props["version"] = str(BVGRAPH_VERSION)
        for key, stats in (("successor", self.successor_gap_stats),
                           ("residual", self.residual_gap_stats)):
            top = -1
            for l in range(len(stats) - 1, -1, -1):
                if stats[l]:
                    top = l
                    break
            vals = stats[:top + 1]
            props[key + "expstats"] = ",".join(map(str, vals))
            num_gaps = sum(vals)
            tot_gap = sum((3 * (1 << i) - 1) * c for i, c in enumerate(vals))
            tot_log_gap = sum(
                (math.log2(3 * (1 << i) + 1) - 1) * c for i, c in enumerate(vals))
            props[key + "avggap"] = (
                "0" if num_gaps == 0 else f"{tot_gap / (num_gaps * 2):.3f}")
            props[key + "avgloggap"] = (
                "0" if num_gaps == 0 else repr(tot_log_gap / num_gaps))
        return props


def _java_decimal_format(v: float) -> str:
    """Java DecimalFormat 0.### (Locale.US) equivalent."""
    s = f"{v:.3f}".rstrip("0").rstrip(".")
    return s if s else "0"
