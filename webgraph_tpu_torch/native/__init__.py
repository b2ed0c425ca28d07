"""The port's host library: ctypes over ``native/wgnative.cpp``.

The library is built with g++ for the host it runs on, on first use, into
``webgraph_tpu_torch/build/`` (``ops/_build.build_native``); no binary is
committed.  It is the port's own copy of what it needs of the JAX package's
host library, with the same functions and results: the offsets index, the
outdegree scan, the sequential decoder, the batched range decoder, the
header-only reference scan, the checkpoint parse of long lists, the
parallel and streaming encoders, the device encoder's greedy reference
selection, and the arc-pair text parser of scattered-arc ingestion; and,
the port's own, the threaded decode of list-label streams.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = ["decode_offset_stream", "decode_outdegrees",
           "bv_decode_all", "bv_decode_range", "bv_encode", "bv_scan_refs",
           "hub_parse", "bv_fill_ranges", "select_refs", "StreamEncoder",
           "lib_path", "parse_arcs", "parse_arcs_available",
           "decode_list_labels"]

#: stats words returned by bv_encode: copied, intervalised, residual arcs;
#: tot_ref, tot_dist; bits for outdegrees/references/blocks/intervals/
#: residuals; 64 successor-gap bins; 64 residual-gap bins
STAT_WORDS = 10 + 64 + 64

_lib: Optional[ctypes.CDLL] = None
_path: Optional[str] = None


def _load() -> ctypes.CDLL:
    """The library, built on first use; a failed build raises."""
    global _lib, _path
    if _lib is None:
        from ..ops import _build
        path = _build.build_native()
        lib = ctypes.CDLL(path)
        for fn in ("wg_bv_decode_all", "wg_bv_decode_range", "wg_bv_encode",
                   "wg_bv_fill_ranges", "wg_bv_scan_refs", "wg_bv_hub_parse",
                   "wg_enc_push",
                   "wg_enc_finish", "wg_select_refs", "wg_parse_arcs",
                   "wg_list_label_counts", "wg_list_label_entries"):
            getattr(lib, fn).restype = ctypes.c_int64
        lib.wg_enc_new.restype = ctypes.c_void_p
        lib.wg_enc_free.restype = None
        lib.wg_decode_offset_stream.restype = ctypes.c_int
        lib.wg_decode_outdegrees.restype = ctypes.c_int
        lib.wg_buffer_free.restype = None
        _lib, _path = lib, path
    return _lib


def lib_path() -> str:
    """Path of the loaded library (building it first if needed)."""
    _load()
    return _path


def _ptr(a, t=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _padded(data: np.ndarray) -> np.ndarray:
    """Contiguous uint8 copy with 16 zero guard bytes (unaligned loads)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    return np.concatenate([data, np.zeros(16, dtype=np.uint8)])


def _codings(settings, offsets: bool = False) -> np.ndarray:
    c = [settings.outdegree_coding, settings.reference_coding,
         settings.block_count_coding, settings.block_coding,
         settings.residual_coding]
    if offsets:
        c.append(settings.offset_coding)
    return np.asarray(c, dtype=np.int32)


def decode_offset_stream(data: np.ndarray, n: int, coding: int) -> np.ndarray:
    """(n+1)-entry gamma/delta gap stream -> absolute bit offsets."""
    lib = _load()
    data = _padded(data)
    out = np.empty(n + 1, dtype=np.int64)
    rc = lib.wg_decode_offset_stream(
        _ptr(data), ctypes.c_int64(len(data) - 16), ctypes.c_int64(n + 1),
        ctypes.c_int(coding), _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native offset decode failed: {rc}")
    return out


def decode_outdegrees(data: np.ndarray, offsets: np.ndarray,
                      coding: int) -> np.ndarray:
    """Every node's outdegree, read at its bit offset."""
    lib = _load()
    data = _padded(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.int64)
    rc = lib.wg_decode_outdegrees(
        _ptr(data), ctypes.c_int64(len(data) - 16),
        _ptr(offsets, ctypes.c_int64), ctypes.c_int64(n),
        ctypes.c_int(coding), _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native outdegree scan failed: {rc}")
    return out


def bv_decode_all(data: np.ndarray, n: int, m: int, settings) -> tuple:
    """Full sequential decode -> (csr_off int64[n+1], succ int64[m])."""
    lib = _load()
    data = _padded(data)
    csr_off = np.empty(n + 1, dtype=np.int64)
    succ = np.empty(max(m, 1), dtype=np.int64)
    wrote = lib.wg_bv_decode_all(
        _ptr(data), ctypes.c_int64(len(data) - 16), ctypes.c_int64(n),
        ctypes.c_int(settings.window_size),
        ctypes.c_int(settings.min_interval_length),
        ctypes.c_int(settings.zeta_k),
        _ptr(_codings(settings), ctypes.c_int), _ptr(csr_off, ctypes.c_int64),
        _ptr(succ, ctypes.c_int64), ctypes.c_int64(len(succ)))
    if wrote < 0:
        raise RuntimeError(f"native decode failed: {wrote}")
    return csr_off, succ[:wrote]


def bv_decode_range(data: np.ndarray, settings, p: int, x0: int, x1: int,
                    start_bit: int, init_win_outd: np.ndarray,
                    expected_arcs: int, tail_n: int = 0,
                    padded: bool = False):
    """Decode nodes [x0, x1) starting the scan at halo node ``p`` whose bit
    offset is ``start_bit``; ``init_win_outd[j - 1]`` = outdegree(p - j).

    Returns (csr_off int64[x1-x0+1], succ int64[arcs], tail_bits
    int64[tail_n]): tail_bits are the bit offsets of the last tail_n
    parsed nodes, the next slice's halo start of a sequential scan.
    Raises RuntimeError ending in "-3" when ``expected_arcs`` is too small.
    ``padded=True`` promises ``data`` already ends in >= 16 zero guard
    bytes."""
    lib = _load()
    if not padded:
        data = _padded(data)
    nr = x1 - x0
    csr_off = np.empty(nr + 1, dtype=np.int64)
    succ = np.empty(max(expected_arcs, 1), dtype=np.int64)
    win = np.zeros(max(settings.window_size + 1, 1), dtype=np.int64)
    win[1:1 + len(init_win_outd)] = init_win_outd
    tail = np.zeros(max(tail_n, 1), dtype=np.int64)
    wrote = lib.wg_bv_decode_range(
        _ptr(data), ctypes.c_int64(len(data) - 16),
        ctypes.c_int64(p), ctypes.c_int64(x0), ctypes.c_int64(x1),
        ctypes.c_int64(start_bit), _ptr(win, ctypes.c_int64),
        ctypes.c_int(settings.window_size),
        ctypes.c_int(settings.min_interval_length),
        ctypes.c_int(settings.zeta_k), _ptr(_codings(settings), ctypes.c_int),
        _ptr(csr_off, ctypes.c_int64), _ptr(succ, ctypes.c_int64),
        ctypes.c_int64(len(succ)), ctypes.c_int64(tail_n),
        _ptr(tail, ctypes.c_int64))
    if wrote < 0:
        raise RuntimeError(f"native range decode failed: {wrote}")
    return csr_off, succ[:wrote], tail[:tail_n]


def bv_scan_refs(data: np.ndarray, offsets: np.ndarray, settings,
                 threads: int = 0) -> np.ndarray:
    """Header-only scan -> refs int32[n] (0 when no reference): each
    node's outdegree and reference codes at offsets[x], nothing else."""
    lib = _load()
    data = _padded(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    refs = np.zeros(max(n, 1), dtype=np.int32)
    rc = lib.wg_bv_scan_refs(
        _ptr(data), ctypes.c_int64(len(data) - 16),
        _ptr(offsets, ctypes.c_int64), ctypes.c_int64(n),
        ctypes.c_int(settings.window_size), ctypes.c_int(settings.zeta_k),
        _ptr(_codings(settings), ctypes.c_int), _ptr(refs, ctypes.c_int32),
        ctypes.c_int(threads or (os.cpu_count() or 1)))
    if rc < 0:
        raise RuntimeError(f"native ref scan failed: {rc}")
    return refs[:n]


def hub_parse(data: np.ndarray, nodes: np.ndarray, start_bits: np.ndarray,
              outd: np.ndarray, settings, arc_quantum: int,
              bit_quantum: int):
    """Hub-entry header parse + residual checkpoints (wg_bv_hub_parse):
    the plan-time index behind the split of long lists across B1's lanes
    (``ops/kplan.py``).  Returns a dict of per-node counts and flat
    (start,len)/(left,len)/(bit,val,cnt) arrays."""
    lib = _load()
    data = _padded(np.ascontiguousarray(data, dtype=np.uint8))
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    start_bits = np.ascontiguousarray(start_bits, dtype=np.int64)
    outd = np.ascontiguousarray(outd, dtype=np.int64)
    codings = np.asarray([settings.outdegree_coding,
                          settings.reference_coding,
                          settings.block_count_coding,
                          settings.block_coding,
                          settings.residual_coding,
                          settings.offset_coding], dtype=np.int32)
    k = len(nodes)
    ref = np.zeros(k, dtype=np.int64)
    kept_cnt = np.zeros(k, dtype=np.int64)
    int_cnt = np.zeros(k, dtype=np.int64)
    res_cnt = np.zeros(k, dtype=np.int64)
    cp_cnt = np.zeros(k, dtype=np.int64)
    kept_cap, int_cap, cp_cap = 4 * k + 64, 4 * k + 64, 8 * k + 64
    while True:
        kept = np.zeros(kept_cap, dtype=np.int64)
        ints = np.zeros(int_cap, dtype=np.int64)
        cps = np.zeros(cp_cap, dtype=np.int64)
        rc = lib.wg_bv_hub_parse(
            _ptr(data), ctypes.c_int64(len(data) - 16),
            _ptr(nodes, ctypes.c_int64), ctypes.c_int64(k),
            _ptr(start_bits, ctypes.c_int64), _ptr(outd, ctypes.c_int64),
            ctypes.c_int64(arc_quantum), ctypes.c_int64(bit_quantum),
            ctypes.c_int(settings.window_size),
            ctypes.c_int(settings.min_interval_length),
            ctypes.c_int(settings.zeta_k), _ptr(codings, ctypes.c_int),
            _ptr(ref, ctypes.c_int64), _ptr(kept_cnt, ctypes.c_int64),
            _ptr(int_cnt, ctypes.c_int64), _ptr(res_cnt, ctypes.c_int64),
            _ptr(cp_cnt, ctypes.c_int64),
            _ptr(kept, ctypes.c_int64), ctypes.c_int64(kept_cap),
            _ptr(ints, ctypes.c_int64), ctypes.c_int64(int_cap),
            _ptr(cps, ctypes.c_int64), ctypes.c_int64(cp_cap))
        if rc == -3:
            kept_cap *= 4
            int_cap *= 4
            cp_cap *= 4
            continue
        if rc < 0:
            raise RuntimeError(f"hub_parse failed: {rc}")
        break
    return dict(ref=ref, kept_cnt=kept_cnt, int_cnt=int_cnt,
                res_cnt=res_cnt, cp_cnt=cp_cnt,
                kept=kept[:int(kept_cnt.sum()) * 2].reshape(-1, 2),
                ints=ints[:int(int_cnt.sum()) * 2].reshape(-1, 2),
                cps=cps[:int(cp_cnt.sum()) * 3].reshape(-1, 3))


def bv_fill_ranges(data: np.ndarray, settings, p: np.ndarray, x0: np.ndarray,
                   x1: np.ndarray, start_bit: np.ndarray,
                   init_win: np.ndarray, dst: np.ndarray, arcs: np.ndarray,
                   succ: np.ndarray, threads: int = 2,
                   padded: bool = False) -> None:
    """Batched decode of many node ranges into ``succ`` in one call.

    Range i decodes [x0[i], x1[i]) starting the scan at halo node p[i] whose
    bit offset is start_bit[i]; init_win[i, j] = outdegree(p[i]-1-j); writes
    exactly arcs[i] successors at succ[dst[i]:].  ``padded=True`` promises
    ``data`` already ends in >= 16 zero guard bytes."""
    lib = _load()
    if not padded:
        data = _padded(data)
    W = settings.window_size
    nr = len(p)
    i64 = ctypes.c_int64

    def arr(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    p, x0, x1, start_bit, dst, arcs = map(arr, (p, x0, x1, start_bit, dst,
                                                arcs))
    init_win = (arr(init_win).reshape(nr, W) if W
                else np.zeros((nr, 1), dtype=np.int64))
    rc = lib.wg_bv_fill_ranges(
        _ptr(data), i64(len(data) - 16), i64(nr),
        _ptr(p, i64), _ptr(x0, i64), _ptr(x1, i64), _ptr(start_bit, i64),
        _ptr(init_win, i64), ctypes.c_int(W),
        ctypes.c_int(settings.min_interval_length),
        ctypes.c_int(settings.zeta_k), _ptr(_codings(settings), ctypes.c_int),
        _ptr(dst, i64), _ptr(arcs, i64), _ptr(succ, i64),
        ctypes.c_int(threads))
    if rc < 0:
        raise RuntimeError(f"native batched fill failed: {rc}")


def bv_encode(csr_off: np.ndarray, succ: np.ndarray, settings,
              threads: int = 1, node_base: int = 0):
    """Parallel BVGraph encode of CSR arrays.

    Returns (graph_bytes, graph_bits, offsets_bytes, offsets_bits, stats).
    ``threads`` ranges are encoded with a fresh window each, as the
    reference's per-thread ranges (BVGraph.java:2406-2483)."""
    lib = _load()
    csr_off = np.ascontiguousarray(csr_off, dtype=np.int64)
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    n = len(csr_off) - 1
    stats = np.zeros(STAT_WORDS, dtype=np.int64)
    g_ptr = ctypes.POINTER(ctypes.c_uint8)()
    o_ptr = ctypes.POINTER(ctypes.c_uint8)()
    g_bits = ctypes.c_int64()
    o_bits = ctypes.c_int64()
    rc = lib.wg_bv_encode(
        _ptr(csr_off, ctypes.c_int64), _ptr(succ, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int(threads),
        ctypes.c_int(settings.window_size),
        ctypes.c_int(settings.max_ref_count),
        ctypes.c_int(settings.min_interval_length),
        ctypes.c_int(settings.zeta_k),
        _ptr(_codings(settings, offsets=True), ctypes.c_int),
        ctypes.byref(g_ptr), ctypes.byref(g_bits),
        ctypes.byref(o_ptr), ctypes.byref(o_bits),
        _ptr(stats, ctypes.c_int64), ctypes.c_int64(node_base))
    if rc < 0:
        raise RuntimeError(f"native encode failed: {rc}")
    try:
        g_len = (g_bits.value + 7) // 8
        o_len = (o_bits.value + 7) // 8
        graph = np.ctypeslib.as_array(g_ptr, shape=(max(g_len, 1),))[
            :g_len].copy()
        offs = np.ctypeslib.as_array(o_ptr, shape=(max(o_len, 1),))[
            :o_len].copy()
    finally:
        lib.wg_buffer_free(g_ptr)
        lib.wg_buffer_free(o_ptr)
    return graph, g_bits.value, offs, o_bits.value, stats


def select_refs(costs: np.ndarray, outd: np.ndarray, window_size: int,
                max_ref_count: int, chunk_bounds: np.ndarray):
    """Greedy reference selection over a precomputed cost matrix
    (wg_select_refs; exactly BVGraph.java:2256-2270 semantics, the one
    sequential step of the device encoder).  Returns (refs, ref_counts):
    winner window distance and reference-chain depth per node."""
    lib = _load()
    costs = np.ascontiguousarray(costs, dtype=np.int64)
    outd = np.ascontiguousarray(outd, dtype=np.int64)
    chunk_bounds = np.ascontiguousarray(chunk_bounds, dtype=np.int64)
    n = len(outd)
    if costs.shape != (n, window_size + 1):
        raise ValueError(f"costs must be ({n}, {window_size + 1}), got "
                         f"{costs.shape}")
    if len(chunk_bounds) < 1 or chunk_bounds[0] != 0 or chunk_bounds[-1] != n \
            or (np.diff(chunk_bounds) < 0).any():
        raise ValueError("chunk_bounds must rise from 0 to n")
    refs = np.zeros(n, dtype=np.int32)
    rcs = np.zeros(n, dtype=np.int32)
    rc = lib.wg_select_refs(
        _ptr(costs, ctypes.c_int64), _ptr(outd, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int(window_size),
        ctypes.c_int(max_ref_count), _ptr(chunk_bounds, ctypes.c_int64),
        ctypes.c_int64(len(chunk_bounds) - 1), _ptr(refs, ctypes.c_int32),
        _ptr(rcs, ctypes.c_int32))
    if rc < 0:
        raise RuntimeError(f"select_refs failed: {rc}")
    return refs, rcs


def _take(lib, ptr, bits: int) -> np.ndarray:
    """Copy ``ceil(bits / 8)`` bytes out of a library buffer, then free it."""
    try:
        n = (bits + 7) // 8
        return np.ctypeslib.as_array(ptr, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.wg_buffer_free(ptr)


class StreamEncoder:
    """Streaming BVGraph encoder (wg_enc_*): push CSR slices of unbounded
    total size; window and reference state carry across pushes, so the
    output is byte-identical to a single-stream encode of the whole graph,
    and nothing beyond one slice is ever held."""

    def __init__(self, settings):
        lib = _load()
        self._lib = lib
        self.settings = settings
        self._h = ctypes.c_void_p(lib.wg_enc_new(
            ctypes.c_int(settings.window_size),
            ctypes.c_int(settings.max_ref_count),
            ctypes.c_int(settings.min_interval_length),
            ctypes.c_int(settings.zeta_k),
            _ptr(_codings(settings, offsets=True), ctypes.c_int)))
        self.nodes = 0
        self.bits = 0

    def push(self, csr_off: np.ndarray, succ: np.ndarray) -> int:
        """Encode len(csr_off)-1 more nodes; returns graph bits so far."""
        if self._h is None:
            raise RuntimeError("encoder already finished")
        csr_off = np.ascontiguousarray(csr_off, dtype=np.int64)
        succ = np.ascontiguousarray(succ, dtype=np.int64)
        k = len(csr_off) - 1
        bits = self._lib.wg_enc_push(
            self._h, _ptr(csr_off, ctypes.c_int64),
            _ptr(succ, ctypes.c_int64), ctypes.c_int64(k))
        if bits < 0:
            raise RuntimeError(f"native streaming encode failed: {bits}")
        self.nodes += k
        self.bits = bits
        return bits

    def finish(self):
        """Returns (graph_bytes, graph_bits, offsets_bytes, offsets_bits,
        stats) and frees the native handle."""
        if self._h is None:
            raise RuntimeError("encoder already finished")
        lib = self._lib
        stats = np.zeros(STAT_WORDS, dtype=np.int64)
        g_ptr = ctypes.POINTER(ctypes.c_uint8)()
        o_ptr = ctypes.POINTER(ctypes.c_uint8)()
        g_bits = ctypes.c_int64()
        o_bits = ctypes.c_int64()
        try:
            lib.wg_enc_finish(self._h, ctypes.byref(g_ptr),
                              ctypes.byref(g_bits), ctypes.byref(o_ptr),
                              ctypes.byref(o_bits),
                              _ptr(stats, ctypes.c_int64))
            graph = _take(lib, g_ptr, g_bits.value)
            offs = _take(lib, o_ptr, o_bits.value)
        finally:
            lib.wg_enc_free(self._h)
            self._h = None
        return graph, g_bits.value, offs, o_bits.value, stats

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.wg_enc_free(self._h)
            self._h = None


def parse_arcs_available() -> bool:
    """True: the parser is part of the port's library, built on first use
    (a failed build raises)."""
    return hasattr(_load(), "wg_parse_arcs")


def parse_arcs(buf: bytes, eof: bool = True) -> tuple:
    """Parse "<src> <tgt>" text lines -> (src int64[k], tgt int64[k],
    bytes_consumed).  Blank and '#' lines are skipped; unless ``eof``, a
    trailing incomplete line is left unconsumed (the streaming chunk
    protocol); a malformed line raises ``ValueError`` naming its byte
    offset."""
    lib = _load()
    data = np.frombuffer(buf, dtype=np.uint8)
    # every pair needs >= 3 bytes ("a b\n")
    cap = max(len(data) // 3 + 1, 16)
    src = np.empty(cap, dtype=np.int64)
    tgt = np.empty(cap, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    rc = lib.wg_parse_arcs(
        _ptr(data), ctypes.c_int64(len(data)), ctypes.c_int(1 if eof else 0),
        _ptr(src, ctypes.c_int64), _ptr(tgt, ctypes.c_int64),
        ctypes.c_int64(cap), ctypes.byref(consumed))
    if rc < 0:
        off = int(-rc - 1)
        snippet = buf[off:off + 40].split(b"\n", 1)[0]
        raise ValueError(f"malformed arc line at byte {off}: {snippet!r}")
    return src[:rc].copy(), tgt[:rc].copy(), int(consumed.value)


def decode_list_labels(data: np.ndarray, label_offsets: np.ndarray,
                       csr_off: np.ndarray, width: int, threads: int = 0,
                       alloc=None) -> tuple:
    """The list labels of a ``.labels`` stream: (counts int64[m], entries
    int64[sum(counts)]), arc j's entries the next ``counts[j]`` of
    ``entries``.

    ``label_offsets``: each node's first bit (n + 1 entries); ``csr_off``:
    the graph's CSR offsets (n + 1).  The nodes are cut into ``threads``
    ranges of equal arc shares (0: one per core); pass 1 reads every
    length and checks that each node ends at the next one's offset, pass 2
    writes the entries.  ``alloc(k)``: an int64 array of k elements to
    write into (``np.empty`` when None), for the counts and the entries.
    A node that ends elsewhere, or a code that runs past the stream,
    raises ``ValueError`` naming the first such node."""
    lib = _load()
    alloc = alloc or (lambda k: np.empty(k, dtype=np.int64))
    data = np.concatenate([np.ascontiguousarray(data, dtype=np.uint8),
                           np.zeros(32, dtype=np.uint8)])
    nbytes = len(data) - 32
    lo = np.ascontiguousarray(label_offsets, dtype=np.int64)
    co = np.ascontiguousarray(csr_off, dtype=np.int64)
    n = len(co) - 1
    m = int(co[-1])
    k = max(1, min(threads or (os.cpu_count() or 1), n))
    cuts = np.searchsorted(co, (m * np.arange(1, k, dtype=np.int64)) // k)
    x0 = np.unique(np.concatenate([[0], np.clip(cuts, 0, max(n - 1, 0))]))
    x1 = np.concatenate([x0[1:], [n]]).astype(np.int64)
    x0 = x0.astype(np.int64)
    nr = len(x0) if n else 0
    counts = alloc(m)
    tot = np.zeros(max(nr, 1), dtype=np.int64)
    err = np.zeros(3, dtype=np.int64)
    i64 = ctypes.c_int64
    if lib.wg_list_label_counts(
            _ptr(data), i64(nbytes), _ptr(lo, i64), _ptr(co, i64), i64(nr),
            _ptr(x0, i64), _ptr(x1, i64), ctypes.c_int(width),
            _ptr(counts, i64), _ptr(tot, i64), _ptr(err, i64)) < 0:
        x, at = int(err[0]), int(err[1])
        if err[2] == 1:
            raise ValueError(f"node {x}'s labels end at bit {at}, its "
                             f"successor's start at {int(lo[x + 1])}")
        raise ValueError(f"node {x}'s labels run past the {8 * nbytes} "
                         f"bits of the stream")
    start = np.zeros(max(nr, 1), dtype=np.int64)
    np.cumsum(tot[:-1], out=start[1:])
    entries = alloc(int(tot.sum()))
    lib.wg_list_label_entries(
        _ptr(data), i64(nbytes), _ptr(lo, i64), _ptr(co, i64), i64(nr),
        _ptr(x0, i64), _ptr(x1, i64), ctypes.c_int(width),
        _ptr(counts, i64), _ptr(start, i64), _ptr(entries, i64))
    return counts, entries
