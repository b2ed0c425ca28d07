"""The port's host library: ctypes over ``native/wgnative.cpp``.

The library is built with g++ for the host it runs on, on first use, into
``webgraph_tpu_torch/build/`` (``ops/_build.build_native``); no binary is
committed.  It is the port's own copy of what it needs of the JAX package's
host library, with the same functions and results: the offsets index, the
outdegree scan, the sequential decoder, the batched range decoder, the
header-only reference scan and the parallel encoder.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = ["decode_offset_stream", "decode_outdegrees",
           "bv_decode_all", "bv_encode", "bv_scan_refs", "bv_fill_ranges",
           "lib_path"]

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
        for fn in ("wg_bv_decode_all", "wg_bv_encode", "wg_bv_fill_ranges",
                   "wg_bv_scan_refs"):
            getattr(lib, fn).restype = ctypes.c_int64
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
