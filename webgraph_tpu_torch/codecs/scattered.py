"""ScatteredArcsASCIIGraph — arbitrary-order arc-pair ingestion.

Counterpart of ``webgraph_tpu/codecs/scattered.py``, the same names, ids and
batches; each batch is sorted and deduplicated on a named device by the
port's ``transform.offline.process_batch``.

Re-design of ScatteredArcsASCIIGraph.java:60-240: arc pairs with arbitrary
64-bit (or string) identifiers arrive in any order; identifiers are remapped
to dense node ids in order of appearance (the mapping is persisted as the
``.ids`` file: binary longs, appearance order); pairs accumulate into sorted
disk batches and the result is a BatchGraph ready for any codec's store.

Ingestion is **streaming and memory-bounded** like the reference's
(Id2NodeMap open-address big-array hash + incremental batch spills,
ScatteredArcsASCIIGraph.java:155-240, batch loop :700+): the input is read
in fixed-size chunks (native ``wg_parse_arcs`` scalar scanner when ids are
numeric, ~GB/s; a Python line loop only when an ``id_function`` maps string
ids), each chunk's ids are remapped against an incrementally grown sorted
table (vectorized searchsorted — the hash's role, but array-first), and
remapped pairs spill to sorted disk batches as soon as ``batch_size`` pairs
have accumulated.  Peak memory is O(batch_size + #distinct ids), never
O(#arcs); the id table itself is in-RAM exactly as the reference's map is.
"""

from __future__ import annotations

import tempfile
from typing import Callable, IO, Iterator, List, Optional, Tuple, Union

import numpy as np

import torch

from .. import native
from ..core.graph import ImmutableGraph
from ..transform.offline import BatchGraph, process_batch

__all__ = ["ScatteredArcsASCIIGraph", "scattered_arcs_to_batches",
           "scattered_arcs_stream_to_batches", "IdRemap"]

DEFAULT_BATCH_SIZE = 10_000_000
DEFAULT_CHUNK_BYTES = 32 << 20


class IdRemap:
    """Appearance-order dense node-id assignment (the Id2NodeMap role,
    ScatteredArcsASCIIGraph.java:155-240), vectorized per block.

    Keeps the known ids as a sorted array plus their dense ranks; each block
    is reduced to its distinct ids (one sort), which are resolved with one
    searchsorted of sorted keys, new ids get the next dense ids in
    first-appearance order, and the sorted table grows by a vectorized
    merge.  O(U + B log B) per block of B pairs against U known ids."""

    def __init__(self):
        self._sorted = np.zeros(0, dtype=np.int64)
        self._rank = np.zeros(0, dtype=np.int64)
        self._chunks: List[np.ndarray] = []
        self.count = 0

    def remap(self, vals: np.ndarray) -> np.ndarray:
        vals = np.asarray(vals, dtype=np.int64)
        uniq, first_idx, inv = np.unique(vals, return_index=True,
                                         return_inverse=True)
        rank = np.empty(len(uniq), dtype=np.int64)
        if len(self._sorted):
            pos = np.searchsorted(self._sorted, uniq)
            posc = np.minimum(pos, len(self._sorted) - 1)
            known = (pos < len(self._sorted)) & (self._sorted[posc] == uniq)
            rank[known] = self._rank[pos[known]]
        else:
            known = np.zeros(len(uniq), dtype=bool)
        new = ~known
        if new.any():
            new_vals = uniq[new]
            order = np.argsort(first_idx[new], kind="stable")
            r = np.empty(len(order), dtype=np.int64)
            r[order] = np.arange(len(order))
            rank[new] = self.count + r
            self._chunks.append(new_vals[order])
            ins = np.searchsorted(self._sorted, new_vals)
            self._sorted = np.insert(self._sorted, ins, new_vals)
            self._rank = np.insert(self._rank, ins, self.count + r)
            self.count += len(new_vals)
        return rank[inv.reshape(-1)]

    def ids(self) -> np.ndarray:
        """Original identifiers in appearance order (``.ids`` semantics)."""
        if not self._chunks:
            return np.zeros(0, dtype=np.int64)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]


def _device(device) -> torch.device:
    from ..device import require_cuda

    return require_cuda() if device is None else torch.device(device)


def scattered_arcs_stream_to_batches(
        pair_chunks: Iterator[Tuple[np.ndarray, np.ndarray]],
        symmetrize: bool = False, no_loops: bool = False,
        batch_size: int = DEFAULT_BATCH_SIZE,
        temp_dir: Optional[str] = None, device=None,
) -> Tuple[BatchGraph, np.ndarray, dict]:
    """Streaming ingestion: consume (raw_src, raw_tgt) id chunks, remap
    incrementally, spill sorted batches whenever ``batch_size`` pairs are
    buffered.  Returns (batch_graph, ids, stats); ``stats['max_buffered']``
    is the peak number of buffered pairs (bounded by ~batch_size + one
    chunk — the memory contract, ScatteredArcsASCIIGraph.java:142-240).
    Each batch is sorted on ``device`` (the GPU when None, the CPU only
    when the caller names it)."""
    dev = _device(device)
    temp_dir = temp_dir or tempfile.gettempdir()
    remap = IdRemap()
    batches: List[str] = []
    buf_s: List[np.ndarray] = []
    buf_t: List[np.ndarray] = []
    buffered = 0
    total = 0
    max_buffered = 0

    def spill():
        nonlocal buffered, total
        if not buffered:
            return
        s = np.concatenate(buf_s)
        t = np.concatenate(buf_t)
        buf_s.clear()
        buf_t.clear()
        buffered = 0
        for lo in range(0, len(s), batch_size):
            total += process_batch(
                torch.from_numpy(s[lo:lo + batch_size]).to(dev),
                torch.from_numpy(t[lo:lo + batch_size]).to(dev), temp_dir,
                batches)

    for rs, rt in pair_chunks:
        rs = np.asarray(rs, dtype=np.int64)
        rt = np.asarray(rt, dtype=np.int64)
        both = np.empty(2 * len(rs), dtype=np.int64)
        both[0::2] = rs  # appearance order is src, tgt, src, tgt, ...
        both[1::2] = rt
        dense = remap.remap(both)
        s, t = dense[0::2], dense[1::2]
        if no_loops:
            keep = s != t
            s, t = s[keep], t[keep]
        if symmetrize:
            s, t = np.concatenate([s, t]), np.concatenate([t, s])
        if len(s):
            buf_s.append(s)
            buf_t.append(t)
            buffered += len(s)
            max_buffered = max(max_buffered, buffered)
            if buffered >= batch_size:
                spill()
    spill()
    stats = {"max_buffered": max_buffered, "num_batches": len(batches)}
    return BatchGraph(remap.count, total, batches), remap.ids(), stats


def scattered_arcs_to_batches(
        sources: np.ndarray, targets: np.ndarray,
        symmetrize: bool = False, no_loops: bool = False,
        batch_size: int = DEFAULT_BATCH_SIZE,
        temp_dir: Optional[str] = None, device=None,
) -> Tuple[BatchGraph, np.ndarray]:
    """Bulk numeric ingestion: remap arbitrary int64 ids to dense nodes.

    Returns (batch_graph, ids): ``ids[i]`` is the original identifier of
    node i (appearance order, matching the ``.ids`` file semantics)."""
    g, ids, _ = scattered_arcs_stream_to_batches(
        iter([(np.asarray(sources, dtype=np.int64),
               np.asarray(targets, dtype=np.int64))]),
        symmetrize=symmetrize, no_loops=no_loops,
        batch_size=batch_size, temp_dir=temp_dir, device=device)
    return g, ids


def _numeric_pair_chunks(f: IO[bytes], chunk_bytes: int
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Chunked native text parse: yields (src, tgt) raw-id arrays; a
    trailing incomplete line carries into the next chunk."""
    carry = b""
    while True:
        block = f.read(chunk_bytes)
        if isinstance(block, str):
            block = block.encode()
        eof = not block
        buf = carry + block
        if buf:
            s, t, used = native.parse_arcs(buf, eof=eof)
            carry = buf[used:]
            if len(s):
                yield s, t
        if eof:
            break


def _python_pair_chunks(f, id_function: Optional[Callable[[str], int]],
                        flush_pairs: int = 1 << 20
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Line-loop fallback (string ids via ``id_function``, or no native
    lib); still streaming — flushes arrays every ``flush_pairs`` lines."""
    srcs: List[int] = []
    tgts: List[int] = []
    fn = id_function or int
    for line in f:
        if isinstance(line, bytes):
            line = line.decode()
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        a, b = line.split()
        srcs.append(fn(a))
        tgts.append(fn(b))
        if len(srcs) >= flush_pairs:
            yield (np.asarray(srcs, dtype=np.int64),
                   np.asarray(tgts, dtype=np.int64))
            srcs.clear()
            tgts.clear()
    if srcs:
        yield (np.asarray(srcs, dtype=np.int64),
               np.asarray(tgts, dtype=np.int64))


class ScatteredArcsASCIIGraph(ImmutableGraph):
    """Text ingestion: one arc per line, ids arbitrary (numeric or, with
    ``id_function``, any string mapped to int64).  Streaming: the input is
    never held in memory; see module docstring.  The batches are sorted on
    ``device`` (the GPU when None, the CPU only when the caller names
    it)."""

    def __init__(self, stream_or_path: Union[str, IO[str], IO[bytes]],
                 symmetrize: bool = False, no_loops: bool = False,
                 id_function: Optional[Callable[[str], int]] = None,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 temp_dir: Optional[str] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, device=None):
        device = _device(device)
        close = False
        use_native = id_function is None and native.parse_arcs_available()
        if isinstance(stream_or_path, str):
            f = open(stream_or_path, "rb" if use_native else "r")
            close = True
        else:
            f = stream_or_path
        try:
            if use_native:
                chunks = _numeric_pair_chunks(f, chunk_bytes)
            else:
                chunks = _python_pair_chunks(f, id_function)
            self.batch_graph, self.ids, self.ingest_stats = \
                scattered_arcs_stream_to_batches(
                    chunks, symmetrize=symmetrize, no_loops=no_loops,
                    batch_size=batch_size, temp_dir=temp_dir, device=device)
        finally:
            if close:
                f.close()
        self.properties = {}

    @property
    def num_nodes(self) -> int:
        return self.batch_graph.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.batch_graph.num_arcs

    @property
    def random_access(self) -> bool:
        return False

    def successors(self, x: int) -> np.ndarray:
        raise RuntimeError("ScatteredArcsASCIIGraph is sequential-only")

    def iter_nodes(self, start: int = 0):
        return self.batch_graph.iter_nodes(start)

    def save_ids(self, path: str) -> None:
        """Write the ``.ids`` file: original ids in appearance order
        (binary big-endian longs, ScatteredArcsASCIIGraph.java ids file)."""
        np.asarray(self.ids, dtype=np.int64).astype(">i8").tofile(path)
