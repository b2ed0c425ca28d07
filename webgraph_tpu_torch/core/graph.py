"""Device-resident CSR graph: what the decode produces and analytics consume.

Counterpart of ``webgraph_tpu/core/graph.py`` ``CSRGraph`` (``:142-223``).
Offsets are int64[n+1] and successors int32[m], both on one device (the
JAX package keeps int64 numpy arrays on the host and uploads per call).
Every method works on that device: sorting, deduplication and the per-arc
source index are torch ops there.  ``from_decoded`` wraps the output of
``ops.csr.decode_to_csr`` without bringing the successors to the host.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["CSRGraph", "expand_ranges"]

_INT32_LIMIT = 1 << 31


def expand_ranges(first, cnt, device) -> torch.Tensor:
    """repeat(first, cnt) + offsets within each run, int64 on ``device``:
    the positions of the ranges [first, first + cnt), concatenated."""
    first = torch.as_tensor(first, dtype=torch.int64, device=device)
    cnt = torch.as_tensor(cnt, dtype=torch.int64, device=device)
    total = int(cnt.sum()) if len(cnt) else 0
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    starts = torch.cumsum(cnt, 0) - cnt
    within = (torch.arange(total, device=device)
              - torch.repeat_interleave(starts, cnt, output_size=total))
    return torch.repeat_interleave(first, cnt, output_size=total) + within


def _on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def _device_of(x, device) -> torch.device:
    """``device`` when given, else the device of tensor ``x``: host arrays
    name their device explicitly."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    raise ValueError("host arrays: pass the device explicitly")


class CSRGraph:
    """CSR graph on ``device``: ``offsets`` int64[n+1], ``succ`` int32[m].
    ``device`` defaults to the successors' own when they are a tensor."""

    def __init__(self, offsets, successors, num_nodes: Optional[int] = None,
                 device=None):
        device = _device_of(successors, device)
        self.offsets = _on(offsets, device, torch.int64)
        self.succ = _on(successors, device, torch.int32)
        n = self.offsets.numel() - 1 if num_nodes is None else num_nodes
        if self.offsets.dim() != 1 or self.offsets.numel() != n + 1:
            raise ValueError(f"offsets must have n+1 = {n + 1} entries")
        if n >= _INT32_LIMIT:
            raise ValueError("node ids must fit int32")
        self._n = int(n)
        self._src: Optional[torch.Tensor] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_lists(cls, lists, device) -> "CSRGraph":
        offs = np.zeros(len(lists) + 1, dtype=np.int64)
        for i, lst in enumerate(lists):
            offs[i + 1] = offs[i] + len(lst)
        succ = (np.concatenate([np.asarray(lst, dtype=np.int64)
                                for lst in lists])
                if len(lists) else np.zeros(0, dtype=np.int64))
        return cls(offs, succ, device=device)

    @classmethod
    def from_arcs(cls, sources, targets, num_nodes: int, dedup: bool = True,
                  device=None) -> "CSRGraph":
        """Build from unsorted arc arrays: one device sort of the keys
        ``(src << 32) | tgt`` (lexicographic order), then optional dedup."""
        device = _device_of(sources, device)
        src = _on(sources, device, torch.int64)
        tgt = _on(targets, device, torch.int64)
        if src.shape != tgt.shape or src.dim() != 1:
            raise ValueError("sources and targets must be 1-D of one length")
        if src.numel() and (min(int(src.min()), int(tgt.min())) < 0
                            or max(int(src.max()), int(tgt.max()))
                            >= num_nodes):
            raise ValueError(f"arc endpoints must lie in [0, {num_nodes})")
        key = (src << 32) | tgt
        del src, tgt
        key = torch.unique(key) if dedup else torch.sort(key).values
        counts = torch.bincount(key >> 32, minlength=num_nodes)
        offsets = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
        torch.cumsum(counts, 0, out=offsets[1:])
        return cls(offsets, (key & 0xFFFFFFFF).to(torch.int32),
                   num_nodes=num_nodes, device=device)

    @classmethod
    def from_decoded(cls, csr_off, succ: torch.Tensor) -> "CSRGraph":
        """Wrap ``decode_to_csr``'s (host int64 offsets, device int32
        successors): the offsets are uploaded once, the successors stay."""
        off = np.asarray(csr_off, dtype=np.int64)
        if off[0] != 0 or off[-1] != succ.numel():
            raise ValueError("offsets must run from 0 to len(succ)")
        return cls(off, succ, device=succ.device)

    # -- the graph contract ------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.succ.device

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        return self.succ.numel()

    def outdegrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def outdegree(self, x: int) -> int:
        lo, hi = self.offsets[x:x + 2].tolist()
        return hi - lo

    def successors(self, x: int) -> torch.Tensor:
        lo, hi = self.offsets[x:x + 2].tolist()
        return self.succ[lo:hi]

    def iter_nodes(self, start: int = 0
                   ) -> Iterator[Tuple[int, torch.Tensor]]:
        offs = self.offsets.tolist()
        for x in range(start, self._n):
            yield x, self.succ[offs[x]:offs[x + 1]]

    def to_csr(self, lo: int = 0, hi: Optional[int] = None) -> "CSRGraph":
        """Nodes [lo, hi) as a CSR graph, offsets renumbered to 0."""
        if lo == 0 and (hi is None or hi == self._n):
            return self
        hi = self._n if hi is None else hi
        a, b = int(self.offsets[lo]), int(self.offsets[hi])
        return CSRGraph(self.offsets[lo:hi + 1] - a, self.succ[a:b],
                        num_nodes=hi - lo, device=self.device)

    def arc_sources(self) -> torch.Tensor:
        """Source node of every arc, int32[m], built once and kept."""
        if self._src is None:
            self._src = torch.repeat_interleave(
                torch.arange(self._n, dtype=torch.int32, device=self.device),
                self.outdegrees(), output_size=self.num_arcs)
        return self._src

    def arcs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sources, targets) int64 arc arrays in lexicographic order."""
        return (self.arc_sources().to(torch.int64),
                self.succ.to(torch.int64))

    def transpose(self) -> "CSRGraph":
        return CSRGraph.from_arcs(self.succ, self.arc_sources(), self._n,
                                  dedup=False, device=self.device)
