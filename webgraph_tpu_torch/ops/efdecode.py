"""EFGraph decode on a device: torch ops, every node and arc at once.

Counterpart of ``webgraph_tpu/ops/efdecode.py`` (``EFDevicePlan`` ``:152``,
``ef_decode_to_csr`` ``:188``), by another design.  The JAX program expands
the stream to one int32 per bit and takes a cumulative sum over it to rank
the ones (``:118-125``), which needs 4 bytes of device memory per stream
bit and fewer than 2^31 bits.  Here the ones are ranked per 64-bit word
(EFGraph.java:1081-1160 selects the same way):

1. every node's gamma-coded outdegree at its offset (LSB-first longwords,
   the unary part as trailing zeros), and from it the closed-form layout of
   its entry: l, pointer size and pointer count (EFGraph.java:140-168), so
   the bases of its lower and upper bits;
2. per-word popcounts and their exclusive cumulative sum, the rank of the
   first bit of each word;
3. node x's upper-bits region holds its d+1 ones with no one of another
   region between them, so its j-th successor's one is the global
   ``(rank(up_base[x]) + j)``-th one of the stream: no masking is needed.
   A ``searchsorted`` over the word ranks finds its word, a select within
   the word its bit;
4. value = (one position - up_base - j) << l | the j-th l-bit lower field.

Per-arc work runs in chunks of whole nodes of about ``CHUNK_ARCS`` arcs, so
the temporaries stay a few GB at hundreds of millions of arcs.  Device
memory beyond the CSR: the stream, one int64 rank per stream word, and six
int64 per node.

Spans (``utils/trace.py``): ``wg.ef.plan`` > ``.upload``, ``.outdegrees``
for the plan; ``wg.ef.decode`` > ``.layout``, ``.ranks``, ``.chunks`` (the
chunk bounds' readback), ``.select`` (a chunk's per-arc work) for each
decode, which counts ``ef.arcs`` and ``ef.chunks``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.trace import count, span
from .ef_index import bits_at, low_rank, popcount64, select_in_word

__all__ = ["EFDevicePlan", "ef_decode_to_csr", "CHUNK_ARCS"]

CHUNK_ARCS = 1 << 24
_WORD_CHUNK = 1 << 24


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 below 2^53 (0 for 0), exactly."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def read_gamma(w32: torch.Tensor, pos: torch.Tensor):
    """LSB-first gamma codes at ``pos`` (EFGraph's writeNonZeroGamma of
    value + 1): (value, bits read), int64.  Values must be below 2^32 - 1."""
    x = bits_at(w32, pos, 32)
    if bool((x == 0).any()):
        raise ValueError("EF stream: an outdegree's unary part runs past "
                         "32 bits (corrupt stream or offsets)")
    t = _bit_length(x & -x) - 1          # trailing zeros
    return ((1 << t) | bits_at(w32, pos + t + 1, t)) - 1, 2 * t + 1


class EFDevicePlan:
    """The stream and the per-node offsets on ``device``: uploaded once,
    with the outdegrees read there and one readback (the arc count).
    :meth:`decode` runs the whole decode on that device."""

    def __init__(self, words64: np.ndarray, offsets: np.ndarray,
                 upper_bound: int, log2_quantum: int, *, device):
        if not 0 <= upper_bound < (1 << 31):
            raise ValueError("the device decode needs an upper bound below "
                             "2^31 (int32 successors)")
        with span("ef.plan"):
            self.device = torch.device(device)
            with span("ef.plan.upload"):
                words = np.ascontiguousarray(words64, dtype=np.uint64)
                self.nwords = len(words)
                # two zero guard words: bits_at reads one 32-bit word past
                # its field
                words = np.concatenate([words, np.zeros(2, dtype=np.uint64)])
                self.words = torch.from_numpy(words.view(np.int64)).to(
                    self.device)
                self.w32 = self.words.view(torch.int32)
                offsets = np.asarray(offsets, dtype=np.int64)
                self.n = len(offsets) - 1
                self.upper_bound = int(upper_bound)
                self.log2_quantum = int(log2_quantum)
                self.starts = torch.from_numpy(offsets[:-1]).to(self.device)
            with span("ef.plan.outdegrees"):
                self.d, self.adv = read_gamma(self.w32, self.starts)
                self.csr_off = torch.zeros(self.n + 1, dtype=torch.int64,
                                           device=self.device)
                torch.cumsum(self.d, 0, out=self.csr_off[1:])
                self.m = int(self.csr_off[-1])

    def _layout(self):
        """(l, low_base, up_base) per node (EFGraph.java:140-168)."""
        u = self.upper_bound
        cl = self.d + 1
        l = (_bit_length(u // cl) - 1).clamp(min=0)
        shifted = torch.full_like(l, u) >> l
        psize = _bit_length(cl + shifted - 1)          # ceil(log2(cl + s))
        npointers = shifted >> self.log2_quantum
        low_base = self.starts + self.adv + npointers * psize
        return l, low_base, low_base + cl * l

    def _word_ranks(self) -> torch.Tensor:
        """int64[nwords + 1]: ones before each word (exclusive)."""
        pc = torch.zeros(self.nwords + 1, dtype=torch.int64,
                         device=self.device)
        for a in range(0, self.nwords, _WORD_CHUNK):
            b = min(a + _WORD_CHUNK, self.nwords)
            pc[a + 1:b + 1] = popcount64(self.words[a:b])
        return torch.cumsum(pc, 0)

    def _chunks(self, chunk_arcs: int):
        """Node bounds of chunks of about ``chunk_arcs`` arcs each."""
        cuts = torch.searchsorted(
            self.csr_off, torch.arange(0, self.m, chunk_arcs,
                                       device=self.device))
        b = np.unique(np.concatenate([cuts.cpu().numpy(), [0, self.n]]))
        return zip(b[:-1].tolist(), b[1:].tolist())

    def decode(self, chunk_arcs: int = CHUNK_ARCS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (csr_off int64[n+1], succ int32[m]), both on the device."""
        with span("ef.decode"):
            dev = self.device
            succ = torch.empty(self.m, dtype=torch.int32, device=dev)
            count("ef.arcs", self.m)
            if self.m == 0:
                return self.csr_off, succ
            with span("ef.decode.layout"):
                l, low_base, up_base = self._layout()
            with span("ef.decode.ranks"):
                rank = self._word_ranks()
                w0 = up_base >> 6
                rank0 = rank[w0] + low_rank(self.words[w0], up_base & 63)
                del w0
            with span("ef.decode.chunks"):
                chunks = list(self._chunks(chunk_arcs))
            count("ef.chunks", len(chunks))
            for x0, x1 in chunks:
                with span("ef.decode.select"):
                    a0, a1 = int(self.csr_off[x0]), int(self.csr_off[x1])
                    if a0 == a1:
                        continue
                    row = torch.repeat_interleave(
                        torch.arange(x0, x1, device=dev), self.d[x0:x1],
                        output_size=a1 - a0)
                    j = torch.arange(a0, a1, device=dev) - self.csr_off[row]
                    g = rank0[row] + j          # the arc's one, globally
                    w = torch.searchsorted(rank, g, right=True) - 1
                    one = w * 64 + select_in_word(self.words[w], g - rank[w])
                    del g, w
                    lx = l[row]
                    upper = one - up_base[row] - j
                    low = bits_at(self.w32, low_base[row] + j * lx, lx)
                    succ[a0:a1] = ((upper << lx) | low).to(torch.int32)
            return self.csr_off, succ


def ef_decode_to_csr(words64: np.ndarray, offsets: np.ndarray,
                     upper_bound: int, log2_quantum: int, *, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a whole EFGraph (uint64 words and per-node bit offsets) to CSR
    on ``device``: (csr_off int64[n+1], succ int32[m]) tensors there."""
    return EFDevicePlan(words64, offsets, upper_bound, log2_quantum,
                        device=device).decode()
