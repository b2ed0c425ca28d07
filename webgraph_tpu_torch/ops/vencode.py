"""The device BVGraph encoder: torch ops on an explicit device.

Counterpart of ``webgraph_tpu/ops/vencode.py`` (an XLA program there, no
Pallas kernel; reference semantics CompressionThread.call + diffComp,
BVGraph.java:1977-2328).  The reference encodes one node at a time: greedy
reference selection sizes every window candidate with a counting bit stream
(:2256-2270), and the winner's diff is written with measure-then-write
discipline (:2259/:2270).  Here the same computation is four array passes:

1. **membership masks**: for every arc (x, v) and every r in 1..W, does the
   arc (x - r, v) / (x + r, v) exist?  One device sort of the packed keys
   ``(v << 32) | x`` puts the arcs sharing a value side by side; W shifted
   compares then give both mask directions;
2. **candidate cost matrix**: copy blocks are the run-length encoding of
   the reference list's membership mask minus its trailing run (the
   two-pointer walk of BVGraph.java:1996-2051); intervals and residuals of
   the leftover come from segmented scans (intervalize, :1595-1618).  All
   (x, r) costs at once, as closed-form code lengths;
3. **greedy selection**: the one sequential step (reference chains couple
   consecutive nodes), on the host in the port's native library
   (``native.select_refs``) over the cost matrix, copied there once;
4. **packing**: every winner token (value, length) gets its bit position
   from exclusive scans of lengths and is added into <= 3 words of 32 bits
   (tokens share no bit, so the add is an OR).

Byte-identical to the single-stream encoders (the ``"python"`` oracle and
``native.bv_encode(..., threads=1)``).

Dtypes: int64 where the JAX code traces 64-bit values, int32 for node ids
and values.  Torch has no unsigned 64-bit arithmetic and no count of leading
zeros: a code's bits live in int64 (``_check_codable`` bounds every value
coded so that they stay below 2**62), and floor(log2) is the exponent of
``torch.frexp`` of the value as float64, exact for integers below 2**53.

Memory: eager torch holds what XLA fuses, so the pack makes two sweeps over
the window distances -- the first sums each node's block bits and count,
the second, once every node's offset is known, rebuilds one distance's
tokens at a time and emits them -- and a graph is encoded in chunks of
``chunk_arcs`` arcs (``encode_csr_chunked``) with W-node halos that carry
the reference window across chunk bounds.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import native as _native
from ..device import require_cuda
from ..settings import CompressionFlags as _C

__all__ = ["encode_csr", "encode_csr_chunked", "pack_chunk", "pack_gaps",
           "cost_matrix", "member_masks", "select_refs", "supported",
           "EncodeDevicePlan", "BitCat", "chunk_bounds_by_arcs",
           "offsets_stream", "msb64"]

_I32 = torch.int32
_I64 = torch.int64
_PAD_WORDS = 3          # 96-bit front pad so token windows never underflow
# arcs per chunk of encode_csr_chunked: chosen on the card from the peak
# bytes and the time of the whole store (PERF.md, "encode")
DEFAULT_CHUNK_ARCS = 32 << 20
# z = value + 1 of every code stays below 2**(_CODE_BITS - zeta_k): then
# gamma's z, delta's ((b + 1) << b) | ..., and zeta's (1 << w) | field are
# all below 2**62, and z is exact as a float64 (below 2**53)
_CODE_BITS = 55
# words per chunk of the word -> byte conversion
_BYTE_CHUNK_WORDS = 1 << 26


def supported(settings) -> bool:
    """Codes the device encoder can pack (the defaults and every config of
    the reference's compression sweep; Golomb and nibble codes are the
    native and ``"python"`` encoders' alone)."""
    gd = (_C.GAMMA, _C.DELTA)
    return (settings.outdegree_coding in gd
            and settings.reference_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.block_count_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.block_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.residual_coding in (_C.ZETA, _C.GAMMA, _C.DELTA)
            and settings.offset_coding in gd
            and 0 <= settings.window_size <= 7)


def _device(x, device) -> torch.device:
    """``device`` when given, else the device of tensor ``x``, else the
    card: the CPU only when the caller names it."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return require_cuda()


def _on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


class _Split:
    """Seconds per stage on the host clock into ``out``, each ending in a
    synchronise of the device; nothing is timed when ``out`` is None."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out = out
        self.device = device
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[stage] = self.out.get(stage, 0.0) + now - self.t
        self.t = now


# ---------------------------------------------------------------------------
# closed-form instantaneous codes: value -> (bits int64, length int64)
# (MSB-first stream; bit patterns per ops/bitio.py write_* semantics)
# ---------------------------------------------------------------------------


def msb64(z: torch.Tensor) -> torch.Tensor:
    """floor(log2(z)) for 1 <= z < 2**53 (int64): the exponent of frexp of
    z as float64, exact since such z converts to float64 exactly."""
    return torch.frexp(z.to(torch.float64)).exponent.to(_I64) - 1


def _pow2(b: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(b) << b


def _check_codable(z: torch.Tensor, zeta_k: int) -> None:
    """Raise unless every z = value + 1 is below 2**(55 - k): the bound
    under which every code's bits fit int64 and msb64 is exact."""
    limit = 1 << (_CODE_BITS - max(zeta_k, 1))
    if z.numel() and int(z.max()) >= limit:
        raise OverflowError(f"value {int(z.max()) - 1} too large to code in "
                            f"int64 (limit {limit - 1})")


def _code(kind: int, x: torch.Tensor, zeta_k: int = 3):
    """(bits, length) of ``x`` (>= 0) in code ``kind``; bits right-aligned,
    the leading zeros of codes longer than 64 bits implicit."""
    x = x.to(_I64)
    if kind == _C.UNARY:
        return torch.ones_like(x), x + 1
    z = x + 1
    _check_codable(z, zeta_k)
    b = msb64(z)
    if kind == _C.GAMMA:
        return z, 2 * b + 1
    if kind == _C.DELTA:
        zb = b + 1
        bb = msb64(zb)
        return (zb << b) | (z - _pow2(b)), 2 * bb + 1 + b
    if kind == _C.ZETA:
        k = zeta_k
        hk = (b // k) * k
        left = _pow2(hk)
        short = z < (left << 1)
        w = torch.where(short, hk + k - 1, hk + k)
        field = torch.where(short, z - left, z)
        return _pow2(w) | field, b // k + 1 + w
    raise NotImplementedError(kind)


def _code_len(kind: int, x: torch.Tensor, zeta_k: int = 3) -> torch.Tensor:
    """The length alone of ``_code(kind, x)``."""
    x = x.to(_I64)
    if kind == _C.UNARY:
        return x + 1
    z = x + 1
    _check_codable(z, zeta_k)
    b = msb64(z)
    if kind == _C.GAMMA:
        return 2 * b + 1
    if kind == _C.DELTA:
        return 2 * msb64(b + 1) + 1 + b
    if kind == _C.ZETA:
        h = b // zeta_k
        short = z < _pow2(h * zeta_k + 1)
        return h + 1 + h * zeta_k + zeta_k - short.to(_I64)
    raise NotImplementedError(kind)


def _int2nat(x: torch.Tensor) -> torch.Tensor:
    x = x.to(_I64)
    return (x << 1) ^ (x >> 63)


# ---------------------------------------------------------------------------
# shifts by one position, segmented scans (arc arrays; is_first marks each
# node's first arc, first_idx / last_idx its first and last arc)
# ---------------------------------------------------------------------------


def _prev1(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted one place right: out[i] = x[i - 1], out[0] = fill."""
    out = torch.empty_like(x)
    if x.numel():
        out[0] = fill
        out[1:] = x[:-1]
    return out


def _next1(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted one place left: out[i] = x[i + 1], out[-1] = fill."""
    out = torch.empty_like(x)
    if x.numel():
        out[-1] = fill
        out[:-1] = x[1:]
    return out


def _seg_excl(x: torch.Tensor, first_idx: torch.Tensor) -> torch.Tensor:
    """Exclusive per-segment cumsum (int64): the sum of the earlier x of
    the same segment."""
    x = x.to(_I64)
    cs = torch.cumsum(x, 0)
    return cs - cs[first_idx] + x[first_idx] - x


def _seg_sum(x: torch.Tensor, co: torch.Tensor) -> torch.Tensor:
    """Per-node sums of an arc array (int64): differences of its inclusive
    cumsum at the CSR offsets ``co``."""
    cs = torch.zeros(x.numel() + 1, dtype=_I64, device=x.device)
    torch.cumsum(x.to(_I64), 0, out=cs[1:])
    return cs[co[1:]] - cs[co[:-1]]


_BIG = 1 << 62


def _last_true(cond):
    """Index of the latest j <= i with cond[j], or -1: the JAX code's
    cummax of ``where(cond, iota, -1)``, as a count of the true positions
    and a gather of their list (torch's cummax carries an index array and
    took ~100 ms over 32M int64 on the H100, a cumsum well under 1 ms)."""
    at = torch.nonzero(cond).flatten()
    if at.numel() == 0:
        return torch.full(cond.shape, -1, dtype=_I64, device=cond.device)
    c = torch.cumsum(cond, 0)
    return torch.where(c > 0, at[(c - 1).clamp(min=0)], -1)


def _first_true(cond):
    """Index of the earliest j >= i with cond[j], or _BIG: the JAX code's
    reversed cummin of ``where(cond, iota, BIG)``, counted the same way."""
    at = torch.nonzero(cond).flatten()
    if at.numel() == 0:
        return torch.full(cond.shape, _BIG, dtype=_I64, device=cond.device)
    before = torch.cumsum(cond, 0) - cond.to(_I64)
    return torch.where(before < at.numel(),
                       at[before.clamp(max=at.numel() - 1)], _BIG)


def _prev_where(cond, first_idx):
    """Index of the latest j < i in i's segment with cond[j], or -1 (a
    global running max works: indices are monotone, and the first_idx
    guard drops winners of earlier segments)."""
    prev = _prev1(_last_true(cond), -1)
    return torch.where(prev >= first_idx, prev, -1)


def _next_where(cond, last_idx):
    """Index of the earliest j > i in i's segment with cond[j], or -1."""
    nxt = _next1(_first_true(cond), _BIG)
    return torch.where(nxt <= last_idx, nxt, -1)


def _at_or_after_where(cond, last_idx):
    """Earliest j >= i in i's segment with cond[j], or -1."""
    res = _first_true(cond)
    return torch.where(res <= last_idx, res, -1)


class _Arcs:
    """Per-arc arrays of one CSR slice, derived on its device from the
    offsets: seg (node of each arc, int32), v (successor, int32), gx (the
    node's global id, int64), is_first, first_idx / last_idx (int64) and
    iota."""

    def __init__(self, co: torch.Tensor, v: torch.Tensor, node_base: int):
        dev = v.device
        self.co = co
        self.n = co.numel() - 1
        self.m = v.numel()
        deg = co[1:] - co[:-1]
        self.seg = torch.repeat_interleave(
            torch.arange(self.n, dtype=_I32, device=dev), deg,
            output_size=self.m)
        self.v = v
        self.gx = self.seg.to(_I64) + node_base
        self.first_idx = co[:-1][self.seg]
        self.last_idx = co[1:][self.seg] - 1
        self.iota = torch.arange(self.m, dtype=_I64, device=dev)
        self.is_first = self.iota == self.first_idx


# ---------------------------------------------------------------------------
# membership masks
# ---------------------------------------------------------------------------


def _member_masks_dev(seg, val, W: int):
    m = seg.numel()
    down = torch.zeros(m, dtype=_I32, device=seg.device)
    up = torch.zeros(m, dtype=_I32, device=seg.device)
    if W == 0 or m == 0:
        return down, up
    # one sort of (value, node): the arcs of a list are distinct, so no
    # two keys tie
    sk, si = torch.sort((val.to(_I64) << 32) | seg.to(_I64))
    sv = sk >> 32
    sx = sk & 0xFFFFFFFF
    del sk
    for s in range(1, W + 1):
        if s >= m:
            break
        same = sv[s:] == sv[:-s]
        d = sx[s:] - sx[:-s]      # >= 0: sorted by node within a value
        # arc i sees (x - d, v) at d <= W, and arc i - s sees (x + d, v)
        hit = (same & (d <= W)).to(_I32)
        down[s:] |= hit << d.clamp(0, W).to(_I32)
        up[:-s] |= (hit & (d >= 1).to(_I32)) << d.clamp(0, W).to(_I32)
    out_down = torch.empty_like(down)
    out_up = torch.empty_like(up)
    out_down[si] = down
    out_up[si] = up
    return out_down, out_up


def member_masks(seg, val, W: int, device=None):
    """Per-arc bitmasks (int32): ``down`` bit r set iff arc (seg - r, val)
    exists, ``up`` bit r set iff arc (seg + r, val) exists (r in 1..W)."""
    dev = _device(seg, device)
    return _member_masks_dev(_on(seg, dev, _I32), _on(val, dev, _I32), W)


# ---------------------------------------------------------------------------
# copy-block costs / tokens (over REF-list arcs)
# ---------------------------------------------------------------------------


def _blocks_scan(mem, A: _Arcs):
    """Shared RLE analysis of a reference list's membership mask.

    Returns (lead, trans_at, run_end_internal, blk_val, blk_j):
      lead[i]: i's segment starts with a non-member (a virtual leading
      empty copy run); trans_at[i]: a run starts at i (i past the segment
      start); run_end_internal[i]: i ends a run that is NOT the segment's
      last; blk_val[i]: the length of the run up to i; blk_j[i]: its
      0-based block index (counting the virtual leading run)."""
    trans_at = ~A.is_first & (mem != _prev1(mem, False))
    lead = ~mem[A.first_idx]
    ti = trans_at.to(_I64)
    rid = _seg_excl(ti, A.first_idx) + ti          # inclusive run index
    rs = _last_true(trans_at | A.is_first)         # current run start
    run_end_internal = _next1(trans_at, False) & (A.iota < A.last_idx)
    blk_val = A.iota - rs + 1
    blk_j = rid + lead.to(_I64)
    return lead, trans_at, run_end_internal, blk_val, blk_j


def _block_count(lead, trans_at, A: _Arcs):
    """Blocks of each node's list (int64 per node): its transitions plus
    the virtual leading run."""
    ti = trans_at.to(_I64)
    ntrans = _seg_excl(ti, A.first_idx) + ti
    bc_arc = ntrans[A.last_idx] + lead.to(_I64)
    return _seg_sum(torch.where(A.is_first, bc_arc, 0), A.co)


def _blocks_cost(mem, A: _Arcs, spec):
    """Per-arc block-token cost, and per-node block counts."""
    lead, trans_at, rei, blk_val, blk_j = _blocks_scan(mem, A)
    emitted = torch.where(blk_j > 0, blk_val - 1, blk_val)
    cost = torch.where(rei, _code_len(spec["block"], emitted, spec["zk"]), 0)
    # the virtual leading empty block: value 0 at j = 0, on the first arc
    zero_len = int(_code_len(spec["block"], torch.zeros(1, dtype=_I64),
                             spec["zk"]))
    cost = cost + torch.where(A.is_first & lead, zero_len, 0)
    return cost, _block_count(lead, trans_at, A)


# ---------------------------------------------------------------------------
# extras (intervals + residuals) over CURR-list arcs
# ---------------------------------------------------------------------------


def _extras_scan(kept, A: _Arcs, minint: int):
    """Shared interval/residual analysis of a kept (extras) mask: per arc,
    int_start (an interval starts here), L (its length, at kept
    positions), ce (exclusive kept count) and res (a residual)."""
    v = A.v
    pk = _prev_where(kept, A.first_idx)
    chain = kept & (pk >= 0) & (v == v[pk.clamp(min=0)] + 1)
    run_start = kept & ~chain
    ce = _seg_excl(kept, A.first_idx)
    rs = _last_true(run_start)
    rs = torch.where(rs >= A.first_idx, rs, A.first_idx)
    # run end: a kept arc whose next kept arc (if any, in the segment)
    # starts a run
    nk = _next_where(kept, A.last_idx)
    nk_chain = torch.where(nk >= 0, chain[nk.clamp(min=0)], False)
    run_end = kept & ((nk < 0) | ~nk_chain)
    re_idx = _at_or_after_where(run_end, A.last_idx)
    L = ce[re_idx.clamp(min=0)] - ce[rs] + 1
    if minint > 0:
        is_int = kept & (L >= minint)
    else:
        is_int = torch.zeros_like(kept)
    return dict(ce=ce, L=L, int_start=run_start & is_int,
                res=kept & ~is_int)


def _interval_tokens(E, A: _Arcs, minint: int):
    """Left-extreme values of the interval tokens (at interval starts)."""
    v = A.v.to(_I64)
    iidx = _seg_excl(E["int_start"], A.first_idx)
    prev_is = _prev_where(E["int_start"], A.first_idx).clamp(min=0)
    pl = v[prev_is]
    pL = E["L"][prev_is]
    return torch.where(iidx == 0, _int2nat(v - A.gx), v - (pl + pL) - 1)


def _residual_tokens(res, A: _Arcs):
    """(values, ridx, previous residual's value) of the residual tokens."""
    v = A.v.to(_I64)
    ridx = _seg_excl(res, A.first_idx)
    pr = v[_prev_where(res, A.first_idx).clamp(min=0)]
    return torch.where(ridx == 0, _int2nat(v - A.gx), v - pr - 1), ridx, pr


def _extras_cost(kept, A: _Arcs, spec):
    """Per-arc extras cost, the per-node interval-count token included
    (on the segment's first arc; it exists iff the node has extras and
    minint > 0)."""
    minint = spec["minint"]
    E = _extras_scan(kept, A, minint)
    cost = torch.zeros(A.m, dtype=_I64, device=A.v.device)
    if minint > 0:
        left = _interval_tokens(E, A, minint)
        cost = cost + torch.where(
            E["int_start"], _code_len(_C.GAMMA, left)
            + _code_len(_C.GAMMA, E["L"] - minint), 0)
        ii = E["int_start"].to(_I64)
        n_int = (_seg_excl(ii, A.first_idx) + ii)[A.last_idx]
        has_extras = (E["ce"][A.last_idx]
                      + kept[A.last_idx].to(_I64)) > 0
        cost = cost + torch.where(A.is_first & has_extras,
                                  _code_len(_C.GAMMA, n_int), 0)
    res_val, _, _ = _residual_tokens(E["res"], A)
    return cost + torch.where(E["res"],
                              _code_len(spec["res"], res_val, spec["zk"]), 0)


# ---------------------------------------------------------------------------
# cost matrix
# ---------------------------------------------------------------------------


def _spec(settings) -> Dict[str, int]:
    return dict(outd=settings.outdegree_coding,
                ref=settings.reference_coding,
                bcount=settings.block_count_coding,
                block=settings.block_coding,
                res=settings.residual_coding,
                off=settings.offset_coding,
                zk=settings.zeta_k,
                minint=settings.min_interval_length,
                W=settings.window_size)


def _cost_matrix_dev(A: _Arcs, down, up, spec) -> torch.Tensor:
    """costs[x, r] for r in 0..W (int64): every r with a window slot gets
    its diff_comp bit count; x < r (no such slot) gets -1.  Eligibility by
    list existence and chain depth is the selection pass's job."""
    W = spec["W"]
    n = A.n
    dev = A.v.device
    costs = torch.empty((n, W + 1), dtype=_I64, device=dev)
    # r = 0: no blocks, extras = the whole list
    c0 = _seg_sum(_extras_cost(torch.ones_like(A.is_first), A, spec), A.co)
    if W > 0:
        c0 = c0 + int(_code_len(spec["ref"], torch.zeros(1, dtype=_I64)))
    costs[:, 0] = c0
    ref_len = _code_len(spec["ref"], torch.arange(W + 1, device=dev))
    for r in range(1, W + 1):
        if r >= n:   # window deeper than the whole slice
            costs[:, r] = -1
            continue
        # blocks over ref lists: arc k of node y is in the ref list of
        # x = y + r; member iff (y + r, w) exists: up bit r
        mem = ((up >> r) & 1).bool()
        bcost_arc, bc = _blocks_cost(mem, A, spec)
        bcost = _seg_sum(bcost_arc, A.co) + _code_len(spec["bcount"], bc,
                                                      spec["zk"])
        # extras over curr lists: kept = not copied = down bit r unset
        kept = ((down >> r) & 1) == 0
        ecost = _seg_sum(_extras_cost(kept, A, spec), A.co)
        col = costs[:, r]
        col[:r] = -1
        col[r:] = bcost[:n - r] + ecost[r:] + ref_len[r]
    return costs


def cost_matrix(co, succ, settings, node_base: int = 0,
                device=None) -> torch.Tensor:
    """Candidate cost matrix (n, W+1) int64 on the device: diff_comp bit
    counts for every window candidate (the sizing pass of
    BVGraph.java:2256-2266).  ``node_base``: global id of local node 0."""
    dev = _device(succ, device)
    A = _Arcs(_on(co, dev, _I64), _on(succ, dev, _I32), node_base)
    spec = _spec(settings)
    down, up = _member_masks_dev(A.seg, A.v, spec["W"])
    return _cost_matrix_dev(A, down, up, spec)


def select_refs(costs, outd, settings, chunk_bounds=None):
    """Greedy reference selection on the host (``native.select_refs``;
    BVGraph.java:2256-2270 semantics, window resets at chunk bounds).
    Returns (refs, ref_counts), int32 numpy arrays."""
    costs = costs.cpu().numpy() if isinstance(costs, torch.Tensor) else costs
    outd = outd.cpu().numpy() if isinstance(outd, torch.Tensor) else outd
    n = len(outd)
    if chunk_bounds is None:
        chunk_bounds = np.asarray([0, n], dtype=np.int64)
    return _native.select_refs(costs, np.asarray(outd, dtype=np.int64),
                               settings.window_size, settings.max_ref_count,
                               np.asarray(chunk_bounds, dtype=np.int64))


# ---------------------------------------------------------------------------
# bit packer: winner tokens -> positions (segmented scans) -> word adds
#
# Every token class is ordered by node (and by arc within a node), so no
# sort is needed: per-node per-class bit totals -> an exclusive cumsum gives
# each node's class offsets; exclusive cumsums within (node, class) place
# each token.  A token's value is < 2**min(len, 62) (the leading zeros of
# longer codes are implicit), so its bits add into <= 3 words of 32 bits.
# ---------------------------------------------------------------------------


def _add_runs(out, j, vals):
    """``out[j[i]] += vals[i]``, each run of equal neighbours in ``j``
    summed first (differences of a cumsum, exact modulo 2**64): a class's
    tokens come in stream order, so the ~8 pieces of one word sit side by
    side, and the scatter adds once per word instead of contending on it
    once per piece.  Right for any order of ``j``."""
    end = torch.ones(j.shape, dtype=torch.bool, device=j.device)
    end[:-1] = j[1:] != j[:-1]
    at = torch.nonzero(end).flatten()
    sums = torch.cumsum(vals, 0)[at]
    out.index_add_(0, j[at], torch.diff(sums, prepend=sums.new_zeros(1)))


def _emit(out, pos, bits, lens, valid):
    """Add tokens into ``out``: int64 words holding 32 stream bits each,
    word j the bits [32 (j - 3), 32 (j - 2)) of the stream, MSB first.
    Tokens share no bit, so adding is OR-ing.  The last word of ``out``
    is a drop slot: a piece that falls outside words [0, len - 1) lands
    there and is never read, as the JAX scatter's mode="drop" drops it.
    An invalid token adds 0 where its position points, which keeps the
    words of a class in order for ``_add_runs``.

    pos: the stream bit positions (int64, before the 96-bit front pad);
    bits: right-aligned code values; lens: code lengths."""
    if lens.numel() == 0:
        return
    nw = out.numel() - 1
    e = pos + lens + 32 * _PAD_WORDS         # end bit, front pad included
    v = torch.where(valid, bits, 0)
    j1 = (e - 1) >> 5
    # a code of <= 33 bits spans at most two words
    for t in range(3 if int(lens.max()) > 33 else 2):
        j = j1 - t
        s = e - 32 * (j + 1)                 # in [-31, 95]
        part = torch.where(s >= 64, 0, v >> s.clamp(0, 63))
        part = torch.where(s < 0, v << (-s).clamp(0, 63), part)
        _add_runs(out, torch.where((j >= 0) & (j < nw), j, nw),
                  part & 0xFFFFFFFF)


def _gap_bins(vals_first, gaps, valid_first, valid_gap):
    """Exp-binned gap histogram, int64[64] (_Encoder._update_bins
    semantics): the msb of the raw in-list gaps, plus the msb of
    int2nat(first - node) where that is >= 0 (a value of 0 adds
    nothing)."""
    def msb_or_64(x, ok):
        ok = ok & (x > 0)
        return torch.where(ok, msb64(x.clamp(min=1)), 64)

    bins = torch.cat([msb_or_64(gaps, valid_gap),
                      msb_or_64(vals_first, valid_first)])
    return torch.bincount(bins, minlength=65)[:64]


def _pack_dev(A: _Arcs, down, up, refs, nw: int, spec, emit_from: int):
    """Pack the winner tokens of nodes [emit_from, n) into ``nw`` words
    (3 front pad words).  Returns (words int64[nw + 1], node_starts int64
    (emitted nodes get their start, halo nodes -1), total_bits tensor,
    stats int64[138])."""
    W = spec["W"]
    zk = spec["zk"]
    minint = spec["minint"]
    n, m = A.n, A.m
    dev = A.v.device
    co = A.co
    out = torch.zeros(nw + 1, dtype=_I64, device=dev)
    outd = co[1:] - co[:-1]
    node_emit = torch.arange(n, device=dev) >= emit_from
    arc_emit = A.seg >= emit_from
    refs_arc = refs[A.seg]

    # ---- per-node header tokens -------------------------------------------
    outd_bits, outd_len = _code(spec["outd"], outd, zk)
    outd_len = torch.where(node_emit, outd_len, 0)
    has_ref_tok = node_emit & (outd > 0) if W > 0 else torch.zeros_like(
        node_emit)
    ref_bits, ref_len = _code(spec["ref"], refs, zk)
    ref_len = torch.where(has_ref_tok, ref_len, 0)

    # ---- blocks, sweep 1: each node's block bits and block count ----------
    zero = torch.zeros(1, dtype=_I64, device=dev)
    z_bits, z_len = (int(t) for t in _code(spec["block"], zero, zk))
    l_blk = torch.zeros(n, dtype=_I64, device=dev)
    bc_val = torch.zeros(n, dtype=_I64, device=dev)
    copied = torch.zeros((), dtype=_I64, device=dev)

    def block_tokens(r):
        mem = ((up >> r) & 1).bool()
        lead, trans_at, rei, blk_val, blk_j = _blocks_scan(mem, A)
        xn = A.seg.to(_I64) + r                   # token owner node
        x_ok = (xn < n) & (refs[xn.clamp(max=n - 1)] == r) & (xn >= emit_from)
        lead_v = A.is_first & lead & x_ok
        rend_v = rei & x_ok
        emitted = torch.where(blk_j > 0, blk_val - 1, blk_val)
        return mem, lead, trans_at, xn, x_ok, lead_v, rend_v, emitted

    for r in range(1, min(W, n - 1) + 1):
        mem, lead, trans_at, _, x_ok, lead_v, rend_v, emitted = \
            block_tokens(r)
        L12 = (torch.where(lead_v, z_len, 0)
               + torch.where(rend_v, _code_len(spec["block"], emitted, zk), 0))
        pick = torch.zeros(n, dtype=torch.bool, device=dev)
        pick[r:] = (refs[r:] == r) & node_emit[r:]
        l_blk[r:] += torch.where(pick[r:], _seg_sum(L12, co)[:n - r], 0)
        bc_val[r:] += torch.where(pick[r:],
                                  _block_count(lead, trans_at, A)[:n - r], 0)
        copied += (mem & x_ok).sum()
        del mem, lead, trans_at, x_ok, lead_v, rend_v, emitted, L12

    has_bc = node_emit & (refs > 0)
    bc_bits, bc_len = _code(spec["bcount"], bc_val, zk)
    bc_len = torch.where(has_bc, bc_len, 0)

    # ---- extras (the winner's kept mask; per-arc dynamic r) ----------------
    kept = (((down >> refs_arc) & 1) == 0) & arc_emit
    E = _extras_scan(kept, A, minint)
    has_extras = node_emit & (_seg_sum(kept, co) > 0)
    if minint > 0:
        il_bits, il_len = _code(_C.GAMMA, _interval_tokens(E, A, minint))
        ll_bits, ll_len = _code(_C.GAMMA, E["L"] - minint)
        Li1 = torch.where(E["int_start"], il_len, 0)
        Li2 = torch.where(E["int_start"], ll_len, 0)
        n_int = _seg_sum(E["int_start"], co)
        ic_bits, ic_len = _code(_C.GAMMA, n_int)
        ic_len = torch.where(has_extras, ic_len, 0)
        intervalised = torch.where(E["int_start"], E["L"], 0).sum()
        l_int = _seg_sum(Li1 + Li2, co)
    else:
        ic_bits = ic_len = l_int = torch.zeros(n, dtype=_I64, device=dev)
        intervalised = torch.zeros((), dtype=_I64, device=dev)
    res = E["res"] & kept
    res_val, ridx, pr = _residual_tokens(res, A)
    r_bits, r_len = _code(spec["res"], res_val, zk)
    Lr = torch.where(res, r_len, 0)
    l_res = _seg_sum(Lr, co)

    # ---- per-node class offsets -------------------------------------------
    tl = outd_len + ref_len + bc_len + l_blk + ic_len + l_int + l_res
    base = torch.cumsum(tl, 0) - tl
    ofs_ref = base + outd_len
    ofs_bc = ofs_ref + ref_len
    ofs_blk = ofs_bc + bc_len
    ofs_ic = ofs_blk + l_blk
    ofs_int = ofs_ic + ic_len
    ofs_res = ofs_int + l_int
    total_bits = tl.sum()

    # ---- emit --------------------------------------------------------------
    _emit(out, base, outd_bits, outd_len, node_emit)
    _emit(out, ofs_ref, ref_bits, ref_len, has_ref_tok)
    _emit(out, ofs_bc, bc_bits, bc_len, has_bc)
    # blocks, sweep 2: one window distance's tokens alive at a time
    for r in range(1, min(W, n - 1) + 1):
        _, _, _, xn, _, lead_v, rend_v, emitted = block_tokens(r)
        b_bits, b_len = _code(spec["block"], emitted, zk)
        L1 = torch.where(lead_v, z_len, 0)
        L2 = torch.where(rend_v, b_len, 0)
        pbase = ofs_blk[xn.clamp(max=n - 1)] + _seg_excl(L1 + L2, A.first_idx)
        _emit(out, pbase, torch.full_like(L1, z_bits), L1, lead_v)
        _emit(out, pbase + L1, b_bits, L2, rend_v)
        del xn, lead_v, rend_v, emitted, b_bits, b_len, L1, L2, pbase
    if minint > 0:
        _emit(out, ofs_ic, ic_bits, ic_len, has_extras)
        pint = ofs_int[A.seg] + _seg_excl(Li1 + Li2, A.first_idx)
        _emit(out, pint, il_bits, Li1, E["int_start"])
        _emit(out, pint + Li1, ll_bits, Li2, E["int_start"])
        del pint, il_bits, ll_bits, Li1, Li2
    _emit(out, ofs_res[A.seg] + _seg_excl(Lr, A.first_idx), r_bits, Lr, res)

    # ---- stats (the native encoder's st[] layout) --------------------------
    v = A.v.to(_I64)
    first_val = _int2nat(v[A.first_idx] - A.gx)
    succ_bins = _gap_bins(first_val, v - _prev1(v, 0),
                          A.is_first & arc_emit, ~A.is_first & arc_emit)
    res_bins = _gap_bins(_int2nat(v - A.gx), v - pr, res & (ridx == 0),
                         res & (ridx > 0))
    head = torch.stack([
        copied, intervalised, res.sum(), torch.zeros_like(copied),
        torch.where(node_emit, refs, 0).sum(), outd_len.sum(), ref_len.sum(),
        bc_len.sum() + l_blk.sum(), ic_len.sum() + l_int.sum(),
        l_res.sum()])
    stats = torch.cat([head, succ_bins, res_bins])
    node_starts = torch.where(node_emit, base, -1)
    return out, node_starts, total_bits, stats


def _pack(A: _Arcs, down, up, refs, spec, emit_from: int):
    """``_pack_dev`` with its output sized: a first estimate, checked
    against the packer's own exact total; an undersized buffer packs again,
    larger (pieces past the buffer are dropped, so it must never be
    used).  Returns (words, total_bits int, node_starts, stats)."""
    ub_bits = 16 * A.m + 70 * A.n + 128
    for _ in range(3):
        nw = _PAD_WORDS + -(-ub_bits // 32)
        words, starts, total, stats = _pack_dev(A, down, up, refs, nw, spec,
                                                emit_from)
        total = int(total)
        if total + 32 * _PAD_WORDS <= nw * 32:
            return words[:nw], total, starts, stats
        ub_bits = total + 256
    raise RuntimeError("encode buffer sizing did not converge")


def pack_chunk(co, succ, settings, refs, node_base: int = 0,
               emit_from: int = 0, device=None):
    """Pack the winner tokens of nodes [emit_from, n) of a CSR slice into an
    MSB-first bit stream (measure-then-pack, BVGraph.java:2259/:2270).

    Nodes [0, emit_from) are halo context: their arcs feed reference lists
    and masks but emit no bits.  Returns (words int64 tensor, each holding
    32 bits, 3 front pad words first; total_bits int; node_starts int64
    tensor, -1 for the halo; stats int64 tensor of 138)."""
    dev = _device(succ, device)
    spec = _spec(settings)
    A = _Arcs(_on(co, dev, _I64), _on(succ, dev, _I32), node_base)
    down, up = _member_masks_dev(A.seg, A.v, spec["W"])
    return _pack(A, down, up, _on(refs, dev, _I64), spec, emit_from)


def _words_to_bytes(words: torch.Tensor, total_bits: int) -> bytes:
    """Strip the front pad and give the MSB-first byte stream, the final
    byte padded with zeros (BitWriter.to_bytes discipline): each word as
    an int32 of the same bits, its bytes reversed, in chunks of words."""
    nbytes = -(-total_bits // 8)
    nw = -(-nbytes // 4)
    out = np.empty(4 * nw, dtype=np.uint8)
    for a in range(0, nw, _BYTE_CHUNK_WORDS):
        b = min(a + _BYTE_CHUNK_WORDS, nw)
        w = words[_PAD_WORDS + a:_PAD_WORDS + b]
        w32 = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
        out[4 * a:4 * b] = w32.view(torch.uint8).view(-1, 4).flip(1) \
            .reshape(-1).cpu().numpy()
    return out[:nbytes].tobytes()


def pack_gaps(vals, coding: int, zeta_k: int = 3, device=None):
    """Pack a flat value sequence with one instantaneous code (the offsets
    stream: gamma/delta gaps, n+1 entries with a leading 0).  Returns
    (bytes, bits)."""
    dev = _device(vals, device)
    v = _on(vals, dev, _I64)
    bits, lens = _code(coding, v, zeta_k)
    pos = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    out = torch.zeros(_PAD_WORDS + -(-total // 32) + 1, dtype=_I64,
                      device=dev)
    _emit(out, pos, bits, lens, torch.ones_like(v, dtype=torch.bool))
    return _words_to_bytes(out, total), total


def offsets_stream(starts: torch.Tensor, graph_bits: int, settings):
    """The ``.offsets`` stream of an encode: the gaps between the nodes'
    bit offsets (``starts``), a leading 0 and the last node's length, in
    the offset coding.  Returns (bytes, bits)."""
    gaps = torch.zeros(starts.numel() + 1, dtype=_I64, device=starts.device)
    if starts.numel():
        gaps[1:-1] = starts[1:] - starts[:-1]
        gaps[-1] = graph_bits - starts[-1]
    return pack_gaps(gaps, settings.offset_coding, settings.zeta_k)


def encode_csr(co, succ, settings, node_base: int = 0, device=None):
    """The whole encode of one CSR slice in one piece: cost matrix ->
    native greedy selection -> token pack.  Returns (graph_bytes,
    graph_bits, node_starts, refs, ref_counts, stats[138]) with
    single-stream semantics (the window never resets)."""
    dev = _device(succ, device)
    spec = _spec(settings)
    A = _Arcs(_on(co, dev, _I64), _on(succ, dev, _I32), node_base)
    down, up = _member_masks_dev(A.seg, A.v, spec["W"])
    costs = _cost_matrix_dev(A, down, up, spec)
    refs, rcs = select_refs(costs, (A.co[1:] - A.co[:-1]), settings)
    words, total, starts, stats = _pack(A, down, up, _on(refs, dev, _I64),
                                        spec, 0)
    stats = stats.cpu().numpy()
    stats[3] = int(rcs.sum())
    return (_words_to_bytes(words, total), total, starts, refs, rcs, stats)


class EncodeDevicePlan:
    """Device-resident whole-graph encoder: the CSR is uploaded once; each
    ``encode()`` derives the arc arrays, masks and cost matrix on the
    device, copies the cost matrix to the host once for the greedy
    selection, and packs on the device, only the stream coming back.
    Sized for graphs whose arc arrays fit the card in one piece; larger
    ones use ``encode_csr_chunked``."""

    def __init__(self, co, succ, settings, device=None):
        if not supported(settings):
            raise ValueError("the device encoder does not support this "
                             "coding combination")
        self.settings = settings
        self.device = _device(succ, device)
        self.co = _on(co, self.device, _I64)
        self.v = _on(succ, self.device, _I32)
        self.n = self.co.numel() - 1
        self.m = self.v.numel()
        if int(self.co[-1]) != self.m:
            raise ValueError("offsets must end at len(succ)")

    def encode(self, selection: str = "native"):
        """Returns (graph_bytes, graph_bits, node_starts int64[n], refs
        int32[n], ref_counts int32[n], stats int64[138]).

        ``selection``: "native", the host greedy pass over the cost matrix
        copied once.  The JAX package's "scan", a block-unrolled device
        scan written for a runtime whose host link was scarcer than its
        per-step latency, is not ported (ROADMAP A12) and raises."""
        if selection != "native":
            raise ValueError(f"selection {selection!r}: only 'native' is "
                             f"ported; the device scan is struck (ROADMAP "
                             f"A12)")
        return encode_csr(self.co, self.v, self.settings)


class BitCat:
    """MSB-first bit-stream concatenator (the analogue of the reference's
    per-thread stream concatenation, BVGraph.java:2432-2483): appends
    chunks of any bit length with a vectorized byte shift-and-merge."""

    def __init__(self):
        self._buf = bytearray()
        self.bits = 0

    def push(self, data: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        k = self.bits & 7
        nb = -(-nbits // 8)
        a = np.frombuffer(data, dtype=np.uint8, count=nb)
        if k == 0:
            self._buf += a.tobytes()
        else:
            s = np.empty(nb + 1, dtype=np.uint8)
            s[0] = a[0] >> k
            np.left_shift(a, 8 - k, out=s[1:], casting="unsafe")
            s[1:-1] |= a[1:] >> k
            L = -(-(nbits + k) // 8)
            self._buf[-1] |= int(s[0])
            self._buf += s[1:L].tobytes()
        self.bits += nbits
        # zero any slack bits past the logical end (a chunk's final byte
        # may carry stale low bits)
        r = self.bits & 7
        if r:
            self._buf[-1] &= (0xFF00 >> r) & 0xFF

    def to_bytes(self) -> bytes:
        return bytes(self._buf)


def chunk_bounds_by_arcs(co, target_arcs: int) -> np.ndarray:
    """Node chunk bounds so each chunk holds <= target_arcs arcs (a lone
    hub node may exceed it); always >= 1 node per chunk."""
    co = np.asarray(co, dtype=np.int64)
    n = len(co) - 1
    bounds = [0]
    while bounds[-1] < n:
        x = int(np.searchsorted(co, co[bounds[-1]] + target_arcs, "right")
                ) - 1
        bounds.append(min(max(x, bounds[-1] + 1), n))
    return np.asarray(bounds, dtype=np.int64)


def encode_csr_chunked(co, succ, settings,
                       chunk_arcs: int = DEFAULT_CHUNK_ARCS, device=None,
                       split: Optional[dict] = None, node_base: int = 0):
    """Chunked device encode of a whole CSR graph with single-stream
    semantics (byte-identical to ``encode_csr`` and the ``"python"``
    encoder): per-chunk device passes over ~chunk_arcs arcs, W-node halos
    carrying the reference window across chunk bounds, one global native
    greedy selection, bit-exact stream concatenation.

    ``co``/``succ``: the CSR (tensors stay on their device; host arrays go
    to ``device``, the card when None).  Node ids must fit int32.  The
    offsets come to the host once (8 bytes a node, for the chunk bounds and
    the selection); the successors never do.  ``split``: a dict to fill
    with the seconds of each stage (each ends in a synchronise) and the
    chunk count.  ``node_base``: global id of local node 0 (a node range of
    a larger graph, encoded as one of the reference's per-thread ranges).
    Returns (graph_bytes, graph_bits, node_starts int64[n] on the device,
    stats int64[138] numpy)."""
    dev = _device(succ, device)
    co = _on(co, dev, _I64)
    succ = _on(succ, dev, _I32)
    n = co.numel() - 1
    W = settings.window_size
    spec = _spec(settings)
    tick = _Split(split, dev)
    if n == 0:
        return b"", 0, torch.zeros(0, dtype=_I64, device=dev), \
            np.zeros(_native.STAT_WORDS, np.int64)
    co_h = co.cpu().numpy()
    bounds = chunk_bounds_by_arcs(co_h, chunk_arcs)
    if split is not None:
        split.update(chunks=len(bounds) - 1, chunk_arcs=chunk_arcs)

    def chunk(i):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        h = min(W, lo)
        a0 = int(co_h[lo - h])
        A = _Arcs(co[lo - h:hi + 1] - a0, succ[a0:int(co_h[hi])],
                  node_base + lo - h)
        down, up = _member_masks_dev(A.seg, A.v, W)
        tick("arcs_masks_s")
        return lo, hi, h, A, down, up

    # pass 1: per-chunk candidate cost matrices (W-node halo), copied into
    # one host matrix (page-locked on the card: one copy, at the link's rate)
    costs = torch.empty((n, W + 1), dtype=_I64,
                        pin_memory=dev.type == "cuda")
    tick("setup_s")
    for i in range(len(bounds) - 1):
        lo, hi, h, A, down, up = chunk(i)
        cm = _cost_matrix_dev(A, down, up, spec)
        del A, down, up
        tick("cost_matrix_s")
        # halo rows carry partial windows; only the emitted rows count
        costs[lo:hi].copy_(cm[h:])
        del cm
        tick("cost_copy_s")
    # pass 2: the global greedy selection (the one sequential step)
    refs_h, rcs = select_refs(costs.numpy(), np.diff(co_h), settings)
    del costs
    refs = torch.from_numpy(refs_h).to(dev, _I64)
    tick("select_refs_s")
    # pass 3: per-chunk pack + bit-exact concatenation
    cat = BitCat()
    starts = torch.empty(n, dtype=_I64, device=dev)
    stats = torch.zeros(_native.STAT_WORDS, dtype=_I64, device=dev)
    for i in range(len(bounds) - 1):
        lo, hi, h, A, down, up = chunk(i)
        words, total, st_local, st_vec = _pack(A, down, up, refs[lo - h:hi],
                                               spec, h)
        del A, down, up
        starts[lo:hi] = st_local[h:] + cat.bits
        stats += st_vec
        tick("pack_s")
        cat.push(_words_to_bytes(words, total), total)
        del words
        tick("concat_s")
    stats = stats.cpu().numpy()
    stats[3] = int(rcs.sum())
    return cat.to_bytes(), cat.bits, starts, stats
