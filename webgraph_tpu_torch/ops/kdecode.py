"""BVGraph decode, one lane per chunk of consecutive nodes (kernel B1).

Counterpart of ``webgraph_tpu/ops/kdecode.py`` (``_make_kernel``,
``decode_chunked``, ``check_diag``).  Each lane runs the BVGraph entry state
machine -- outdegree, reference, copy blocks, intervals, residuals (format:
BVGraph.java:123-233, decode: :995-1097) -- over its chunk, merges the copied,
interval and residual streams into ascending order, and writes each list into
its own segment of one flat store.  Copies resolve inline against a (W+1)-slot
window keyed by the global node id; the lists of predecessors referenced
across the chunk boundary sit at the head of the segment (the halo).

The CUDA kernel is ``csrc/bv_decode.cu``; ``decode_lanes_plain`` is its plain
PyTorch twin, the same step function over all lanes in lockstep.  They agree
on the store and on every diagnostic, STEPS included.  STEPS counts the
state machine's steps: one per header code read (outdegree, reference,
block count, each block, interval count, each interval's left extreme and
length, first residual), one per successor written, and one per re-read of
a skip/keep block pair or of an interval while emitting.  The kernel runs a
node at a time but counts, commits and stops exactly at these steps.

Lane table (``meta``, int64 ``(lanes, NMETA)``; columns ``M_*``): node count,
absolute start bit, global id of the first node, halo rows (the chunk's first
row), segment base and length in the store, the initial window (outdegree,
then row, per slot) and the preset fields (count, value, from
``preset_col``).  A plan that splits long lists (``SplitPlan``, made by
``kplan``) fills the preset fields:

* a preset lane (count > 0) decodes one run of a split list's residuals:
  ``count`` of them from the checkpoint value ``value``, its stream at the
  bit after that value's code; it writes its rows into the list's own rows,
  at the run's index.  Window slot 0 holds, in place of a window, where the
  run's codes end (outdegree: bits from the start bit) and whether the list
  goes on (row: 1), in which case the lane reads one code more, the next
  run's head, so that each run is checked to end where the next begins;
* the list's head lane (count = -residuals; the list is alone in its chunk)
  decodes the header, the copy blocks and the intervals, checks that its
  first residual code ends at bit ``value`` (the first run's start), and
  writes the list's other values, copies and intervals merged, after the
  residual rows.  Where there are any, ``merge_split`` merges the two
  ascending runs after the decode.

A preset lane's diagnostics are checked against its own rows, and a flagged
one flags its head lane (``check_diag``, ``lanes_flagged``), whose chunk the
host fill then decodes whole.  The kernel is built twice from one source:
``bv_decode_lanes_split`` (``csrc/bv_decode_split.cu``, ``WG_B1_SPLIT``)
for a lane table with preset fields, ``bv_decode_lanes`` without the preset
code for every other.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from ..utils.trace import count
from . import _build
from .bitstream import K_GAMMA, K_NONE, K_ZETA, read_code, words_i64

# states (values of the JAX kernel's ST_*)
ST_DONE, ST_OUTD, ST_REF, ST_BC, ST_BLK = 0, 1, 2, 3, 4
ST_ICNT, ST_ILEFT, ST_ILEN, ST_RESF, ST_EMIT = 5, 6, 7, 8, 9

# diagnostic rows
DIAG_ERR, DIAG_WCUR, DIAG_NODES, DIAG_STEPS, DIAG_ROWS = 0, 1, 2, 3, 4

# error bits
E_UNARY = 1        # unary run beyond the 64-bit window
E_WIDTH = 2        # code mantissa beyond 32 bits (value >= 2^32)
E_BLK_OVF = 4      # more copy blocks than scratch (never set: no cap here)
E_INT_OVF = 8      # more intervals than scratch (never set: no cap here)
E_COUNT = 16       # emitted successors != outdegree
E_WCUR = 32        # output segment overflow
E_STEPS = 64       # step budget exhausted (never set: every step progresses)

# lane-table columns
M_NODES, M_BIT, M_X, M_WCUR0, M_BASE, M_SEG, M_WIN = 0, 1, 2, 3, 4, 5, 6

INF = 1 << 62

_KERNEL_KINDS = (1, 2, 5, 6)   # delta, gamma, unary, zeta


def nmeta(window_size: int) -> int:
    return M_WIN + 2 * (window_size + 1) + 2


def preset_col(window_size: int) -> int:
    """The lane table's column of the preset count; the value follows."""
    return M_WIN + 2 * (window_size + 1)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """The stream format the kernel decodes."""

    window_size: int
    min_interval_length: int
    zeta_k: int
    outdegree_coding: int
    reference_coding: int
    block_count_coding: int
    block_coding: int
    residual_coding: int

    @classmethod
    def from_settings(cls, s) -> "KernelSpec":
        return cls(s.window_size, s.min_interval_length, s.zeta_k,
                   s.outdegree_coding, s.reference_coding,
                   s.block_count_coding, s.block_coding, s.residual_coding)

    def supported(self) -> bool:
        ks = {self.outdegree_coding, self.reference_coding,
              self.block_count_coding, self.block_coding,
              self.residual_coding}
        return ks <= set(_KERNEL_KINDS) and 0 <= self.window_size <= 7

    def kinds(self) -> tuple:
        ks = {self.outdegree_coding, self.residual_coding}
        if self.window_size:
            ks |= {self.reference_coding, self.block_count_coding,
                   self.block_coding}
        if self.min_interval_length:
            ks.add(K_GAMMA)
        return tuple(sorted(ks))


@dataclasses.dataclass
class SplitPlan:
    """The long lists a plan splits across lanes (``kplan``).  Each is alone
    in its chunk, whose lane is its head lane; its residual run is cut at
    the checkpoints of ``native.hub_parse`` into preset lanes, the rows
    ``plan.lanes ..`` of the lane table.  The plan holds a checkpoint (bit,
    value, count) a run and no successor: every call decodes every arc."""

    nodes: np.ndarray         # int64[S] plan-local ids of the split lists
    heads: np.ndarray         # int64[S] their head lanes
    res: np.ndarray           # int64[S] residuals each (the preset lanes')
    seg_head: np.ndarray      # int64[P] head lane of each preset lane
    seg_wcur: np.ndarray      # int64[P] each preset lane's final WCUR
    seg_head_t: torch.Tensor  # the two above, on the device
    seg_wcur_t: torch.Tensor
    # the lists with copies or intervals, merged after B1 (merge_split):
    # first store row, residuals and row offsets, int64 on the device, and
    # the list of every 256th row (int32)
    merge_row0: torch.Tensor
    merge_res: torch.Tensor
    merge_base: torch.Tensor
    merge_tile: torch.Tensor
    merge_rows: int

    @property
    def segments(self) -> int:
        return len(self.seg_head)

    @property
    def arcs(self) -> int:
        return int(self.res.sum())

    @property
    def merged(self) -> int:
        return len(self.merge_row0)


@dataclasses.dataclass
class LanePlan:
    """A decode plan: the lane table and the store, on one device.

    Built once per graph by ``kplan.plan_kernel_decode``.  ``store`` holds
    every lane's segment, ``[halo lists | chunk arcs]`` from
    ``store_off[i]``; the kernel writes the chunk rows in place."""

    spec: KernelSpec
    device: torch.device
    words: torch.Tensor        # int32 packed stream (+16 guard words)
    meta: torch.Tensor         # int64 (lanes, NMETA)
    store: torch.Tensor        # int32 [store_off[-1]]
    n: int                     # plan-local nodes (offsets has n+1 entries)
    m: int                     # arcs decoded ([first node, n))
    chunk_starts: np.ndarray   # int64[lanes+1] plan-local node bounds
    halo_arcs: np.ndarray      # int64[lanes]
    store_off: np.ndarray      # int64[lanes+1]
    cum_arcs: np.ndarray       # int64[n+1]
    outdegrees: np.ndarray     # int64[n]
    offsets: np.ndarray        # int64[n+1] bit offsets
    exp_arcs: np.ndarray       # int64[lanes] expected final WCUR
    exp_nodes: np.ndarray      # int64[lanes] expected NODES
    expect: torch.Tensor       # int32 (lanes, 2) on device: the two above
    order: torch.Tensor        # int32 (lanes,) on device: costliest first
    data: np.ndarray           # stream bytes (host fill)
    settings: object
    node_base: int = 0         # global id of plan-local node 0
    arc_base: int = 0          # cum_arcs at the first decoded node
    # cold plans: per halo list, its destination and source in the store,
    # predecessor node, length, source lane, and the pass after which the
    # source list is right (resolve.resolve_halos)
    cold: bool = False
    resolved: bool = True
    wf_dst0: Optional[np.ndarray] = None
    wf_src0: Optional[np.ndarray] = None
    wf_nodes: Optional[np.ndarray] = None
    wf_cnt: Optional[np.ndarray] = None
    wf_chunk: Optional[np.ndarray] = None
    wf_depth: Optional[np.ndarray] = None
    # csr.plan_csr_index: the run table and the CSR offsets
    compact_plan: object = None   # kcompact.CompactPlan
    csr_off: Optional[np.ndarray] = None
    # the long lists split across preset lanes (meta's rows lanes ..)
    split: Optional[SplitPlan] = None

    @property
    def lanes(self) -> int:
        """Chunk lanes (the preset lanes of ``split`` follow them)."""
        return len(self.chunk_starts) - 1


def lane_rows(plan: LanePlan, a: int, b: int) -> np.ndarray:
    """The lane table's rows of chunk lanes [a, b): the lanes themselves,
    then the preset lanes of the split lists they head (which write into
    their head lane's store segment)."""
    rows = np.arange(a, b, dtype=np.int64)
    if plan.split is None:
        return rows
    h = plan.split.seg_head
    return np.concatenate([rows, plan.lanes + np.flatnonzero(
        (h >= a) & (h < b))])


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


# lane tables already checked, with the tensors' versions and the store
# size they were checked against: the checks read the whole table, so they
# run once per table and again only after an in-place change
_CHECKED = {}   # id(meta) -> (weak refs to meta and order, key)


def _check_lane_table(meta, store, W: int, order) -> bool:
    """One device reduction: the kernel reads and writes only inside each
    lane's [base, base + seg) and trusts these bounds; it holds node ids,
    rows, window entries and preset counts in 32 bits, and takes the lanes
    in ``order``.  Returns whether a lane has preset fields."""
    key = (meta._version, store.numel(), W,
           None if order is None else (id(order), order._version))
    seen = _CHECKED.get(id(meta))
    if (seen is not None and seen[0]() is meta and seen[2] == key
            and (order is None or seen[1]() is order)):
        return seen[3]
    base, seg, wcur0 = meta[:, M_BASE], meta[:, M_SEG], meta[:, M_WCUR0]
    nodes, x = meta[:, M_NODES], meta[:, M_X]
    win = meta[:, M_WIN:M_WIN + 2 * (W + 1)]
    pc, pv = meta[:, preset_col(W)], meta[:, preset_col(W) + 1]
    split = pc != 0
    checks = [
        (split & ((nodes != 1) | (pc >= 1 << 30) | (pc <= -(1 << 30))
                  | (pv < 0) | ((pc > 0) & (pv >= 1 << 31)))).any(),
        ((base < 0) | (wcur0 < 0) | (wcur0 > seg) | (meta[:, M_BIT] < 0)
         | (base + seg > store.numel())).any(),
        ((seg >= 1 << 30) | (nodes < 0) | (x < 0) | (x + nodes >= 1 << 31)
         | (win < 0).any(1) | (win >= 1 << 30).any(1)).any()]
    if order is not None:
        L = meta.shape[0]
        checks.append((order < 0).any() | (order >= L).any()
                      | (torch.bincount(order.clamp(0, L - 1).to(torch.int64),
                                        minlength=L) != 1).any())
    checks.append(split.any())
    bad = torch.stack(checks).tolist()
    if bad[0]:
        raise ValueError("a preset lane or a split list's head lane holds "
                         "one node, a count of magnitude below 2^30 and a "
                         "value (a node id below 2^31, or a bit) >= 0")
    if bad[1]:
        raise ValueError("a lane's segment lies outside the store")
    if bad[2]:
        raise ValueError("a lane's node ids must fit 31 bits, its segment "
                         "and window entries 30")
    if order is not None and bad[3]:
        raise ValueError("order is not a permutation of the lanes")
    for k in [k for k, v in _CHECKED.items() if v[0]() is None]:
        del _CHECKED[k]
    _CHECKED[id(meta)] = (weakref.ref(meta),
                          weakref.ref(order) if order is not None else None,
                          key, bad[-1])
    return bad[-1]


def decode_lanes(words: torch.Tensor, meta: torch.Tensor,
                 store: torch.Tensor, spec: KernelSpec,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode every lane of ``meta`` into ``store`` (in place); returns the
    int32 diagnostics ``(lanes, DIAG_ROWS)``.

    ``order``: int32, a permutation of the lanes, the order in which the
    kernel's threads take them (``LanePlan.order``: the costliest first);
    no result depends on it.  CUDA tensors launch ``bv_decode_lanes``
    (``bv_decode_lanes_split`` for a lane table with preset fields; each
    counts its launches in ``_build.LAUNCHES``); CPU tensors run
    :func:`decode_lanes_plain`."""
    dev = meta.device
    _check(words, "words", torch.int32, 1, dev)
    _check(meta, "meta", torch.int64, 2, dev)
    _check(store, "store", torch.int32, 1, dev)
    if order is not None:
        _check(order, "order", torch.int32, 1, dev)
        if order.shape[0] != meta.shape[0]:
            raise ValueError(f"order has {order.shape[0]} lanes, meta "
                             f"{meta.shape[0]}")
    W = spec.window_size
    if not spec.supported():
        raise ValueError(f"format outside the kernel envelope: {spec}")
    if meta.shape[1] != nmeta(W):
        raise ValueError(f"meta has {meta.shape[1]} columns, "
                         f"expected {nmeta(W)}")
    if K_ZETA in spec.kinds() and not 1 <= spec.zeta_k <= 32:
        raise ValueError(f"zeta_k {spec.zeta_k} outside 1..32")
    split = bool(meta.shape[0]) and _check_lane_table(meta, store, W, order)
    if dev.type == "cpu":
        return decode_lanes_plain(words, meta, store, spec)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lanes = meta.shape[0]
    diag = torch.empty((lanes, DIAG_ROWS), dtype=torch.int32, device=dev)
    key = "bv_decode_lanes_split" if split else "bv_decode_lanes"
    rc = getattr(_build.lib(), "wg_" + key)(
        words.data_ptr(), words.shape[0], meta.data_ptr(), meta.shape[1],
        lanes, store.data_ptr(), diag.data_ptr(),
        None if order is None else order.data_ptr(), W,
        spec.min_interval_length, spec.zeta_k, spec.outdegree_coding,
        spec.reference_coding, spec.block_count_coding, spec.block_coding,
        spec.residual_coding, _build.stream_ptr(meta))
    _build.check(rc, key)
    _build.LAUNCHES[key] += 1
    return diag


def _nat2int(v):
    return (v >> 1) ^ -(v & 1)


def decode_lanes_plain(words: torch.Tensor, meta: torch.Tensor,
                       store: torch.Tensor, spec: KernelSpec
                       ) -> torch.Tensor:
    """The plain PyTorch twin of ``bv_decode_lanes``: all lanes step in
    lockstep as int64 tensors, one state-machine step per iteration, with
    masks and gathers.  Same arguments and result; works on any device.

    Finished lanes leave the working set once they are half of it, so the
    long tail of a decode (a few lanes holding large nodes) steps narrow
    tensors."""
    dev = meta.device
    L = meta.shape[0]
    W = spec.window_size
    CYC = W + 1
    MININT = spec.min_interval_length
    ZK = spec.zeta_k
    kinds = spec.kinds()
    w = words_i64(words)
    i64 = torch.int64
    z = torch.zeros(L, dtype=i64, device=dev)
    meta = meta.to(i64)
    n_nodes = meta[:, M_NODES]
    wcur = meta[:, M_WCUR0].clone()
    slots = torch.arange(CYC, device=dev)[None, :]
    # the preset fields: a preset lane starts emitting its run, a split
    # list's head lane skips its residuals (the kernel's SPLIT code)
    pc, pv = meta[:, preset_col(W)], meta[:, preset_col(W) + 1]
    pre = (pc > 0) & (n_nodes > 0)
    d0 = torch.where(pre, pc, 0)
    st0 = torch.where(n_nodes > 0, torch.where(pc > 0, ST_EMIT, ST_OUTD),
                      ST_DONE)
    # the working set: per-lane state, one row per lane still in it
    state = [meta[:, M_BIT].clone(), meta[:, M_X].clone(), wcur,
             wcur.clone(), st0, *(z.clone() for _ in range(31)), n_nodes,
             meta[:, M_BASE], meta[:, M_SEG],
             meta[:, M_WIN:M_WIN + CYC].clone(),
             meta[:, M_WIN + CYC:M_WIN + 2 * CYC].clone(),
             torch.where(pc < 0, -pc, 0), torch.where(pc < 0, pv, 0),
             z.clone(), torch.where(pre, meta[:, M_BIT] + meta[:, M_WIN], -1),
             pre & (meta[:, M_WIN + CYC] != 0),
             torch.arange(L, device=dev)]
    # a preset lane's d, e_rem, r_rem and r_val (entries 8, 26, 34, 35)
    state[8], state[26], state[34] = d0, d0.clone(), d0.clone()
    state[35] = torch.where(pre, pv, 0)
    result = torch.zeros((L, DIAG_ROWS), dtype=i64, device=dev)
    have_store = store.numel() > 0
    state_kind = {ST_OUTD: spec.outdegree_coding,
                  ST_REF: spec.reference_coding,
                  ST_BC: spec.block_count_coding,
                  ST_BLK: spec.block_coding, ST_ICNT: K_GAMMA,
                  ST_ILEFT: K_GAMMA, ST_ILEN: K_GAMMA,
                  ST_RESF: spec.residual_coding}

    def W_(mask, new, old):
        return torch.where(mask, new, old)

    def any_(*masks):
        return torch.stack([mk.any() for mk in masks]).tolist()

    while True:
        (pos, x, wcur, nrow, st, err, steps, node, d, ref, ref_len, ref_row,
         cop, extra, bc, blk_i, blk_tot, blk_cop, blk0, cblk, icnt, i_idx,
         iprev, ileft, ipos0, ipos, e_rem, c_rem, c_idx, krem, bj, iv,
         ilen_rem, i_next, r_rem, r_val, n_nodes, base, seg_len, win_d,
         win_row, skip, skip_bit, jump, pre_end, pre_more, lane) = state
        # lanes per state: one host sync per step; blocks of absent states
        # are skipped
        cnt = torch.bincount(st, minlength=10).tolist()
        act = st != ST_DONE
        if 2 * sum(cnt[1:]) <= len(st):
            # retire the finished lanes: their diagnostics are final
            fin = ~act
            result[lane[fin]] = torch.stack([err, wcur, node, steps],
                                            dim=1)[fin]
            if not act.any():
                break
            state = [t[act] for t in state]
            continue
        z = torch.zeros_like(st)
        steps = steps + act.to(i64)
        ms = {s_: st == s_ for s_ in range(1, 10) if cnt[s_]}
        hdr_states = [s_ for s_ in ms if s_ != ST_EMIT]
        nob = torch.zeros_like(act)
        cskip = iload = emit = nob
        any_cskip = any_iload = any_emit = False
        if ST_EMIT in ms:
            me = ms[ST_EMIT]
            cskip = me & (c_rem > 0) & (krem == 0)
            iload = me & ~cskip & (ilen_rem == 0) & (i_next < icnt)
            emit = me & ~cskip & ~iload
            any_cskip, any_iload, any_emit = any_(cskip, iload, emit)

        # -- emit: the three heads, the winner, pre-read checks
        e_em = z
        if any_emit:
            has_c = emit & (c_rem > 0)
            row = ref_row + c_idx
            bad_c = has_c & ((row < 0) | (row >= nrow))
            okc = has_c & ~bad_c
            cval = torch.full_like(z, INF)
            if have_store:
                g = store[torch.where(okc, base + row, 0)].to(i64)
                cval = W_(okc, g, cval)
            ival = W_(emit & (ilen_rem > 0), iv, INF)
            rv = W_(emit & (r_rem > 0), r_val, INF)
            win_c = (cval <= ival) & (cval <= rv)
            win_i = ~win_c & (ival <= rv)
            win_r = ~win_c & ~win_i
            val = W_(win_c, cval, W_(win_i, ival, rv))
            e_em = W_(bad_c | (val == INF), E_COUNT,
                      W_(wcur >= seg_len, E_WCUR, 0))
            e_em = W_(emit, e_em, 0)

        # -- code reads: slot 1 (header code, block/interval re-read,
        # residual gap), slot 2 (second block/interval code)
        kind1 = z
        kinds1 = set()
        for s_ in hdr_states:
            kind1 = W_(ms[s_], state_kind[s_], kind1)
            kinds1.add(state_kind[s_])
        if any_cskip:
            kind1 = W_(cskip, spec.block_coding, kind1)
            kinds1.add(spec.block_coding)
        if any_iload:
            kind1 = W_(iload, K_GAMMA, kind1)
            kinds1.add(K_GAMMA)
        if any_emit:
            kind1 = W_(emit & win_r & ((r_rem > 1) | pre_more) & (e_em == 0),
                       spec.residual_coding, kind1)
            kinds1.add(spec.residual_coding)
        p1 = pos
        if any_iload:
            p1 = W_(iload, ipos, p1)
        if any_cskip:
            p1 = W_(cskip, cblk, p1)
        v1, a1, re = read_code(w, p1, kind1, ZK, tuple(kinds1))
        q1 = p1 + a1
        v2, q2, more = z, q1, nob
        if any_cskip or any_iload:
            more = cskip & (bj + 2 < bc)
            kind2 = W_(more, spec.block_coding, W_(iload, K_GAMMA, K_NONE))
            v2, a2, e2 = read_code(w, q1, kind2, ZK,
                                   (spec.block_coding, K_GAMMA))
            q2 = q1 + a2
            re = re | e2

        # -- post-read checks
        v = v1
        chk = z
        if ST_BC in ms:
            bc0 = ms[ST_BC] & (v == 0)
            chk = chk | W_(bc0 & (d - ref_len < 0), E_COUNT, 0)
        if ST_BLK in ms:
            bval = W_(blk_i == 0, v, v + 1)
            tot = blk_tot + bval
            copc = blk_cop + W_(blk_i % 2 == 0, bval, 0)
            bi = blk_i + 1
            cop_blk = copc + W_(bc % 2 == 0, ref_len - tot, 0)
            blk_fin = ms[ST_BLK] & (bi == bc)
            chk = chk | W_(blk_fin & ((tot > ref_len) | (d - cop_blk < 0)),
                           E_COUNT, 0)
        if ST_ILEN in ms:
            ln = v + MININT
            ex = extra - ln
            chk = chk | W_(ms[ST_ILEN] & (ex < 0), E_COUNT, 0)
        if ST_RESF in ms:
            hs = ms[ST_RESF] & (skip > 0)
            chk = chk | W_(hs & ((extra != skip) | (q1 != skip_bit)), E_COUNT,
                           W_(hs & (skip > seg_len - wcur), E_WCUR, 0))
        if any_emit:
            done_e = emit & (e_rem == 1)
            left_open = (((c_rem - win_c.to(i64)) != 0)
                         | ((ilen_rem - win_i.to(i64)) != 0)
                         | (i_next != icnt)
                         | ((r_rem - win_r.to(i64)) != 0)
                         | ((pre_end >= 0) & (q1 != pre_end)))
            chk = chk | W_(done_e & left_open, E_COUNT, 0)
        e = W_(re != 0, re, chk)
        if any_emit:
            e = W_(e_em != 0, e_em, e)
        err = err | e
        ok = e == 0
        st = W_(ok, st, ST_DONE)
        c = {s_: ms[s_] & ok for s_ in ms}

        # -- per-state commits (each lane is in exactly one state)
        if hdr_states:
            hdr = c[hdr_states[0]]
            for s_ in hdr_states[1:]:
                hdr = hdr | c[s_]
            pos = W_(hdr, q1, pos)
        setup = nob
        node_fin = nob
        init_e = nob
        init_resf = nob
        if ST_OUTD in c:
            m_ = c[ST_OUTD]
            d = W_(m_, v, d)
            node_fin = m_ & (v == 0)
            if W > 0:
                st = W_(m_ & (v > 0), ST_REF, st)
            else:
                nz = m_ & (v > 0)
                ref = W_(nz, 0, ref)
                bc = W_(nz, 0, bc)
                cop = W_(nz, 0, cop)
                extra = W_(nz, d, extra)
                setup = setup | nz
        if ST_REF in c:
            m_ = c[ST_REF]
            ref = W_(m_, v, ref)
            hr = m_ & (v > 0)
            onehot = slots == torch.remainder(x - v, CYC)[:, None]
            ref_len = W_(hr, (win_d * onehot).sum(1), ref_len)
            ref_row = W_(hr, (win_row * onehot).sum(1), ref_row)
            st = W_(hr, ST_BC, st)
            nr = m_ & (v == 0)
            bc = W_(nr, 0, bc)
            cop = W_(nr, 0, cop)
            extra = W_(nr, d, extra)
            setup = setup | nr
        if ST_BC in c:
            m_ = c[ST_BC]
            b0 = m_ & (v == 0)
            bc = W_(m_, v, bc)
            cop = W_(b0, ref_len, cop)
            extra = W_(b0, d - ref_len, extra)
            setup = setup | b0
            bn = m_ & (v != 0)
            blk_i = W_(bn, 0, blk_i)
            blk_tot = W_(bn, 0, blk_tot)
            blk_cop = W_(bn, 0, blk_cop)
            st = W_(bn, ST_BLK, st)
        if ST_BLK in c:
            m_ = c[ST_BLK]
            first = m_ & (blk_i == 0)
            blk0 = W_(first, bval, blk0)
            cblk = W_(first, q1, cblk)
            blk_tot = W_(m_, tot, blk_tot)
            blk_cop = W_(m_, copc, blk_cop)
            blk_i = W_(m_, bi, blk_i)
            fin = m_ & (bi == bc)
            cop = W_(fin, cop_blk, cop)
            extra = W_(fin, d - cop_blk, extra)
            setup = setup | fin
        if ST_ICNT in c:
            m_ = c[ST_ICNT]
            icnt = W_(m_, v, icnt)
            i_idx = W_(m_, 0, i_idx)
            iprev = W_(m_, 0, iprev)
            ipos0 = W_(m_, q1, ipos0)
            st = W_(m_, W_(v > 0, ST_ILEFT, ST_RESF), st)
        if ST_ILEFT in c:
            m_ = c[ST_ILEFT]
            ileft = W_(m_, W_(i_idx == 0, _nat2int(v) + x, v + iprev + 1),
                       ileft)
            st = W_(m_, ST_ILEN, st)
        if ST_ILEN in c:
            m_ = c[ST_ILEN]
            iprev = W_(m_, ileft + ln, iprev)
            extra = W_(m_, ex, extra)
            i_idx = W_(m_, i_idx + 1, i_idx)
            fin = m_ & (i_idx == icnt)
            st = W_(m_ & ~fin, ST_ILEFT, st)
            st = W_(fin & (extra > 0), ST_RESF, st)
            init_e = fin & (extra <= 0)
        if ST_RESF in c:
            hs = c[ST_RESF] & (skip > 0)
            m_ = c[ST_RESF] & ~hs
            r_val = W_(m_, _nat2int(v) + x, r_val)
            r_rem = W_(m_, extra, r_rem)
            init_resf = m_
            # a split list's head: its residual rows are the preset lanes'
            wcur = W_(hs, wcur + skip, wcur)
            jump = W_(hs, skip, jump)
            skip = W_(hs, 0, skip)
            node_fin = node_fin | (hs & (d == jump))
            init_e = init_e | (hs & (d != jump))
        if any_cskip:
            m_ = cskip & ok
            c_idx = W_(m_, c_idx + v1 + 1, c_idx)
            krem = W_(m_, W_(more, v2 + 1, INF), krem)
            bj = W_(m_, bj + 2, bj)
            cblk = W_(m_, q2, cblk)
        if any_iload:
            m_ = iload & ok
            left = W_(i_next == 0, _nat2int(v1) + x, v1 + iprev + 1)
            iv = W_(m_, left, iv)
            ilen_rem = W_(m_, v2 + MININT, ilen_rem)
            iprev = W_(m_, left + v2 + MININT, iprev)
            i_next = W_(m_, i_next + 1, i_next)
            ipos = W_(m_, q2, ipos)
        if any_emit:
            m_ = emit & ok
            sel = torch.nonzero(m_).squeeze(1)
            store[(base + wcur)[sel]] = val[sel].to(torch.int32)
            wcur = W_(m_, wcur + 1, wcur)
            e_rem = W_(m_, e_rem - 1, e_rem)
            mc, mi, mr = m_ & win_c, m_ & win_i, m_ & win_r
            c_rem = W_(mc, c_rem - 1, c_rem)
            c_idx = W_(mc, c_idx + 1, c_idx)
            krem = W_(mc, krem - 1, krem)
            iv = W_(mi, iv + 1, iv)
            ilen_rem = W_(mi, ilen_rem - 1, ilen_rem)
            r_rem = W_(mr, r_rem - 1, r_rem)
            rg = mr & (r_rem > 0)
            r_val = W_(rg, r_val + v1 + 1, r_val)
            pos = W_(rg, q1, pos)
            node_fin = node_fin | (m_ & done_e)

        # -- setup: route to intervals / residuals / emission
        if setup is not nob:
            icnt = W_(setup, 0, icnt)
            init_e = init_e | (setup & (extra == 0))
            st = W_(setup & (extra != 0), ST_ICNT if MININT else ST_RESF,
                    st)
        # -- init_emit
        if init_e is not nob or init_resf is not nob:
            ie = init_e | init_resf
            # a split list's head that reaches its emit state unskipped
            bad_h = ie & (skip > 0)
            e_rem = W_(ie, d - jump, e_rem)
            r_rem = W_(init_e, 0, r_rem)
            cp = ie & (ref > 0) & (cop > 0)
            c_rem = W_(ie, W_(cp, cop, 0), c_rem)
            c_idx = W_(cp, 0, c_idx)
            bj = W_(cp, 0, bj)
            krem = W_(cp, W_(bc > 0, blk0, INF), krem)
            ilen_rem = W_(ie, 0, ilen_rem)
            i_next = W_(ie, 0, i_next)
            ipos = W_(ie, ipos0, ipos)
            iprev = W_(ie, 0, iprev)
            st = W_(ie & ~bad_h, ST_EMIT, W_(bad_h, ST_DONE, st))
            err = err | W_(bad_h, E_COUNT, 0)
        # -- node completion: window update, next node
        if node_fin is not nob:
            wm = node_fin[:, None] & (slots
                                      == torch.remainder(x, CYC)[:, None])
            win_d = W_(wm, d[:, None], win_d)
            win_row = W_(wm, nrow[:, None], win_row)
            nrow = W_(node_fin, wcur, nrow)
            node = W_(node_fin, node + 1, node)
            x = W_(node_fin, x + 1, x)
            st = W_(node_fin, W_(node >= n_nodes, ST_DONE, ST_OUTD), st)

        state = [pos, x, wcur, nrow, st, err, steps, node, d, ref, ref_len,
                 ref_row, cop, extra, bc, blk_i, blk_tot, blk_cop, blk0,
                 cblk, icnt, i_idx, iprev, ileft, ipos0, ipos, e_rem, c_rem,
                 c_idx, krem, bj, iv, ilen_rem, i_next, r_rem, r_val,
                 n_nodes, base, seg_len, win_d, win_row, skip, skip_bit, jump,
                 pre_end, pre_more, lane]

    return result.to(torch.int32)


def _count_below(store, a0, n, v, or_equal: bool):
    """Per element: how many of the n values from ``store[a0]`` on are
    below ``v`` (or equal, ``or_equal``), by the binary search of
    ``split_merge_kernel``'s ``count_below``, probe for probe."""
    lo = torch.zeros_like(n)
    n = n.clone()
    while bool((n > 0).any()):
        on = n > 0
        h = n >> 1
        y = store[torch.where(on, a0 + lo + h, 0)].to(torch.int64)
        go = on & ((y <= v) if or_equal else (y < v))
        lo = torch.where(go, lo + h + 1, lo)
        n = torch.where(go, n - h - 1, torch.where(on, h, n))
    return lo


def merge_split_plain(store: torch.Tensor, row0: torch.Tensor,
                      res: torch.Tensor, base: torch.Tensor) -> None:
    """The plain PyTorch twin of ``split_merge``: the same places, found by
    the same searches, one row an element."""
    total = int(base[-1])
    t = torch.arange(total, device=store.device)
    lst = torch.searchsorted(base[:-1], t, right=True) - 1
    k = t - base[lst]
    r = res[lst]
    d = base[lst + 1] - base[lst]
    a = row0[lst]
    v = store[a + k].to(torch.int64)
    head = k >= r      # the head lane's values, after the residuals
    at = torch.where(
        head, k - r + _count_below(store, a, torch.where(head, r, 0), v,
                                   False),
        k + _count_below(store, a + r, torch.where(head, 0, d - r), v, True))
    tmp = torch.empty(total, dtype=store.dtype, device=store.device)
    tmp[base[lst] + at] = v.to(store.dtype)
    store[a + k] = tmp


def merge_split(split: SplitPlan, store: torch.Tensor) -> None:
    """After B1: merge the residual rows and the head lane's rows of each
    split list with copies or intervals into the list's order, in place.
    CUDA tensors launch ``split_merge`` (two passes through a buffer), CPU
    tensors run :func:`merge_split_plain`."""
    if not split.merged:
        return
    if store.device.type != "cuda":
        merge_split_plain(store, split.merge_row0, split.merge_res,
                          split.merge_base)
        return
    tmp = torch.empty(split.merge_rows, dtype=torch.int32,
                      device=store.device)
    rc = _build.lib().wg_split_merge(
        store.data_ptr(), tmp.data_ptr(), split.merge_row0.data_ptr(),
        split.merge_res.data_ptr(), split.merge_base.data_ptr(),
        split.merge_tile.data_ptr(), split.merge_rows,
        _build.stream_ptr(store))
    _build.check(rc, "split_merge")
    _build.LAUNCHES["split_merge"] += 2     # its two passes, a launch each


def decode_chunked(plan: LanePlan) -> torch.Tensor:
    """Run the decode over every lane of the plan (into ``plan.store``),
    then merge the split lists that need it; returns the diagnostics, one
    row a lane of the lane table (the preset lanes after the chunks').

    Counter ``b1.split_arcs``: the arcs the preset lanes decoded."""
    diag = decode_lanes(plan.words, plan.meta, plan.store, plan.spec,
                        plan.order)
    count("b1.split_arcs", 0 if plan.split is None else plan.split.arcs)
    if plan.split is not None:
        merge_split(plan.split, plan.store)
    return diag


def lanes_flagged(plan: LanePlan, diag: torch.Tensor) -> torch.Tensor:
    """``check_diag(plan, diag) != 0`` on the diagnostics' device:
    bool[lanes], with no copy to the host."""
    L = plan.lanes
    f = ((diag[:L, DIAG_ERR] != 0)
         | (diag[:L, DIAG_WCUR] != plan.expect[:, 0])
         | (diag[:L, DIAG_NODES] != plan.expect[:, 1]))
    sp = plan.split
    if sp is None or not sp.segments:
        return f
    fp = ((diag[L:, DIAG_ERR] != 0) | (diag[L:, DIAG_WCUR] != sp.seg_wcur_t)
          | (diag[L:, DIAG_NODES] != 1))
    return f.to(torch.int32).index_add_(0, sp.seg_head_t,
                                        fp.to(torch.int32)) != 0


def check_diag(plan: LanePlan, diag) -> np.ndarray:
    """Per-lane error bits (int64[lanes]); nonzero means host fill.

    Beyond the kernel's own bits, cross-checks each lane's final row and
    node count against the plan: a desynced stream cannot pass both.  A
    preset lane's bits go to its split list's head lane."""
    d = diag.cpu().numpy() if isinstance(diag, torch.Tensor) else diag
    d = np.asarray(d, dtype=np.int64)
    L = plan.lanes
    err = d[:L, DIAG_ERR].copy()
    err |= np.where((d[:L, DIAG_WCUR] != plan.exp_arcs)
                    | (d[:L, DIAG_NODES] != plan.exp_nodes), E_COUNT, 0)
    sp = plan.split
    if sp is not None and sp.segments:
        ep = d[L:, DIAG_ERR] | np.where((d[L:, DIAG_WCUR] != sp.seg_wcur)
                                        | (d[L:, DIAG_NODES] != 1),
                                        E_COUNT, 0)
        np.bitwise_or.at(err, sp.seg_head, ep)
    return err
