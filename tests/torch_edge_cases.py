"""Inputs at the edges of the decode kernel's design, shared by the CPU and
card tests of the port (numpy and the port only: the card's machine has no
jax).

Each case is a CSR graph, the settings it is encoded with, and the plan's
keyword arguments:

* ``straddle_*``: successor ids up to ~2^31, so residual codes carry
  mantissas of up to 31 bits, at every bit offset mod 32 of the stream: each
  code crosses the reader's 32-bit refill point somewhere;
* ``many_blocks``: a node copying its reference in ~120 kept runs (~240 copy
  blocks) and holding 40 intervals;
* ``hub_lane``: one node of 6,000 arcs, alone in its lane;
* ``sliced``: a warm plan whose first node is not a multiple of W + 1.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch import native
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C


def _csr(lists):
    co = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in lists], out=co[1:])
    su = (np.concatenate(lists) if co[-1] else np.zeros(0)).astype(np.int64)
    return co, su


def _straddle(seed: int = 0):
    rng = np.random.default_rng(seed)
    lists = []
    for x in range(240):
        k = int(rng.integers(0, 7))
        if x % 5 == 0:
            k = 0   # empty lists shift the next codes by a bit or two
        hi = (1 << 31) - 2 if x % 2 else 1 << int(rng.integers(4, 31))
        lists.append(np.unique(rng.integers(0, hi, k)))
    return _csr(lists)


def _many_blocks():
    base = np.arange(600, dtype=np.int64)
    keep = base[(base % 5) < 3]                  # runs of 3, gaps of 2
    ints = np.concatenate([10_000 + 20 * k + np.arange(5)
                           for k in range(40)])  # 40 intervals of 5
    lists = [np.zeros(0, np.int64)] * 3 + [base, np.unique(
        np.concatenate([keep, ints, [50_000, 60_123]]))]
    lists += [np.arange(x, x + 3) for x in range(5, 40)]
    return _csr(lists)


def _hub_lane():
    lists = [np.array([1, 2, 3]) + x for x in range(30)]
    lists.append(np.unique(np.random.default_rng(1).integers(0, 90_000,
                                                              7000))[:6000])
    lists += [np.array([x, x + 7]) for x in range(31, 60)]
    return _csr(lists)


def _sliced():
    rng = np.random.default_rng(12)
    lists = [np.unique(rng.integers(0, 200, int(rng.integers(0, 20))))
             for _ in range(200)]
    return _csr(lists)


_SETTINGS_W0 = dict(window_size=0, min_interval_length=0)

CASES = {
    "straddle_gamma": (_straddle, BVGraphSettings(
        residual_coding=C.GAMMA, **_SETTINGS_W0), {}),
    "straddle_delta": (_straddle, BVGraphSettings(
        residual_coding=C.DELTA, outdegree_coding=C.DELTA,
        **_SETTINGS_W0), {}),
    "straddle_zeta3": (_straddle, BVGraphSettings(**_SETTINGS_W0), {}),
    "many_blocks": (_many_blocks, BVGraphSettings(window_size=1,
                                                  min_interval_length=4),
                    {"target_arcs_per_lane": 8}),
    "hub_lane": (_hub_lane, BVGraphSettings(), {"target_arcs_per_lane": 16}),
    "sliced": (_sliced, BVGraphSettings(window_size=7, min_interval_length=3),
               {"slice": (13, 34)}),
}


def build(name: str):
    """(co, su, settings, plan kwargs, encoded stream, bit offsets,
    outdegrees) of case ``name``, the stream by the port's native encoder;
    the plan is warm (``halo_csr`` is the CSR).  A ``slice`` (lo_p, lo)
    entry makes a sliced plan: ``node_base=lo_p``, ``first_node=lo - lo_p``,
    and the returned CSR, offsets and outdegrees are the slice's own, from
    node lo_p on."""
    make, s, kw = CASES[name]
    co, su = make()
    n = len(co) - 1
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s)
    offsets = native.decode_offset_stream(offs, n, s.offset_coding)
    outd = np.diff(co)
    kw = dict(kw)
    if "slice" in kw:
        lo_p, lo = kw.pop("slice")
        co, su = co[lo_p:] - co[lo_p], su[co[lo_p]:]
        kw.update(node_base=lo_p, first_node=lo - lo_p)
        offsets, outd = offsets[lo_p:], outd[lo_p:]
    kw["halo_csr"] = (co, su)
    return co, su, s, kw, graph, offsets, outd


def simple(co, su):
    """``synthesize_webgraph`` below a few thousand nodes may list a
    successor twice or past n: keep each list's distinct successors below
    n, ascending."""
    n = len(co) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(co))
    key = np.unique((rows * n + su)[su < n])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=co[1:])
    return co, key % n


def check_store(plan, store, co, su) -> None:
    """Every lane's chunk rows in ``store`` hold its nodes' lists (``co``,
    ``su``: the plan-local CSR)."""
    cs, cum = plan.chunk_starts, plan.cum_arcs
    cnt = cum[cs[1:]] - cum[cs[:-1]]
    first = plan.store_off[:-1] + plan.halo_arcs
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    got = np.asarray(store)[np.repeat(first, cnt) + within]
    exp = np.asarray(su)[np.repeat(cum[cs[:-1]], cnt) + within]
    np.testing.assert_array_equal(got, exp)


GARBLES = ("clean", "ones", "random", "zeros", "flips")


def garble(data, how):
    """A copy of the stream bytes ``data`` damaged as ``how`` names."""
    data = data.copy()
    rng = np.random.default_rng(len(data))
    if how == "ones":
        data[len(data) // 2:] = 0xFF
    elif how == "random":
        k = len(data) // 3
        data[k:] = rng.integers(0, 256, len(data) - k, dtype=np.uint8)
    elif how == "zeros":
        data[len(data) // 4:] = 0
    elif how == "flips":
        pos = rng.integers(0, len(data) * 8, 40)
        np.bitwise_xor.at(data, pos // 8, (1 << (pos % 8)).astype(np.uint8))
    return data
