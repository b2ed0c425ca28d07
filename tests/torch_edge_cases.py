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
    return _build_case(*CASES[name])


def _build_case(make, s, kw):
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


# -- lists split across preset lanes (kplan.SPLIT_ARCS), at low thresholds --

SPLIT_KW = dict(split_arcs=300, seg_arcs=64, target_arcs_per_lane=32)


def _with_hubs(n: int, seed: int, hubs) -> tuple:
    """``synthesize_webgraph(n)`` kept simple, with the lists of the nodes
    in ``hubs`` ({node: list}) replaced."""
    from webgraph_tpu_torch.utils.synth import synthesize_webgraph
    co, su = simple(*synthesize_webgraph(n, seed=seed))
    lists = [su[co[x]:co[x + 1]] for x in range(n)]
    for x, lst in hubs.items():
        lists[x] = np.unique(np.asarray(lst, dtype=np.int64))
    return _csr(lists)


def _rand(seed: int, n: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(n, size=d, replace=False)


def _runs(seed: int, n: int, runs: int, length: int) -> np.ndarray:
    """``runs`` runs of ``length`` consecutive ids (intervals) below n."""
    lefts = np.random.default_rng(seed).choice(n // (2 * length), runs,
                                              replace=False) * 2 * length
    return (lefts[:, None] + np.arange(length)[None, :]).ravel()


def _split_residual():
    return _with_hubs(3000, 1, {40: _rand(1, 3000, 900),
                                1500: _rand(2, 3000, 1200)})


def _split_intervals():
    return _with_hubs(3000, 2, {700: np.concatenate(
        [_rand(3, 3000, 500), _runs(4, 3000, 30, 6)])})


def _split_copies():
    hub = _rand(5, 3000, 1000)
    kept = np.delete(hub, np.arange(0, len(hub), 5))
    return _with_hubs(3000, 3, {700: hub, 703: np.concatenate(
        [kept, _rand(6, 3000, 60)])})


def _split_adjacent():
    return _with_hubs(3000, 4, {200 + i: _rand(10 + i, 3000, 400 + 150 * i)
                                for i in range(3)})


def _split_copied_by_later():
    """A split list that a later, short list copies from, in another
    chunk: its halo list is the split list's rows."""
    hub = np.sort(_rand(7, 3000, 800))
    return _with_hubs(3000, 5, {500: hub, 503: hub[::4]})


def _split_shard():
    hub = np.sort(_rand(8, 3000, 700))
    return _with_hubs(3000, 6, {1000: hub, 1003: hub[::3],
                                1800: _rand(9, 3000, 950)})


def _split_sliced():
    return _with_hubs(1500, 7, {60: _rand(11, 1500, 500),
                                61: _rand(12, 1500, 450)})


SPLIT_CASES = {
    # name: (graph, settings, plan keywords); "cold" plans from the stream
    # alone, "slice" as in CASES, "first_node" a shard's cold plan
    "pure_residual": (_split_residual, BVGraphSettings(**_SETTINGS_W0),
                      dict(SPLIT_KW)),
    "intervals": (_split_intervals, BVGraphSettings(
        window_size=0, min_interval_length=4, residual_coding=C.GAMMA),
        dict(SPLIT_KW)),
    "copies": (_split_copies, BVGraphSettings(residual_coding=C.DELTA),
               dict(SPLIT_KW)),
    "adjacent": (_split_adjacent, BVGraphSettings(), dict(SPLIT_KW)),
    "bit_cut": (_split_residual, BVGraphSettings(),
                dict(SPLIT_KW, seg_arcs=4096, seg_bits=300)),
    "cold_copied": (_split_copied_by_later, BVGraphSettings(),
                    dict(SPLIT_KW, cold=True)),
    "shard": (_split_shard, BVGraphSettings(),
              dict(SPLIT_KW, cold=True, first_node=1000)),
    "sliced": (_split_sliced, BVGraphSettings(min_interval_length=3),
               dict(SPLIT_KW, slice=(13, 34))),
}


def build_split(name: str):
    """Case ``name`` of ``SPLIT_CASES`` as :func:`build` gives a case of
    ``CASES``; the plan keywords of a cold case carry ``halo_csr=None``."""
    make, s, kw = SPLIT_CASES[name]
    kw = dict(kw)
    cold = kw.pop("cold", False)
    co, su, s, kw, graph, offsets, outd = _build_case(make, s, kw)
    if cold:
        kw["halo_csr"] = None
    return co, su, s, kw, graph, offsets, outd
