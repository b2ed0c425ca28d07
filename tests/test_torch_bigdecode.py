"""The port's sliced decode (``ops/bigdecode.py``) against the JAX package's.

``decode_big_slices`` on the CPU runs the plain versions of B1 and B2 per
slice; the JAX function runs its Pallas kernel in interpret mode, as
``tests/test_bigbv.py`` runs it.  Every slice -- its bounds, its offsets and
its successors -- must be equal, and the concatenation must equal
``native.bv_decode_all``:

- at ``test_bigbv.py``'s size and slice length, and in three more stream
  formats (gamma/delta with w=0 and no intervals; zeta_3 with minInterval 4;
  w=7 with maxRefCount 3);
- with slices whose first halo node is not a multiple of W+1 (the window
  slots are keyed by global node id, ``ops/kplan.py``);
- outside the kernel's envelope (Golomb residuals, a window above 7), where
  the native decode is the slice;
- on a hub whose copy chain ends in intervals, one plan and sliced with the
  slice edge inside the chain;
- n >= 2^31 raises before anything is allocated.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.core import graph as jcore
from webgraph_tpu.ops.bigdecode import decode_big_slices as j_slices
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import load_csr
from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
from webgraph_tpu_torch.ops.ef_index import build_ef
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from .graphs import erdos_renyi

torch.set_num_threads(1)
CPU = torch.device("cpu")
SETTINGS = {
    "gd_w0_noint": BVGraphSettings(window_size=0, min_interval_length=0,
                                   outdegree_coding=C.DELTA,
                                   residual_coding=C.GAMMA),
    "zeta3_int4": BVGraphSettings(window_size=4, min_interval_length=4,
                                  zeta_k=3),
    "w7_maxref3": BVGraphSettings(window_size=7, max_ref_count=3,
                                  min_interval_length=2),
}


def _web(n, seed):
    """A web-like graph: ``synthesize_webgraph``'s lists (locality, runs,
    near-copies of a neighbour's list) folded into [0, n), each sorted and
    deduplicated (at small n the generator emits ids past n)."""
    co, su = synthesize_webgraph(n, seed=seed)
    lists = [np.unique(su[co[x]:co[x + 1]] % n) for x in range(n)]
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=out[1:])
    return out, np.concatenate(lists).astype(np.int64)


def _encode(co, su, s):
    n = len(co) - 1
    graph_b, _gb, offs_b, _ob, _st = PN.bv_encode(co, su, s, threads=1)
    offsets = PN.decode_offset_stream(offs_b, n, s.offset_coding)
    return graph_b, offsets


def _port(co, graph_b, offsets, s, slice_arcs, **kw):
    rep = []
    out = [(lo, hi, c.numpy(), su.numpy()) for lo, hi, c, su in
           decode_big_slices(offsets, np.diff(co), s, graph_b,
                             slice_arcs=slice_arcs, device=CPU, report=rep,
                             **kw)]
    for _lo, _hi, c, su in out:
        assert c.dtype == np.int64 and su.dtype == np.int32
    return out, rep


def _jax(co, graph_b, offsets, s, slice_arcs, **kw):
    return list(j_slices(offsets, np.diff(co), JSettings(**asdict(s)),
                         graph_b, slice_arcs=slice_arcs, **kw))


def _same_slices(got, want):
    assert [(lo, hi) for lo, hi, _, _ in got] == [
        (lo, hi) for lo, hi, _, _ in want]
    for (_, _, c, su), (_, _, jc, jsu) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(su, jsu)


def _whole(got, co, su):
    """The slices tile [0, n) and concatenate to the native decode."""
    x = 0
    for lo, hi, c, s in got:
        assert lo == x and c[0] == 0 and c[-1] == len(s)
        np.testing.assert_array_equal(c, co[lo:hi + 1] - co[lo])
        x = hi
    assert x == len(co) - 1
    np.testing.assert_array_equal(
        np.concatenate([s for *_, s in got]).astype(np.int64), su)


def test_bigbv_size_equal_to_jax():
    """``tests/test_bigbv.py``'s case: its graph, settings, slice length."""
    g = erdos_renyi(1500, 0.02, seed=4)
    s = BVGraphSettings()
    graph_b, offsets = _encode(g.offsets, g.succ, s)
    got, rep = _port(g.offsets, graph_b, offsets, s, 11_000,
                     target_arcs_per_lane=16)
    assert len(got) >= 3 and {r["route"] for r in rep} == {"kernel"}
    want = _jax(g.offsets, graph_b, offsets, s, 11_000,
                target_arcs_per_lane=16, v_cap=128, r_cap=96)
    _same_slices(got, want)
    hco, hsu = PN.bv_decode_all(graph_b, 1500, g.num_arcs, s)
    _whole(got, hco, hsu)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_formats_equal_to_jax(name):
    s = SETTINGS[name]
    co, su = _web(800, seed=3)
    graph_b, offsets = _encode(co, su, s)
    got, rep = _port(co, graph_b, offsets, s, 4_000)
    assert len(got) >= 3 and {r["route"] for r in rep} == {"kernel"}
    assert all(r["fallback_arcs"] == 0 for r in rep)
    _same_slices(got, _jax(co, graph_b, offsets, s, 4_000))
    hco, hsu = PN.bv_decode_all(graph_b, len(co) - 1, len(su), s)
    _whole(got, hco, hsu)


@pytest.mark.parametrize("slice_arcs", [997, 2_501, 4_099])
def test_slices_keyed_by_global_node(slice_arcs):
    """Slices whose first halo node is not a multiple of W+1 decode right
    (the window slots are keyed by global node id)."""
    s = BVGraphSettings()
    co, su = _web(2000, seed=8)
    graph_b, offsets = _encode(co, su, s)
    got, rep = _port(co, graph_b, offsets, s, slice_arcs)
    halo_n = s.window_size * s.max_ref_count
    bases = [max(r["lo"] - halo_n, 0) for r in rep]
    assert any(b % (s.window_size + 1) for b in bases), bases
    hco, hsu = PN.bv_decode_all(graph_b, len(co) - 1, len(su), s)
    _whole(got, hco, hsu)


@pytest.mark.parametrize("kw", [dict(residual_coding=C.GOLOMB),
                                dict(window_size=9)])
def test_outside_the_envelope_takes_the_native_slice(kw):
    s = BVGraphSettings(**kw)
    co, su = _web(900, seed=4)
    graph_b, offsets = _encode(co, su, s)
    got, rep = _port(co, graph_b, offsets, s, 5_000)
    assert len(got) >= 2 and {r["route"] for r in rep} == {"native"}
    hco, hsu = PN.bv_decode_all(graph_b, len(co) - 1, len(su), s)
    _whole(got, hco, hsu)


@pytest.mark.parametrize("slice_arcs", [1, 300, 1 << 40])
def test_slice_lengths(slice_arcs):
    """A slice per node, a few, and one slice for the whole graph."""
    g = erdos_renyi(120, 0.05, seed=1)
    s = BVGraphSettings()
    graph_b, offsets = _encode(g.offsets, g.succ, s)
    got, _ = _port(g.offsets, graph_b, offsets, s, slice_arcs)
    if slice_arcs == 1:
        assert len(got) >= 100
    if slice_arcs == 1 << 40:
        assert len(got) == 1
    hco, hsu = PN.bv_decode_all(graph_b, 120, g.num_arcs, s)
    _whole(got, hco, hsu)


def test_offsets_as_an_elias_fano_list():
    """``offsets`` may be an ``EliasFanoMonotoneList`` (a ``.obl`` cache's
    form), read by index and by slice."""
    co, su = _web(700, seed=2)
    s = BVGraphSettings()
    graph_b, offsets = _encode(co, su, s)
    ef = build_ef(offsets)
    assert not isinstance(ef, np.ndarray)
    got, _ = _port(co, graph_b, ef, s, 4_000)
    _whole(got, co, su)


class _Huge:
    """An outdegree array of 2^31 nodes that holds nothing."""

    def __len__(self):
        return 1 << 31

    def __array__(self, *a, **k):
        raise AssertionError("the outdegrees were allocated")


def test_two_to_the_31_nodes_raises():
    with pytest.raises(ValueError, match="2\\^31"):
        next(decode_big_slices(None, _Huge(), BVGraphSettings(), None,
                               device=CPU))


def _hub_graph():
    """A sparse random graph with a hub chain: node 1000 holds 1,200
    consecutive successors (stored as intervals); 1001-1003 each repeat the
    previous list with a few changes, so each copies the one before and the
    chain's ultimate source is the intervals of node 1000."""
    n = 3000
    rng = np.random.default_rng(11)
    lists = [np.unique(rng.integers(0, n, rng.integers(0, 4)))
             for _ in range(n)]
    hub = np.arange(1500, 2700, dtype=np.int64)
    for k, x in enumerate(range(1000, 1004)):
        lists[x] = hub
        hub = np.union1d(np.delete(hub, np.arange(k, len(hub), 97)),
                         [10 + k, n - 10 + k])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=co[1:])
    return co, np.concatenate(lists).astype(np.int64)


def test_hub_chain_ending_in_intervals(tmp_path):
    """ROADMAP A4: a hub copy whose ultimate source is an interval, decoded
    in one plan (cold, through ``load_csr``) and sliced with the slice edge
    inside the hub's chain; both equal the native decode and the JAX
    package's decode of the same basename."""
    co, su = _hub_graph()
    s = BVGraphSettings()
    graph_b, offsets = _encode(co, su, s)
    refs = PN.bv_scan_refs(graph_b, offsets, s)
    assert all(refs[x] == 1 for x in range(1001, 1004)), refs[1000:1004]
    hco, hsu = PN.bv_decode_all(graph_b, len(co) - 1, len(su), s)
    np.testing.assert_array_equal(hsu, su)

    from webgraph_tpu_torch.core.graph import CSRGraph
    base = str(tmp_path / "hub")
    BVGraph.store(CSRGraph(co, su, device=CPU), base)
    one = load_csr(base, device=CPU)
    assert one.report["route"] == "kernel"
    np.testing.assert_array_equal(one.offsets.numpy(), hco)
    np.testing.assert_array_equal(one.succ.numpy(), hsu)

    # the first slice ends at node 1002: the edge is inside the chain
    edge = int(co[1002])
    got, rep = _port(co, graph_b, offsets, s, edge)
    assert rep[0]["hi"] == 1002
    _whole(got, hco, hsu)
    want = jcore.load(base).to_csr()
    np.testing.assert_array_equal(want.offsets, hco)
    np.testing.assert_array_equal(want.succ, hsu)
