"""The port's decode (B1, plain twin on the CPU) against the JAX package.

Same graphs and settings as tests/test_kdecode.py and tests/test_coldplan.py:
the JAX kernel runs in interpret mode, the port's ``decode_lanes`` runs its
plain PyTorch version on CPU tensors.  Every comparison is exact: successor
ids and diagnostic bits are integers.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu.codecs.bvgraph import CompressionFlags as C
from webgraph_tpu.core.graph import CSRGraph
from webgraph_tpu.ops import kdecode as K
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.core.graph import expand_ranges
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kcompact as PKC
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .graphs import (complete_binary_intree, complete_binary_outtree,
                     complete_graph, cycle_graph, erdos_renyi, star_graph)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _encode(g, tmp_path, **store_kwargs):
    base = str(tmp_path / "g")
    BVGraph.store(g, base, backend="python", **store_kwargs)
    bv = BVGraph.load(base)
    data = np.asarray(bv.data)
    outd = native.decode_outdegrees(data, bv.offsets,
                                    bv.settings.outdegree_coding)
    return bv, data, outd


def _port_csr(plan):
    """decode_to_csr with every lane clean (no host fill)."""
    co, succ, filled = PC.decode_to_csr(plan)
    errs = PK.check_diag(plan, PK.decode_chunked(plan))
    assert not errs.any(), f"port error bits {np.unique(errs[errs != 0])}"
    assert filled == 0
    return co, succ.numpy()


def _jax_warm(bv, data, outd, exp):
    prep = K.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                halo_csr=(exp.offsets, exp.succ))
    assert prep is not None
    out, diag = K.decode_chunked(prep)
    errs = K.check_diag(prep, diag)
    assert not errs.any(), f"JAX error bits {np.unique(errs[errs != 0])}"
    return K.chunked_to_csr(prep, out)


def _warm_both(g, tmp_path, **store_kwargs):
    """JAX warm decode vs the port's warm and cold decodes."""
    bv, data, outd = _encode(g, tmp_path, **store_kwargs)
    exp = g.to_csr()
    jco, jsu = _jax_warm(bv, data, outd, exp)
    for halo_csr in ((exp.offsets, exp.succ), None):   # warm, then cold
        plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                     device=CPU, halo_csr=halo_csr)
        assert plan is not None and plan.cold == (halo_csr is None)
        pco, psu = _port_csr(plan)
        np.testing.assert_array_equal(pco, jco)
        np.testing.assert_array_equal(psu, jsu)
        np.testing.assert_array_equal(psu, exp.succ)


@pytest.mark.parametrize("window,minint", [(0, 0), (0, 4), (1, 2), (2, 0),
                                           (3, 3), (7, 4)])
def test_warm_sweep_erdos_renyi(tmp_path, window, minint):
    _warm_both(erdos_renyi(150, 0.06, seed=9), tmp_path, window_size=window,
               max_ref_count=3, min_interval_length=minint)


def _empty_and_zero_degree():
    lists = [np.zeros(0, dtype=np.int64) for _ in range(20)]
    lists[3] = np.asarray([1, 2, 3, 4, 5], dtype=np.int64)
    lists[17] = np.asarray([0, 19], dtype=np.int64)
    return CSRGraph.from_lists(lists)


@pytest.mark.parametrize("gfn", [lambda: complete_graph(10),
                                 lambda: star_graph(40),
                                 lambda: cycle_graph(64),
                                 lambda: complete_binary_intree(5),
                                 lambda: complete_binary_outtree(5),
                                 _empty_and_zero_degree])
def test_graph_shapes_port_only(tmp_path, gfn):
    """The shapes of test_kdecode.py, warm and cold, against the lists."""
    g = gfn()
    bv, data, outd = _encode(g, tmp_path)
    exp = g.to_csr()
    for halo_csr in ((exp.offsets, exp.succ), None):
        plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                     device=CPU, halo_csr=halo_csr)
        pco, psu = _port_csr(plan)
        np.testing.assert_array_equal(pco, exp.offsets)
        np.testing.assert_array_equal(psu, exp.succ)


def test_warm_delta_codings(tmp_path):
    s = BVGraphSettings(outdegree_coding=C.DELTA, residual_coding=C.DELTA,
                        block_coding=C.GAMMA, window_size=4,
                        min_interval_length=2)
    _warm_both(erdos_renyi(100, 0.05, seed=2), tmp_path, settings=s)


def test_warm_gamma_residuals(tmp_path):
    s = BVGraphSettings(residual_coding=C.GAMMA, window_size=7,
                        min_interval_length=4)
    _warm_both(erdos_renyi(100, 0.08, seed=4), tmp_path, settings=s)


def test_warm_max_ref_one(tmp_path):
    _warm_both(erdos_renyi(120, 0.1, seed=8), tmp_path, window_size=7,
               max_ref_count=1)


@pytest.mark.parametrize("seed,kw", [
    (5, {}),
    (6, {"window_size": 0}),
    (11, {"settings": BVGraphSettings(outdegree_coding=C.DELTA,
                                      window_size=4,
                                      min_interval_length=2)})])
def test_cold_plan_matches_jax(tmp_path, seed, kw):
    """Cold plans (stream + offsets only): wavefront passes, then CSR."""
    g = erdos_renyi(180, 0.07, seed=seed)
    bv, data, outd = _encode(g, tmp_path, **kw)
    prep = K.plan_kernel_decode(bv.offsets, outd, bv.settings, data)
    assert prep is not None and prep.cold
    jpasses = K.resolve_halos(prep)
    out, diag, hv = K.decode_full(prep)
    errs = K.check_diag(prep, diag)
    assert not errs.any()
    jco, jsu = K.chunked_to_csr(prep, out, data=data, settings=bv.settings,
                                errs=errs, hub_vals=hv)
    plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                 device=CPU)
    assert plan.cold
    passes = resolve_halos(plan)
    assert (passes == 0) == (bv.settings.window_size == 0)
    assert (jpasses == 0) == (passes == 0)
    pco, psu = _port_csr(plan)
    np.testing.assert_array_equal(pco, jco)
    np.testing.assert_array_equal(psu, jsu)
    np.testing.assert_array_equal(psu, g.to_csr().succ)


def test_unsupported_config_returns_none(tmp_path):
    """Golomb residuals are outside both kernels' envelope."""
    s = BVGraphSettings(residual_coding=C.GOLOMB, zeta_k=3, window_size=2,
                        min_interval_length=2)
    g = erdos_renyi(50, 0.05, seed=1)
    base = str(tmp_path / "go")
    BVGraph.store(g, base, backend="python", settings=s)
    bv = BVGraph.load(base)
    outd = np.diff(g.to_csr().offsets)
    data = np.asarray(bv.data)
    assert K.plan_kernel_decode(bv.offsets, outd, bv.settings, data) is None
    assert PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                 device=CPU) is None


def test_corrupt_stream_flags(tmp_path):
    """A garbled stream raises error bits in both decoders."""
    g = erdos_renyi(80, 0.08, seed=3)
    base = str(tmp_path / "c")
    BVGraph.store(g, base, backend="python")
    bv = BVGraph.load(base)
    outd = np.diff(g.to_csr().offsets)
    data = np.asarray(bv.data).copy()
    data[len(data) // 2:] = 0xFF
    exp = g.to_csr()
    prep = K.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                halo_csr=(exp.offsets, exp.succ))
    _, diag = K.decode_chunked(prep)
    assert K.check_diag(prep, diag).any()
    plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                 device=CPU,
                                 halo_csr=(exp.offsets, exp.succ))
    errs = PK.check_diag(plan, PK.decode_chunked(plan))
    assert errs.any()
    # the first half of the stream still decodes clean
    assert not errs[plan.chunk_starts[1:] < 20].any()


def test_sliced_warm_plan_global_window_keys(tmp_path):
    """A slice whose first node is not a multiple of W+1: window slots must
    be keyed by global node id in both packages."""
    g = erdos_renyi(200, 0.05, seed=12)
    bv, data, _ = _encode(g, tmp_path, window_size=7, max_ref_count=3,
                          min_interval_length=3)
    exp = g.to_csr()
    outd = np.diff(exp.offsets)
    lo_p, lo, hi = 13, 13 + 21, 200
    assert lo_p % 8 != 0
    co_l = exp.offsets[lo_p:hi + 1] - exp.offsets[lo_p]
    su_l = exp.succ[exp.offsets[lo_p]:exp.offsets[hi]]
    offs_l = np.asarray(bv.offsets)[lo_p:hi + 1]
    kw = dict(halo_csr=(co_l, su_l), node_base=lo_p, first_node=lo - lo_p)
    prep = K.plan_kernel_decode(offs_l, outd[lo_p:hi], bv.settings, data,
                                **kw)
    out, diag = K.decode_chunked(prep)
    assert not K.check_diag(prep, diag).any()
    jco, jsu = K.chunked_to_csr(prep, out)
    plan = PP.plan_kernel_decode(offs_l, outd[lo_p:hi], bv.settings, data,
                                 device=CPU, **kw)
    pco, psu = _port_csr(plan)
    np.testing.assert_array_equal(pco, jco)
    np.testing.assert_array_equal(psu, jsu)
    np.testing.assert_array_equal(pco, exp.offsets[lo:hi + 1]
                                  - exp.offsets[lo])
    np.testing.assert_array_equal(
        psu, exp.succ[exp.offsets[lo]:exp.offsets[hi]])


def test_decode_lanes_rejects_bad_input():
    spec = PK.KernelSpec.from_settings(BVGraphSettings())
    words = torch.zeros(20, dtype=torch.int32)
    store = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros((3, PK.nmeta(7)), dtype=torch.int64)
    with pytest.raises(ValueError):
        PK.decode_lanes(words, meta.to(torch.int32), store, spec)
    with pytest.raises(ValueError):
        PK.decode_lanes(words, meta[:, :5].contiguous(), store, spec)
    preset = meta.clone()
    preset[0, PK.M_WIN + 16] = 3
    with pytest.raises(ValueError, match="preset"):
        PK.decode_lanes(words, preset, store, spec)
    outside = meta.clone()
    outside[2, PK.M_BASE], outside[2, PK.M_SEG] = 2, 3   # ends at 5 > 4
    with pytest.raises(ValueError, match="outside the store"):
        PK.decode_lanes(words, outside, store, spec)
    diag = PK.decode_lanes(words, meta, store, spec)   # all lanes empty
    assert diag.shape == (3, PK.DIAG_ROWS) and not diag.any()


def test_flagged_lane_is_host_filled(tmp_path):
    """A lane the decode flags is compacted as an invalid run and filled by
    the native host decoder; as a halo source it is patched on the host
    during resolve.  The CSR stays exact."""
    g = erdos_renyi(400, 0.05, seed=21)
    bv, data, outd = _encode(g, tmp_path)
    plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                 device=CPU, target_arcs_per_lane=4)
    assert plan.cold and len(plan.wf_chunk)
    lane = int(plan.wf_chunk[len(plan.wf_chunk) // 2])   # a halo source
    # expect one node more than the lane holds: check_diag flags it
    plan.exp_nodes[lane] += 1
    plan.expect[lane, 1] += 1
    resolve_halos(plan)
    co, succ, filled = PC.decode_to_csr(plan)
    cs = plan.chunk_starts
    assert filled == plan.cum_arcs[cs[lane + 1]] - plan.cum_arcs[cs[lane]]
    assert filled > 0
    exp = g.to_csr()
    np.testing.assert_array_equal(co, exp.offsets)
    np.testing.assert_array_equal(succ.numpy(), exp.succ)


@pytest.mark.parametrize("name", sorted(E.CASES))
def test_edge_cases_match_jax(name):
    """The decode kernel's edge inputs (``torch_edge_cases``): codes across
    the reader's refill point, a node with ~240 copy blocks and 40
    intervals, a lane holding one 6,000-arc node, a slice starting off the
    window's cycle.  The port's plain twin, warm and (unsliced) cold,
    against the JAX package's full decode, host fallback included."""
    co, su, s, kw, graph, offsets, outd = E.build(name)
    prep = K.plan_kernel_decode(offsets, outd, s, graph, **kw)
    assert prep is not None
    out, diag, hv = K.decode_full(prep)
    errs = K.check_diag(prep, diag)
    jco, jsu = K.chunked_to_csr(prep, out, data=graph, settings=s,
                                errs=errs, hub_vals=hv)
    first = kw.get("first_node", 0)
    exp_co = co[first:] - co[first]
    exp_su = su[co[first]:]
    np.testing.assert_array_equal(np.asarray(jco), exp_co)
    np.testing.assert_array_equal(np.asarray(jsu), exp_su)
    colds = [None] if kw.get("node_base", 0) == 0 else []
    for halo_csr in [kw["halo_csr"], *colds]:
        pkw = dict(kw, halo_csr=halo_csr)
        plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU,
                                     **pkw)
        if halo_csr is None:
            resolve_halos(plan)
        pco, psu = _port_csr(plan)
        np.testing.assert_array_equal(pco, np.asarray(jco))
        np.testing.assert_array_equal(psu, np.asarray(jsu))
    if name == "hub_lane":
        lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs
        one = np.diff(plan.chunk_starts) == 1
        assert (lane_arcs[one] >= 6000).any()


def test_decode_lanes_order_and_checks_once():
    """``order`` must be a permutation of the lanes; the lane table is
    checked once, and again after an in-place change."""
    spec = PK.KernelSpec.from_settings(BVGraphSettings())
    words = torch.zeros(20, dtype=torch.int32)
    store = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros((3, PK.nmeta(7)), dtype=torch.int64)
    for bad in ([0, 0, 1], [0, 1, 3], [0, 1]):
        with pytest.raises(ValueError):
            PK.decode_lanes(words, meta, store, spec,
                            torch.tensor(bad, dtype=torch.int32))
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    assert not PK.decode_lanes(words, meta, store, spec, order).any()
    meta[2, PK.M_BASE], meta[2, PK.M_SEG] = 2, 3   # now ends past the store
    with pytest.raises(ValueError, match="outside the store"):
        PK.decode_lanes(words, meta, store, spec, order)


def _bad_count(meta, L, W):
    meta[L, PK.preset_col(W)] = 1 << 30


def _bad_nodes(meta, L, W):
    meta[L, PK.M_NODES] = 2


def _bad_head_bit(meta, L, W):
    head = int(torch.nonzero(meta[:L, PK.preset_col(W)] < 0)[0])
    meta[head, PK.preset_col(W) + 1] = -1


# lane tables the wrapper refuses (the cases of the refusal of any preset
# lane before plans split lists)
SPLIT_REJECTS = {"reject_count_2_30": _bad_count,
                 "reject_preset_two_nodes": _bad_nodes,
                 "reject_head_bit_negative": _bad_head_bit}


def _native_csr(name, kw, s, graph):
    """``native.bv_decode_all`` of the case's whole graph, cut to the nodes
    the plan decodes."""
    co, su = E.SPLIT_CASES[name][0]()
    hco, hsu = PN.bv_decode_all(graph, len(co) - 1, len(su), s)
    lo = kw.get("node_base", 0) + kw.get("first_node", 0)
    return hco[lo:] - hco[lo], hsu[hco[lo]:]


@pytest.mark.parametrize("name", sorted(E.SPLIT_CASES) + ["corrupt_segment"]
                         + sorted(SPLIT_REJECTS))
def test_split_plan_matches_native(name):
    """Lists split across preset lanes (low ``split_arcs``/``seg_arcs``):
    pure residuals, intervals, copy blocks, adjacent split lists, runs cut
    by ``seg_bits``, a cold plan whose later node copies from a split list
    (``resolve_halos``), a shard's cold plan (``first_node`` > 0), a warm
    sliced plan (``node_base`` > 0).  The CSR equals ``native.bv_decode_all``
    with nothing filled on the host, and so does the plan's lanes decoded
    in three shares (``decode_sharded_kernel``).  ``corrupt_segment``: a
    preset lane starting a bit late flags its list, which the host fill
    decodes whole; the ``reject_*`` lane tables are refused."""
    from webgraph_tpu_torch.parallel.sharded import decode_sharded_kernel
    case = name if name in E.SPLIT_CASES else "copies"
    co, su, s, kw, graph, offsets, outd = E.build_split(case)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU, **kw)
    sp = plan.split
    assert sp is not None and sp.segments > len(sp.nodes) > 0
    assert (outd[sp.nodes] > kw["split_arcs"]).all()
    assert plan.meta.shape[0] == plan.lanes + sp.segments
    if name in SPLIT_REJECTS:
        SPLIT_REJECTS[name](plan.meta, plan.lanes, s.window_size)
        with pytest.raises(ValueError, match="preset"):
            PK.decode_chunked(plan)
        return
    if name == "corrupt_segment":
        plan.meta[plan.lanes + 3, PK.M_BIT] += 1
    resolve_halos(plan)
    pco, psu, filled = PC.decode_to_csr(plan)
    eco, esu = _native_csr(case, kw, s, graph)
    np.testing.assert_array_equal(pco, eco)
    np.testing.assert_array_equal(psu.numpy(), esu)
    if name == "corrupt_segment":
        assert filled == outd[sp.nodes[sp.heads == sp.seg_head[3]]].sum()
        return
    assert filled == 0
    rows = expand_ranges(plan.store_off[:-1] + plan.halo_arcs,
                         np.diff(plan.store_off) - plan.halo_arcs, CPU)
    plan.store[rows] = 0
    store, diag = decode_sharded_kernel(plan, ["cpu"] * 3)
    assert diag.shape == (plan.meta.shape[0], PK.DIAG_ROWS)
    assert not PK.check_diag(plan, diag).any()
    got = PKC.compact(plan.compact_plan, store)
    np.testing.assert_array_equal(got.numpy(), esu)


def test_split_plan_decodes_every_arc_each_call():
    """The plan holds no successor: with the store's chunk rows zeroed
    between two calls (its halo rows kept), both CSRs are the native
    decode's."""
    co, su, s, kw, graph, offsets, outd = E.build_split("cold_copied")
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU, **kw)
    assert plan.split.merged > 0
    eco, esu = _native_csr("cold_copied", kw, s, graph)
    rows = None
    for _ in range(2):
        pco, psu, filled = PC.decode_to_csr(plan)
        assert filled == 0
        np.testing.assert_array_equal(pco, eco)
        np.testing.assert_array_equal(psu.numpy(), esu)
        if rows is None:
            rows = expand_ranges(plan.store_off[:-1] + plan.halo_arcs,
                                 np.diff(plan.store_off) - plan.halo_arcs,
                                 CPU)
            plan.store[rows] = 0


def test_split_counters():
    """The plan's split counters and B1's split arcs, counted while a
    profiler records: lists over the threshold, preset lanes, lists merged,
    and the split lists' residuals once a decode."""
    from torch.profiler import ProfilerActivity, profile
    from webgraph_tpu_torch.utils import trace as T
    co, su, s, kw, graph, offsets, outd = E.build_split("adjacent")
    T.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU,
                                     **kw)
        for _ in range(2):
            PC.decode_to_csr(plan)
    c = T.counters()
    T.reset_counters()
    sp = plan.split
    over = np.flatnonzero(outd > kw["split_arcs"])
    hp = PN.hub_parse(graph, over, offsets[over], outd, s, kw["seg_arcs"],
                      PP.SEG_BITS)
    steps = int(PK.decode_chunked(plan)[:, PK.DIAG_STEPS].max())
    assert c == {"plan.split_lists": len(over),
                 "plan.split_segments": len(hp["cps"]),
                 "plan.split_merged": sp.merged,
                 "b1.split_arcs": 2 * int(hp["res_cnt"].sum()),
                 "b1.lane_steps": 2 * steps}
    assert len(over) == 3 and 0 < sp.merged < 3


def _gap_coded():
    """A crawl under the gap-coded setting (window 0, no intervals, delta
    residuals), planned cold: no halo, no preset lane."""
    co, su = E.simple(*synthesize_webgraph(3000, seed=6))
    s = BVGraphSettings(window_size=0, min_interval_length=0,
                        residual_coding=C.DELTA)
    graph, _gb, offs, _ob, _st = PN.bv_encode(co, su, s, threads=1)
    offsets = PN.decode_offset_stream(offs, len(co) - 1, s.offset_coding)
    return PP.plan_kernel_decode(offsets, np.diff(co), s, graph, device=CPU)


def _split_plan():
    co, su, s, kw, graph, offsets, outd = E.build_split("adjacent")
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU, **kw)
    assert plan.meta.shape[0] > plan.lanes        # preset lanes
    return plan


@pytest.mark.parametrize("make", [_split_plan, _gap_coded])
def test_lane_steps_counter(make):
    """``b1.lane_steps``: each ``decode_to_csr`` call's largest
    ``DIAG_STEPS`` over every lane of ``decode_chunked`` (the preset
    lanes too), counted while a profiler records and not without one."""
    from torch.profiler import ProfilerActivity, profile
    from webgraph_tpu_torch.utils import trace as T
    plan = make()
    T.reset_counters()
    PC.decode_to_csr(plan)
    assert T.counters() == {}
    steps = PK.decode_chunked(plan)[:, PK.DIAG_STEPS]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            PC.decode_to_csr(plan)
    c = T.counters()
    T.reset_counters()
    assert c["b1.lane_steps"] == 3 * int(steps.max()) > 0
    if plan.split is not None:
        assert int(steps[plan.lanes:].max()) > 0
