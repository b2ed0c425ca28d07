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
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.resolve import resolve_halos

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
