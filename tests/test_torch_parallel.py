"""The port's multi-device decode (``parallel/sharded``) against the JAX
package's (``tests/test_parallel.py``), on CPU "devices" listed several
times, as the JAX tests list the 8 virtual CPU devices of ``conftest.py``.

- ``decode_sharded_kernel`` over D = 1, 2, 3 and 8 shares of one resolved
  plan equals the unsharded ``decode_to_csr`` (B1's plain version runs once
  per share);
- ``decode_sharded`` over 8 devices equals the JAX ``decode_sharded`` on its
  8-device CPU mesh, on ``test_parallel.py``'s graphs.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.ops import vdecode
from webgraph_tpu.parallel import sharded as JSH
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import expand_ranges
from webgraph_tpu_torch.ops import kcompact as PKC
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.csr import decode_to_csr, plan_csr_index
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.parallel import sharded as SH
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C

from .graphs import erdos_renyi

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _plan(tmp_path, n=400, p=0.04, seed=0, **store_kw):
    g = erdos_renyi(n, p, seed=seed)
    base = str(tmp_path / "g")
    JBV.store(g, base, **store_kw)
    bv = BVGraph.load(base)
    outd = PN.decode_outdegrees(bv.data, bv.offsets,
                                bv.settings.outdegree_coding)
    plan = PP.plan_kernel_decode(bv.offsets, outd, bv.settings, bv.data,
                                 device=CPU, target_arcs_per_lane=8)
    return g.to_csr(), plan


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_decode_sharded_kernel_matches_unsharded(tmp_path, D):
    exp, plan = _plan(tmp_path)
    assert plan.cold and plan.lanes % 3
    resolve_halos(plan)
    co, want, filled = decode_to_csr(plan)
    want = want.clone()
    assert filled == 0
    # the shards must write every chunk row: clear them (not the halo rows)
    rows = expand_ranges(plan.store_off[:-1] + plan.halo_arcs,
                         np.diff(plan.store_off) - plan.halo_arcs, CPU)
    plan.store[rows] = 0
    before = plan.store.clone()
    store, diag = SH.decode_sharded_kernel(plan, ["cpu"] * D)
    assert store is plan.store and not torch.equal(store, before)
    assert diag.shape == (plan.lanes, PK.DIAG_ROWS)
    assert not PK.check_diag(plan, diag).any()
    plan_csr_index(plan)
    got = PKC.compact(plan.compact_plan, store)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), exp.succ)
    np.testing.assert_array_equal(co, exp.offsets)


def test_decode_sharded_kernel_diag_matches_one_decode(tmp_path):
    """The diagnostics of 3 shares, concatenated, are those of one decode
    of every lane, STEPS included."""
    _exp, plan = _plan(tmp_path, seed=1)
    resolve_halos(plan)
    one = PK.decode_chunked(plan)
    _store, diag = SH.decode_sharded_kernel(plan, ["cpu", "cpu", "cpu"])
    assert torch.equal(diag, one)


def test_decode_sharded_kernel_rejects_unresolved_plan(tmp_path):
    _exp, plan = _plan(tmp_path)
    assert plan.cold and not plan.resolved
    with pytest.raises(ValueError, match="resolve"):
        SH.decode_sharded_kernel(plan, ["cpu"] * 2)


def test_make_mesh():
    assert SH.make_mesh(["cpu", torch.device("cpu")]) == (CPU, CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SH.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            SH.make_mesh(["cuda:0"])


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_sharded_matches_jax(tmp_path, seed):
    g = erdos_renyi(400, 0.04, seed=seed)
    base = str(tmp_path / "g")
    JBV.store(g, base)
    jbv = JBV.load(base)
    cfg = vdecode.config_from_settings(jbv.settings, batch=128)
    jco, jsu = JSH.decode_sharded(np.asarray(jbv.data), jbv.offsets, cfg,
                                  JSH.make_mesh())
    bv = BVGraph.load(base)
    co, su = SH.decode_sharded(bv.data, bv.offsets, bv.settings,
                               ["cpu"] * 8)
    np.testing.assert_array_equal(co, jco)
    np.testing.assert_array_equal(su, jsu)
    np.testing.assert_array_equal(su, g.to_csr().succ)


def test_decode_sharded_windowless_matches_jax(tmp_path):
    g = erdos_renyi(200, 0.05, seed=2)
    base = str(tmp_path / "g")
    JBV.store(g, base, window_size=0)
    jbv = JBV.load(base)
    cfg = vdecode.config_from_settings(jbv.settings, batch=64)
    jco, jsu = JSH.decode_sharded(np.asarray(jbv.data), jbv.offsets, cfg,
                                  JSH.make_mesh())
    bv = BVGraph.load(base)
    assert bv.settings.window_size == 0
    co, su = SH.decode_sharded(bv.data, bv.offsets, bv.settings,
                               ["cpu"] * 8)
    np.testing.assert_array_equal(co, jco)
    np.testing.assert_array_equal(su, jsu)


def test_decode_sharded_more_devices_than_nodes(tmp_path):
    """Empty ranges are skipped; the join is still the whole graph."""
    g = erdos_renyi(5, 0.5, seed=3)
    base = str(tmp_path / "g")
    JBV.store(g, base)
    bv = BVGraph.load(base)
    co, su = SH.decode_sharded(bv.data, bv.offsets, bv.settings,
                               ["cpu"] * 8)
    exp = g.to_csr()
    np.testing.assert_array_equal(co, exp.offsets)
    np.testing.assert_array_equal(su, exp.succ)


def test_decode_sharded_rejects_codes_outside_the_kernel(tmp_path):
    g = erdos_renyi(40, 0.1, seed=3)
    base = str(tmp_path / "g")
    BVGraph.store(g, base, settings=BVGraphSettings(
        residual_coding=C.GOLOMB))
    bv = BVGraph.load(base)
    with pytest.raises(ValueError, match="envelope"):
        SH.decode_sharded(bv.data, bv.offsets, bv.settings, ["cpu"] * 2)
