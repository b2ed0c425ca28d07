"""The slice as a whole: a graph encoded by the port's native encoder, cold
plan -> resolve_halos -> decode_to_csr -> CSRGraph.from_decoded, then the
analytics on that device CSR, against the JAX analytics on the original
CSR.  Integers exact; the neighbourhood function and distance sums at
``rtol = 1e-12``."""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as J
from webgraph_tpu import transform as T
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu_torch import algo as P
from webgraph_tpu_torch import native
from webgraph_tpu_torch import transform as PT
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.utils.stats import compute_stats
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from .graphs import erdos_renyi

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-12


def synthetic(n):
    """``synthesize_webgraph(n)`` with each list's distinct successors
    below ``n``, ascending (at this size its clipped lists run past n)."""
    co, su = synthesize_webgraph(n, seed=2)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(co))
    key = np.unique((rows * n + su)[su < n])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=co[1:])
    return co, key % n


def decoded(co, su) -> CSRGraph:
    s = BVGraphSettings()
    n = len(co) - 1
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=2)
    offsets = native.decode_offset_stream(offs, n, s.offset_coding)
    outd = native.decode_outdegrees(graph, offsets, s.outdegree_coding)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU)
    assert plan is not None and plan.cold
    pco, succ, filled = PC.decode_to_csr(plan)
    assert filled == 0
    return CSRGraph.from_decoded(pco, succ)


@pytest.mark.parametrize("which", ["synthetic", "erdos_renyi"])
def test_decode_then_analytics_match_jax(which):
    if which == "synthetic":
        co, su = synthetic(400)
    else:
        e = erdos_renyi(300, 0.02, seed=11)
        co, su = e.offsets, e.succ
    j = JCSR(co, su)
    g = decoded(co, su)
    np.testing.assert_array_equal(g.offsets.numpy(), co)
    np.testing.assert_array_equal(g.succ.numpy(), su)

    kw = dict(log2m=5, seed=1, do_sum_of_distances=True,
              do_sum_of_inverse_distances=True)
    jh = J.HyperBall(j, gt=j.transpose(), **kw)
    ph = P.HyperBall(g, gt=PT.transpose(g), **kw)
    np.testing.assert_allclose(ph.run(), jh.run(), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(ph.regs.numpy(), np.asarray(jh.regs))
    assert ph.mode_history == jh.mode_history
    assert ph.arcs_touched == jh.arcs_touched
    assert "systolic" in ph.mode_history or "local" in ph.mode_history
    np.testing.assert_allclose(ph.sum_of_distances.numpy(),
                               jh.sum_of_distances, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ph.sum_of_inverse_distances.numpy(),
                               jh.sum_of_inverse_distances, rtol=RTOL,
                               atol=0)

    jd, jr = J.bfs(j, [0])
    pd, pr = P.bfs(g, [0])
    assert pr == jr
    np.testing.assert_array_equal(pd.numpy(), jd)

    jk, jc = J.strongly_connected_components(j)
    pk, pc = P.strongly_connected_components(g)
    assert pk == jk
    np.testing.assert_array_equal(pc.numpy(), jc)

    np.testing.assert_array_equal(
        P.connected_components(PT.symmetrize(g)).numpy(),
        J.connected_components(T.symmetrize(j)))
    np.testing.assert_allclose(
        P.harmonic_centrality(g, batch=64).numpy(),
        J.harmonic_centrality(j, batch=64), rtol=RTOL, atol=0)
    st = compute_stats(g, pc)
    assert st["arcs"] == len(su) and st["sccs"] == jk
