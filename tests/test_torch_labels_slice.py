"""The labelled slice as a whole: ``chip_smoke.py``'s ``labels`` phase path
on the CPU at a small size, against the JAX package.

A small synthetic web graph gets the phase's two label types -- a 10-bit
``FixedWidthIntLabel`` ``(x * 7 + t) % 1000`` and a ``GammaCodedIntLabel``
drawn from a seeded geometric distribution -- and goes through
``BVGraph.store_labelled(backend="cuda")`` (its torch ops on the CPU):
every file byte-identical to the JAX fused store, ``.graph`` and
``.offsets`` to the plain device store, the labels equal through the
phase's host decoders and through ``to_device``; then the combinators and
the labelled SCC, the labelled offline transforms and the labelled compose,
each equal to the JAX package's.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke as S
from webgraph_tpu import algo as JA
from webgraph_tpu import labelling as JL
from webgraph_tpu import transform as JT
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.labelling.graph import filter_labelled as j_filter
from webgraph_tpu_torch import algo as PA
from webgraph_tpu_torch import labelling as PL
from webgraph_tpu_torch import native
from webgraph_tpu_torch import transform as T
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.labelling.graph import filter_labelled
from webgraph_tpu_torch.settings import CompressionFlags as C

from .test_torch_algo_slice import synthetic
from .test_torch_labelled_transform import _jax_merge, _lists
from .test_torch_labelling import _arc_values, _pair, _same, _same_files

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 600


@pytest.fixture(scope="module")
def labelled():
    """The slice and both label types, in both packages."""
    co, su = synthetic(N)
    g = JCSR(co, su)
    rng = np.random.default_rng(8)
    vals = {"fixed10": _arc_values(g, lambda x, t: (x * 7 + t) % 1000),
            "gamma": rng.geometric(S.LABEL_GEOMETRIC_P, g.num_arcs) - 1}
    return g, {k: _pair(g, k, v) for k, v in vals.items()}


@pytest.mark.parametrize("kind", ["fixed10", "gamma"])
def test_labelled_store_and_load_match_jax(tmp_path, labelled, kind):
    g, pairs = labelled
    j, p = pairs[kind]
    dirs = {d: tmp_path / d for d in ("port", "jax", "plain")}
    for d in dirs.values():
        d.mkdir()
    base, jbase, plain = (str(dirs[d] / "slice")
                          for d in ("port", "jax", "plain"))
    BVGraph.store_labelled(p, base, base + "-labels", backend="cuda",
                           device=CPU)
    JBV.store_labelled(j, jbase, jbase + "-labels")
    BVGraph.store(p.graph, plain, backend="cuda", device=CPU)
    _same_files(jbase, base, (".graph", ".offsets"))
    _same_files(plain, base, (".graph", ".offsets"))
    _same_files(jbase + "-labels", base + "-labels",
                (".labels", ".labeloffsets"))
    # the phase's host decoders, independent of the device pack
    data = np.fromfile(base + "-labels.labels", dtype=np.uint8)
    lo = native.decode_offset_stream(
        np.fromfile(base + "-labels.labeloffsets", dtype=np.uint8), N,
        C.GAMMA)
    want = p.label_values().numpy()
    if kind == "fixed10":
        got = S.fixed_fields_numpy(data, g.num_arcs, 10)
        bits = np.full(g.num_arcs, 10)
    else:
        got = np.diff(native.decode_offset_stream(data, g.num_arcs - 1,
                                                  C.GAMMA), prepend=0)
        bits = S.gamma_bits_numpy(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lo, np.concatenate([[0], np.cumsum(bits)])
                                  [g.offsets])
    back = PL.BitStreamArcLabelledGraph.load(base + "-labels").to_device(CPU)
    assert back.report["graph"]["route"] == "kernel"
    assert back.equals_labelled(p)


def test_labelled_combinators_and_scc_match_jax(labelled):
    _g, pairs = labelled
    j, p = pairs["fixed10"]
    keep = range(S.LABEL_KEEP_BELOW)
    pred = PL.integer_label_filter(*keep)
    jpred = JL.graph.integer_label_filter(*keep)
    _same(filter_labelled(p, pred), j_filter(j, jpred))
    k, comp = PA.strongly_connected_components_labelled(p, pred)
    jk, jcomp = JA.strongly_connected_components_labelled(j, jpred)
    mask = p.label_values() < S.LABEL_KEEP_BELOW
    kf, compf = PA.strongly_connected_components(
        T.filter_arcs(p.graph, lambda a, b: mask))
    assert k == jk == kf
    np.testing.assert_array_equal(comp.numpy(), jcomp)
    assert torch.equal(comp, compf)
    r = PL.relabel(p, lambda v, a, b: 2 * v + 1, PL.GammaCodedIntLabel("W"))
    jr = JL.relabel(j, lambda l, a, b: JL.GammaCodedIntLabel(
        "W", 2 * l.value + 1), JL.GammaCodedIntLabel("W"))
    _same(r, jr)
    u = PL.union_labelled(p, r, lambda a, b: a + b)
    _same(u, JL.union_labelled(j, jr, _jax_merge(lambda a, b: a + b)))
    assert torch.equal(u.label_values(), 3 * p.label_values() + 1)


def test_labelled_offline_and_compose_match_jax(tmp_path, labelled):
    _g, pairs = labelled
    j, p = pairs["gamma"]
    batch = -(-p.num_arcs // S.OFFLINE_BATCHES)
    bt = T.transpose_offline_labelled(p, batch_size=batch,
                                      temp_dir=str(tmp_path))
    jbt = JT.transpose_offline_labelled(j, batch_size=batch,
                                        temp_dir=str(tmp_path))
    assert len(bt.batches) == len(jbt.batches) == S.OFFLINE_BATCHES
    once = bt.to_arc_labelled()
    assert _lists(once) == _lists(jbt.to_arc_labelled())
    bt.cleanup()
    jbt.cleanup()
    bt2 = T.transpose_offline_labelled(once, batch_size=batch,
                                       temp_dir=str(tmp_path))
    assert bt2.to_arc_labelled().equals_labelled(p)
    bt2.cleanup()
    merge = lambda a, b: a + b  # noqa: E731
    bs = T.symmetrize_offline_labelled(p, merge=merge, batch_size=2 * batch,
                                       temp_dir=str(tmp_path))
    jbs = JT.symmetrize_offline_labelled(j, merge=_jax_merge(merge),
                                         batch_size=2 * batch,
                                         temp_dir=str(tmp_path))
    assert bs.num_arcs == jbs.num_arcs == 2 * p.num_arcs
    assert _lists(bs.to_arc_labelled()) == _lists(jbs.to_arc_labelled())
    bs.cleanup()
    jbs.cleanup()
    sr = PL.LabelSemiring("amin", lambda a, b: a + b, 1 << 30, 0)
    jsr = JL.LabelSemiring(add=_jax_merge(min), multiply=_jax_merge(merge),
                           zero=JL.GammaCodedIntLabel("W", 1 << 30),
                           one=JL.GammaCodedIntLabel("W", 0))
    assert _lists(T.compose_labelled(p, p, sr)) == _lists(
        JT.compose_labelled(j, j, jsr))
