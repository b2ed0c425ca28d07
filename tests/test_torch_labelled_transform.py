"""The port's labelled transforms against ``webgraph_tpu/transform/labelled``.

The labelled cases of ``tests/test_labelling.py`` (transpose, symmetrize
with a merge, compose with a semiring) and the traps of their semantics run
through both packages on the same input: a merge whose operands cannot be
swapped (``a - 2 * b``), loops, duplicate arcs with ``merge=None`` (the
first occurrence in batch order wins), list labels carried through a
transpose, compositions where g0 and g1 differ in size.  Each
``LabelledBatchGraph`` is read both ways -- ``iter_labelled`` node by node
and ``to_arc_labelled`` in bulk -- and both equal the JAX merge; its
``num_arcs`` is the JAX class's (pairs spilled, ROADMAP C5).  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import labelling as JL
from webgraph_tpu import transform as JT
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu_torch import labelling as PL
from webgraph_tpu_torch import transform as T
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .graphs import cycle_graph, erdos_renyi
from .test_torch_labelling import _arc_values, _list_pair, _pair

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _jax_merge(fn):
    return lambda a, b: JL.GammaCodedIntLabel("W", int(fn(a.value, b.value)))


def _lists(g):
    """{(x, t): label value} and the per-node lists of a labelled graph in
    either package (port: ``iter_labelled`` yields tensors or arrays)."""
    vals, lists = {}, []
    for x, succ, labs in g.iter_labelled():
        succ = np.asarray(succ, dtype=np.int64)
        lists.append(succ.tolist())
        for t, l in zip(succ.tolist(), labs):
            vals[(x, t)] = (l.value.tolist() if isinstance(l.value, np.ndarray)
                            else l.value)
    return lists, vals


def _same_both_ways(bg, jbg, tmp_cleanup=True):
    """A port LabelledBatchGraph equals the JAX one node by node and in
    bulk; returns the bulk graph."""
    want = _lists(jbg)
    assert bg.num_arcs == jbg.num_arcs and bg.num_nodes == jbg.num_nodes
    assert _lists(bg) == want
    bulk = bg.to_arc_labelled()
    assert _lists(bulk) == want
    bg.cleanup()
    jbg.cleanup()
    return bulk


SYNTH = {
    "er": lambda: erdos_renyi(50, 0.08, seed=3),
    "er_loops": lambda: erdos_renyi(40, 0.1, seed=7, loops=True),
    "synth": lambda: JCSR(*E.simple(*synthesize_webgraph(400, seed=5))),
}


@pytest.mark.parametrize("name", sorted(SYNTH))
def test_transpose_offline_labelled(tmp_path, name):
    g = SYNTH[name]()
    j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: (3 * x + t) % 100))
    bt = T.transpose_offline_labelled(p, batch_size=37,
                                      temp_dir=str(tmp_path))
    assert len(bt.batches) > 1
    got = _same_both_ways(bt, JT.transpose_offline_labelled(
        j, batch_size=37, temp_dir=str(tmp_path)))
    exp = {(t, x): v for (x, t), v in _lists(j)[1].items()}
    assert _lists(got)[1] == exp
    # double transpose is the identity (labelled)
    bt2 = T.transpose_offline_labelled(got, batch_size=41,
                                       temp_dir=str(tmp_path))
    back = bt2.to_arc_labelled()
    bt2.cleanup()
    assert back.equals_labelled(p)


def test_transpose_offline_list_labels(tmp_path):
    g = erdos_renyi(30, 0.15, seed=2)
    j, p = _list_pair(g, "int12", lambda x, t: list(range(x % 4)) + [t])
    _same_both_ways(
        T.transpose_offline_labelled(p, batch_size=23,
                                     temp_dir=str(tmp_path)),
        JT.transpose_offline_labelled(j, batch_size=23,
                                      temp_dir=str(tmp_path)))


SYMMETRIZE = {
    # the JAX case: reciprocal arcs merge by a sum
    "jax_case_sum": (lambda: JCSR.from_lists(
        [np.asarray(l, dtype=np.int64) for l in [[1, 2], [0], [3], []]]),
        lambda x, t: 10 * x + t, lambda a, b: a + b, 3),
    # operands that cannot be swapped, loops, reciprocal arcs
    "er_loops_noncommutative": (lambda: erdos_renyi(40, 0.12, seed=7,
                                                    loops=True),
                                lambda x, t: (7 * x + 3 * t) % 50,
                                lambda a, b: a - 2 * b + 1000, 29),
    "synth_noncommutative": (lambda: JCSR(*E.simple(*synthesize_webgraph(
        300, seed=4))), lambda x, t: (x + 5 * t) % 64,
        lambda a, b: 3 * a - b + 500, 101),
}


@pytest.mark.parametrize("name", sorted(SYMMETRIZE))
def test_symmetrize_offline_labelled_merge(tmp_path, name):
    fg, fl, merge, batch = SYMMETRIZE[name]
    g = fg()
    j, p = _pair(g, "gamma", _arc_values(g, fl))
    bs = T.symmetrize_offline_labelled(p, merge=merge, batch_size=batch,
                                       temp_dir=str(tmp_path))
    jbs = JT.symmetrize_offline_labelled(j, merge=_jax_merge(merge),
                                         batch_size=batch,
                                         temp_dir=str(tmp_path))
    got = _lists(_same_both_ways(bs, jbs))[1]
    # the operands: label(min, max) first, label(max, min) second
    lab = _lists(j)[1]
    for (x, t), v in got.items():
        a, b = lab.get((min(x, t), max(x, t))), lab.get((max(x, t), min(x, t)))
        if a is not None and b is not None:
            assert v == merge(a, b) if x != t else v == merge(a, a)
        else:
            assert v == (a if a is not None else b)
    if name == "jax_case_sum":
        assert got[(0, 1)] == 11 and got[(1, 0)] == 11
        assert got[(0, 2)] == 2 and got[(2, 0)] == 2
        assert got[(2, 3)] == 23 and got[(3, 2)] == 23


@pytest.mark.parametrize("merge", [None, "sub"])
def test_duplicate_keys_across_and_within_batches(tmp_path, merge):
    """Spilled triples with repeated arcs, in two batches: ``merge=None``
    keeps the first occurrence in batch order, a merge folds them in that
    order, as the JAX class does."""
    rng = np.random.default_rng(3)
    fn = None if merge is None else (lambda a, b: a - 2 * b)
    bp, bj = [], []
    for _ in range(2):
        s = rng.integers(0, 6, 40)
        t = rng.integers(0, 6, 40)
        v = rng.integers(0, 90, 40)
        T.process_labelled_batch(torch.from_numpy(s), torch.from_numpy(t),
                                 torch.from_numpy(v), str(tmp_path), bp)
        JT.process_labelled_batch(s, t, [JL.GammaCodedIntLabel("W", int(x))
                                         for x in v], str(tmp_path), bj)
    proto = PL.GammaCodedIntLabel("W")
    _same_both_ways(
        T.LabelledBatchGraph(6, 80, bp, proto, fn),
        JT.LabelledBatchGraph(6, 80, bj, JL.GammaCodedIntLabel("W"),
                              None if fn is None else _jax_merge(fn)))


def test_batch_graph_num_arcs_counts_pairs_spilled(tmp_path):
    """ROADMAP C5: ``num_arcs`` is the pairs spilled before the merge, not
    the arcs that remain."""
    g = cycle_graph(6)
    j, p = _pair(g, "gamma", _arc_values(g, lambda x, t: x))
    bs = T.symmetrize_offline_labelled(p, merge=lambda a, b: a + b,
                                       temp_dir=str(tmp_path))
    merged = bs.to_arc_labelled()
    assert bs.num_arcs == 2 * g.num_arcs == 12 and merged.num_arcs == 12
    gp = CSRGraph.from_lists([[1], [0]], device=CPU)
    pp = PL.ArcLabelledGraph(gp, torch.tensor([4, 5]), PL.GammaCodedIntLabel(
        "W"))
    bs = T.symmetrize_offline_labelled(pp, merge=lambda a, b: a + b,
                                       temp_dir=str(tmp_path))
    assert bs.num_arcs == 4 and bs.to_arc_labelled().num_arcs == 2
    bs.cleanup()


COMPOSE = {
    # the JAX case: two paths 0->1->3 (1+5) and 0->2->3 (2+5), min 6
    "jax_case": (lambda: JCSR.from_lists([np.asarray(l, dtype=np.int64) for l
                                          in [[1, 2], [], [], []]]),
                 lambda: JCSR.from_lists([np.asarray(l, dtype=np.int64) for l
                                          in [[], [3], [3], []]]),
                 lambda x, t: t, lambda x, t: x * 0 + 5),
    "er_g1_smaller": (lambda: erdos_renyi(40, 0.1, seed=1),
                      lambda: erdos_renyi(25, 0.2, seed=2),
                      lambda x, t: (x + t) % 9, lambda x, t: (x * t) % 7),
    "er_g0_smaller": (lambda: erdos_renyi(20, 0.2, seed=3),
                      lambda: erdos_renyi(45, 0.1, seed=4),
                      lambda x, t: (2 * x + t) % 11, lambda x, t: (x + 1) % 5),
}
SEMIRINGS = {
    "min_plus": ("amin", lambda a, b: a + b, min),
    "sum_times": ("sum", lambda a, b: a * b, lambda a, b: a + b),
    "max_plus": ("amax", lambda a, b: a + b, max),
}


@pytest.mark.parametrize("sr", sorted(SEMIRINGS))
@pytest.mark.parametrize("name", sorted(COMPOSE))
def test_compose_labelled_semiring(name, sr):
    f0, f1, l0, l1 = COMPOSE[name]
    g0, g1 = f0(), f1()
    j0, p0 = _pair(g0, "gamma", _arc_values(g0, l0))
    j1, p1 = _pair(g1, "gamma", _arc_values(g1, l1))
    add, mul, jadd = SEMIRINGS[sr]
    got = T.compose_labelled(p0, p1, PL.LabelSemiring(add, mul, 1 << 30, 0))
    want = JT.compose_labelled(j0, j1, JL.LabelSemiring(
        add=_jax_merge(jadd), multiply=_jax_merge(mul),
        zero=JL.GammaCodedIntLabel("W", 1 << 30),
        one=JL.GammaCodedIntLabel("W", 0)))
    assert got.num_nodes == want.num_nodes == max(g0.num_nodes, g1.num_nodes)
    assert _lists(got) == _lists(want)
    if name == "jax_case" and sr == "min_plus":
        np.testing.assert_array_equal(got.successors(0), [3])
        assert got.labels_of(0)[0].value == 6
    with pytest.raises(ValueError):
        PL.LabelSemiring(min, mul, 0, 0)
