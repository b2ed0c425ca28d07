"""List labels in the port against ``webgraph_tpu/labelling``.

The merges, the offline transforms, the composition, the filters and the
decode of ``FixedWidthIntListLabel`` / ``FixedWidthLongListLabel`` graphs
run through both packages on the same seeded numpy input.  The port's
merges take ragged batches ``(counts, entries)``; each is wrapped for the
JAX side as a ``Label``-object merge.  The merges are the concatenation,
which cannot be swapped and so shows any fault of order, and "keep the
longer, the first on ties".  Widths 0, 1, 20, 31 and 63, empty and long
lists, n = 0, and an arc twice in one graph.  The native list decode is
held against its plain version (the scalar ``BitReader`` per arc) and
against the JAX ``BitStreamArcLabelledGraph.load``, a disagreeing
``.labeloffsets`` raising the same ``ValueError`` in both.  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as JA
from webgraph_tpu import labelling as JL
from webgraph_tpu import transform as JT
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.labelling.graph import filter_labelled as j_filter
from webgraph_tpu_torch import algo as PA
from webgraph_tpu_torch import labelling as PL
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch import transform as T
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.labelling.graph import (cat_labels, filter_labelled,
                                                gather_labels)
from webgraph_tpu_torch.ops import labelcodec

from .graphs import cycle_graph, erdos_renyi
from .test_torch_labelled_transform import _lists

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (JAX class, port class, width)
KINDS = {
    "int0": (JL.FixedWidthIntListLabel, PL.FixedWidthIntListLabel, 0),
    "int1": (JL.FixedWidthIntListLabel, PL.FixedWidthIntListLabel, 1),
    "int20": (JL.FixedWidthIntListLabel, PL.FixedWidthIntListLabel, 20),
    "int31": (JL.FixedWidthIntListLabel, PL.FixedWidthIntListLabel, 31),
    "long0": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 0),
    "long1": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 1),
    "long20": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 20),
    "long31": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 31),
    "long63": (JL.FixedWidthLongListLabel, PL.FixedWidthLongListLabel, 63),
}


def _random_lists(m: int, w: int, seed: int, long_every: int = 17):
    """Per arc a list: about a third empty, most short, every
    ``long_every``-th arc 40-90 entries; entries uniform below 2**w, with
    2**w - 1 forced into every long list."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.geometric(0.4, m) - 1, 6).astype(np.int64)
    counts[::long_every] = rng.integers(40, 90, len(counts[::long_every]))
    hi = (1 << w) - 1
    out = []
    for j, c in enumerate(counts.tolist()):
        e = (rng.integers(0, hi, c, dtype=np.int64, endpoint=True)
             if w else np.zeros(c, np.int64))
        if j % long_every == 0 and c:
            e[c // 2] = hi
        out.append(e)
    return out


def _labelled(g: JCSR, kind: str, lists):
    """The same list-labelled graph in both packages."""
    jc, pc, w = KINDS[kind]
    j = JL.ArcLabelledGraph(g, [jc("L", w, e) for e in lists], jc("L", w))
    counts = torch.tensor([len(e) for e in lists], dtype=torch.int64)
    entries = torch.from_numpy(np.concatenate(lists) if lists
                               else np.zeros(0, np.int64))
    p = PL.ArcLabelledGraph(CSRGraph(g.offsets, g.succ, num_nodes=g.num_nodes,
                                     device=CPU), (counts, entries),
                            pc("L", w))
    return j, p


def _graph(name: str) -> JCSR:
    return GRAPHS[name]()


GRAPHS = {
    "er": lambda: erdos_renyi(40, 0.12, seed=1),
    "er_loops": lambda: erdos_renyi(30, 0.15, seed=7, loops=True),
    "cycle": lambda: cycle_graph(9),
}


# -- the merges: ragged on the port's side, Label objects on the JAX side ----


def longer(a, b):
    """Row i: the longer of a_i and b_i, a_i on ties."""
    k = a[0].numel()
    take_b = b[0] > a[0]
    idx = torch.arange(k) + k * take_b.to(torch.int64)
    return gather_labels(cat_labels([a, b]), idx)


def _np_concat(x, y):
    return np.concatenate([x, y])


def _np_longer(x, y):
    return y if len(y) > len(x) else x


MERGES = {"concat": (PL.concat_lists, _np_concat),
          "longer": (longer, _np_longer)}


def _jax_list_merge(fn):
    return lambda a, b: type(a)(a.key, a.width, fn(a.value, b.value))


def _values(p):
    """(counts, entries) of a port labelled graph as lists of lists."""
    c, e = p.label_values()
    ends = np.cumsum(c.numpy())
    return [x.tolist() for x in np.split(e.numpy(), ends[:-1])] if len(c) \
        else []


def _same(p, j):
    np.testing.assert_array_equal(p.graph.offsets.numpy(), j.graph.offsets)
    np.testing.assert_array_equal(p.graph.succ.numpy(), j.graph.succ)
    assert _values(p) == [np.asarray(l.value).tolist() for l in j.labels]


def test_concat_and_longer_merges_by_hand():
    a = (torch.tensor([2, 0, 1]), torch.tensor([1, 2, 3]))
    b = (torch.tensor([0, 3, 1]), torch.tensor([4, 5, 6, 7]))
    c, e = PL.concat_lists(a, b)
    assert c.tolist() == [2, 3, 2] and e.tolist() == [1, 2, 4, 5, 6, 3, 7]
    c, e = longer(a, b)
    assert c.tolist() == [2, 3, 1] and e.tolist() == [1, 2, 4, 5, 6, 3]


@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_union_labelled_lists(kind, merge):
    g0, g1 = erdos_renyi(40, 0.15, seed=1), erdos_renyi(50, 0.12, seed=2)
    w = KINDS[kind][2]
    j0, p0 = _labelled(g0, kind, _random_lists(g0.num_arcs, w, 3))
    j1, p1 = _labelled(g1, kind, _random_lists(g1.num_arcs, w, 4))
    pm, jm = MERGES[merge]
    got = PL.union_labelled(p0, p1, pm)
    _same(got, JL.union_labelled(j0, j1, _jax_list_merge(jm)))
    # an arc twice in one graph has no defined merge
    dup = CSRGraph([0, 2], [0, 0], device=CPU)
    with pytest.raises(ValueError):
        PL.union_labelled(PL.ArcLabelledGraph(
            dup, (torch.tensor([1, 0]), torch.tensor([0])), p0.prototype),
            p1, pm)


def test_union_labelled_lists_with_itself_and_empty_graphs():
    g = erdos_renyi(30, 0.2, seed=5)
    lists = _random_lists(g.num_arcs, 20, 6)
    j, p = _labelled(g, "int20", lists)
    got = PL.union_labelled(p, p, PL.concat_lists)
    assert _values(got) == [e.tolist() + e.tolist() for e in lists]
    _same(got, JL.union_labelled(j, j, _jax_list_merge(_np_concat)))
    e0 = JCSR.from_lists([])
    j0, p0 = _labelled(e0, "int20", [])
    assert p0.num_nodes == 0
    got = PL.union_labelled(p0, p0, PL.concat_lists)
    assert got.num_nodes == 0 and got.num_arcs == 0
    _same(PL.union_labelled(p0, p, PL.concat_lists),
          JL.union_labelled(j0, j, _jax_list_merge(_np_concat)))
    with pytest.raises(ValueError):   # lists against scalars
        PL.union_labelled(p, PL.ArcLabelledGraph(
            p.graph, torch.zeros(p.num_arcs, dtype=torch.int64),
            PL.GammaCodedIntLabel("W")), PL.concat_lists)


def test_fold_runs_ranks_in_order():
    """Runs of 1-4 occurrences, folded with the concatenation: each run's
    lists in occurrence order."""
    from webgraph_tpu_torch.labelling.graph import fold_runs
    key = torch.tensor([1, 1, 1, 1, 2, 5, 5, 7, 7, 7])
    counts = torch.tensor([1, 0, 2, 1, 3, 0, 0, 1, 1, 1])
    entries = torch.arange(int(counts.sum()))
    k, (c, e) = fold_runs(key, (counts, entries), PL.concat_lists)
    assert k.tolist() == [1, 2, 5, 7]
    assert c.tolist() == [4, 3, 0, 3]
    assert e.tolist() == list(range(10))
    k, (c, e) = fold_runs(key, (counts, entries), None)
    assert c.tolist() == [1, 3, 0, 1] and e.tolist() == [0, 4, 5, 6, 7]


@pytest.mark.parametrize("ragged", [False, True])
def test_fold_runs_long_runs(ragged):
    """A run of 3,000 occurrences among short runs, in shuffled key order:
    every run folded in occurrence order, as a plain fold gives it."""
    from webgraph_tpu_torch.labelling.graph import fold_runs
    rng = np.random.default_rng(11)
    sizes = np.concatenate([rng.integers(1, 6, 400), [3000],
                            rng.integers(1, 40, 50)])
    keys = rng.permutation(len(sizes))
    key = torch.from_numpy(np.repeat(np.sort(keys), sizes[np.argsort(keys)]))
    m = key.numel()
    if ragged:
        lists = _random_lists(m, 20, 12, long_every=97)
        vals = (torch.tensor([len(e) for e in lists]),
                torch.from_numpy(np.concatenate(lists)))
        k, (c, e) = fold_runs(key, vals, PL.concat_lists)
        at = np.concatenate([[0], np.cumsum(c.numpy())])
        got = [e[at[i]:at[i + 1]].tolist() for i in range(len(k))]
    else:
        v = rng.integers(0, 1000, m)
        k, out = fold_runs(key, torch.from_numpy(v),
                           lambda a, b: (3 * a - b) % 10007)
        got = out.tolist()
    want, x = [], 0
    for s in np.bincount(key.numpy())[np.unique(key.numpy())]:
        if ragged:
            want.append(np.concatenate(lists[x:x + s]).tolist())
        else:
            acc = int(v[x])
            for y in v[x + 1:x + s].tolist():
                acc = (3 * acc - y) % 10007
            want.append(acc)
        x += s
    assert k.tolist() == np.unique(key.numpy()).tolist()
    assert got == want


def test_label_semiring_takes_torch_merges():
    """A torch function is a batch merge; a Python builtin is not."""
    g0, g1 = erdos_renyi(25, 0.2, seed=4), erdos_renyi(25, 0.2, seed=5)

    def labelled(g, seed):
        return PL.ArcLabelledGraph(
            CSRGraph(g.offsets, g.succ, device=CPU),
            torch.from_numpy(np.random.default_rng(seed).integers(
                0, 50, g.num_arcs)), PL.GammaCodedIntLabel("W"))

    p0, p1 = labelled(g0, 1), labelled(g1, 2)
    got = T.compose_labelled(p0, p1, PL.LabelSemiring(
        torch.minimum, torch.add, 1 << 30, 0))
    want = T.compose_labelled(p0, p1, PL.LabelSemiring(
        "amin", torch.add, 1 << 30, 0))
    assert _lists(got) == _lists(want)
    for builtin in (min, max, sum):
        with pytest.raises(ValueError):
            PL.LabelSemiring(builtin, torch.add, 0, 0)


# -- offline transforms --------------------------------------------------------


def _batch_pair(bg, jbg):
    """A port LabelledBatchGraph equals the JAX one node by node and in
    bulk (``to_arc_labelled``)."""
    want = _lists(jbg)
    assert bg.num_arcs == jbg.num_arcs and bg.num_nodes == jbg.num_nodes
    assert _lists(bg) == want
    assert _lists(bg.to_arc_labelled()) == want
    bg.cleanup()
    jbg.cleanup()


@pytest.mark.parametrize("batch", [7, 1000])
@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_symmetrize_offline_lists(tmp_path, name, merge, batch):
    g = _graph(name)
    j, p = _labelled(g, "long20", _random_lists(g.num_arcs, 20, 8))
    pm, jm = MERGES[merge]
    _batch_pair(
        T.symmetrize_offline_labelled(p, merge=pm, batch_size=batch,
                                      temp_dir=str(tmp_path)),
        JT.symmetrize_offline_labelled(j, merge=_jax_list_merge(jm),
                                       batch_size=batch,
                                       temp_dir=str(tmp_path)))


@pytest.mark.parametrize("kind", ["int0", "int31", "long63"])
@pytest.mark.parametrize("batch", [5, 64])
def test_transpose_offline_lists_twice_is_the_identity(tmp_path, kind,
                                                       batch):
    g = erdos_renyi(40, 0.1, seed=3)
    j, p = _labelled(g, kind, _random_lists(g.num_arcs, KINDS[kind][2], 9))
    kw = dict(batch_size=batch, temp_dir=str(tmp_path))
    bt = T.transpose_offline_labelled(p, **kw)
    jbt = JT.transpose_offline_labelled(j, **kw)
    assert _lists(bt) == _lists(jbt)
    once = bt.to_arc_labelled()
    assert _lists(once) == _lists(jbt)
    twice = T.transpose_offline_labelled(once, **kw).to_arc_labelled()
    assert twice.equals_labelled(p)
    bt.cleanup()
    jbt.cleanup()


@pytest.mark.parametrize("merge", [None, "concat", "longer"])
def test_list_duplicates_across_and_within_batches(tmp_path, merge):
    """Spilled triples with repeated arcs in three batches: ``merge=None``
    keeps the first occurrence in batch order, a merge folds them in that
    order, as the JAX class does."""
    rng = np.random.default_rng(11)
    pm, jm = MERGES[merge] if merge else (None, None)
    bp, bj = [], []
    for b in range(3):
        s = rng.integers(0, 6, 40)
        t = rng.integers(0, 6, 40)
        lists = _random_lists(40, 20, 20 + b, long_every=13)
        vals = (torch.tensor([len(e) for e in lists]),
                torch.from_numpy(np.concatenate(lists)))
        T.process_labelled_batch(torch.from_numpy(s), torch.from_numpy(t),
                                 vals, str(tmp_path), bp)
        JT.process_labelled_batch(
            s, t, [JL.FixedWidthIntListLabel("L", 20, e) for e in lists],
            str(tmp_path), bj)
    _batch_pair(
        T.LabelledBatchGraph(6, 120, bp, PL.FixedWidthIntListLabel("L", 20),
                             pm),
        JT.LabelledBatchGraph(6, 120, bj, JL.FixedWidthIntListLabel("L", 20),
                              None if jm is None else _jax_list_merge(jm)))


# -- composition ---------------------------------------------------------------


COMPOSE = {
    "er_er": (lambda: erdos_renyi(25, 0.15, seed=1),
              lambda: erdos_renyi(30, 0.12, seed=2)),
    "cycle_er": (lambda: cycle_graph(12), lambda: erdos_renyi(8, 0.4, seed=3)),
}


@pytest.mark.parametrize("add", sorted(MERGES))
@pytest.mark.parametrize("name", sorted(COMPOSE))
def test_compose_labelled_list_semiring(name, add):
    f0, f1 = COMPOSE[name]
    g0, g1 = f0(), f1()
    j0, p0 = _labelled(g0, "long31", _random_lists(g0.num_arcs, 31, 5, 7))
    j1, p1 = _labelled(g1, "long31", _random_lists(g1.num_arcs, 31, 6, 5))
    pa, ja = MERGES[add]
    empty = (torch.zeros(0, dtype=torch.int64),) * 2
    got = T.compose_labelled(p0, p1, PL.LabelSemiring(
        pa, PL.concat_lists, empty, empty))
    proto = JL.FixedWidthLongListLabel("L", 31)
    want = JT.compose_labelled(j0, j1, JL.LabelSemiring(
        add=_jax_list_merge(ja), multiply=_jax_list_merge(_np_concat),
        zero=proto, one=proto))
    assert got.num_nodes == want.num_nodes
    assert _lists(got) == _lists(want)
    with pytest.raises(ValueError):   # a scatter_reduce name on lists
        T.compose_labelled(p0, p1, PL.LabelSemiring(
            "sum", PL.concat_lists, empty, empty))


def test_compose_labelled_scalar_with_a_merge_callable():
    """``add`` as a batch merge on scalar labels folds in the JAX path
    order (``a - 2 b`` cannot be swapped)."""
    g0, g1 = erdos_renyi(25, 0.2, seed=4), erdos_renyi(25, 0.2, seed=5)
    v0 = np.arange(g0.num_arcs) % 7
    v1 = np.arange(g1.num_arcs) % 5

    def pair(g, v):
        j = JL.ArcLabelledGraph(g, [JL.GammaCodedIntLabel("W", int(x))
                                    for x in v], JL.GammaCodedIntLabel("W"))
        p = PL.ArcLabelledGraph(CSRGraph(g.offsets, g.succ, device=CPU),
                                torch.from_numpy(v.astype(np.int64)),
                                PL.GammaCodedIntLabel("W"))
        return j, p

    (j0, p0), (j1, p1) = pair(g0, v0), pair(g1, v1)
    got = T.compose_labelled(p0, p1, PL.LabelSemiring(
        lambda a, b: a - 2 * b, lambda a, b: a + b, 0, 0))

    def jm(fn):
        return lambda a, b: JL.GammaCodedIntLabel("W", fn(a.value, b.value))

    want = JT.compose_labelled(j0, j1, JL.LabelSemiring(
        add=jm(lambda a, b: a - 2 * b), multiply=jm(lambda a, b: a + b),
        zero=None, one=None))
    assert _lists(got) == _lists(want)


# -- filters and SCC with a list predicate -------------------------------------


def _holds_below(t: int):
    """Port predicate: the arc's list holds an entry below ``t``."""
    def pred(values, src, tgt):
        counts, entries = values
        arc = torch.repeat_interleave(torch.arange(counts.numel()), counts)
        hit = torch.zeros(counts.numel(), dtype=torch.bool)
        hit[arc[entries < t]] = True
        return hit
    return pred


def _j_holds_below(t: int):
    return lambda l, x, y: bool((np.asarray(l.value) < t).any())


@pytest.mark.parametrize("thr", [1, 1 << 10, 1 << 19])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_filter_and_scc_with_a_list_predicate(name, thr):
    g = _graph(name)
    j, p = _labelled(g, "int20", _random_lists(g.num_arcs, 20, 12, 3))
    _same(filter_labelled(p, _holds_below(thr)),
          j_filter(j, _j_holds_below(thr)))
    k, comp = PA.strongly_connected_components_labelled(p, _holds_below(thr))
    jk, jcomp = JA.strongly_connected_components_labelled(
        j, _j_holds_below(thr))
    assert k == jk
    np.testing.assert_array_equal(comp.numpy(), jcomp)


def test_relabel_lists():
    g = erdos_renyi(30, 0.15, seed=2)
    lists = _random_lists(g.num_arcs, 20, 13)
    j, p = _labelled(g, "int20", lists)
    r = PL.relabel(p, lambda v, x, t: (v[0], v[1] + 1),
                   PL.FixedWidthIntListLabel("L", 21))
    assert _values(r) == [(e + 1).tolist() for e in lists]
    jr = JL.relabel(j, lambda l, x, t: JL.FixedWidthIntListLabel(
        "L", 21, l.value + 1), JL.FixedWidthIntListLabel("L", 21))
    _same(r, jr)


# -- the decode: native, plain, JAX --------------------------------------------


def _stored(tmp_path, kind, g, lists, name="g"):
    _j, p = _labelled(g, kind, lists)
    b = str(tmp_path / name)
    BVGraph.store(p.graph, b)
    PL.BitStreamArcLabelledGraph.store(p, b + "-label", name)
    return p, b + "-label"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_native_list_decode_matches_plain_and_jax(tmp_path, kind):
    g = erdos_renyi(60, 0.1, seed=14)
    lists = _random_lists(g.num_arcs, KINDS[kind][2], 15)
    p, lb = _stored(tmp_path, kind, g, lists)
    lg = PL.BitStreamArcLabelledGraph.load(lb)
    offs = p.graph.offsets
    got = labelcodec.unpack_labels(lg.label_data, lg.label_offsets, offs,
                                   lg.prototype)
    plain = labelcodec.unpack_lists_plain(lg.label_data, lg.label_offsets,
                                          offs, KINDS[kind][2])
    for a, b, c in zip(got, plain, p.label_values()):
        assert torch.equal(a, b) and torch.equal(a, c)
    for threads in (1, 3, 64):
        c, e = PN.decode_list_labels(lg.label_data, lg.label_offsets,
                                     offs.numpy(), KINDS[kind][2],
                                     threads=threads)
        assert torch.equal(torch.from_numpy(c), got[0])
        assert torch.equal(torch.from_numpy(e), got[1])
    jg = JL.BitStreamArcLabelledGraph.load(lb)
    want = [np.asarray(l.value).tolist() for x in range(g.num_nodes)
            for l in jg.labels_of(x)]
    assert _values(lg.to_device(CPU)) == want == [e.tolist() for e in lists]


def test_native_list_decode_edge_graphs(tmp_path):
    """n = 0; outdegree-0 nodes between long lists; every list empty."""
    e0 = JCSR.from_lists([])
    _, lb = _stored(tmp_path, "int20", e0, [], "e0")
    got = PL.BitStreamArcLabelledGraph.load(lb).to_device(CPU)
    assert got.num_nodes == 0 and got.label_values()[1].numel() == 0
    sparse = JCSR.from_lists([np.asarray(l, dtype=np.int64) for l in
                              [[], [0, 3], [], [], [1], []]])
    lists = [np.arange(300, dtype=np.int64), np.zeros(0, np.int64),
             np.asarray([5], np.int64)]
    _, lb = _stored(tmp_path, "long63", sparse, lists, "sp")
    got = PL.BitStreamArcLabelledGraph.load(lb).to_device(CPU)
    assert _values(got) == [e.tolist() for e in lists]
    g = cycle_graph(7)
    none = [np.zeros(0, np.int64)] * g.num_arcs
    _, lb = _stored(tmp_path, "int31", g, none, "none")
    got = PL.BitStreamArcLabelledGraph.load(lb).to_device(CPU)
    assert got.label_values()[0].tolist() == [0] * g.num_arcs


SPOIL = {
    # .labeloffsets of another stream: a node ends past its successor's
    # start, or before it
    "shifted_late": lambda d, lo: (d, lo + (lo > 40)),
    "shifted_early": lambda d, lo: (d, lo - (lo > 40) * (lo < lo[-1])),
    # a stream cut short of its offsets
    "cut": lambda d, lo: (d[:len(d) // 2], np.minimum(lo, 4 * len(d))),
}


@pytest.mark.parametrize("name", sorted(SPOIL))
def test_disagreeing_labeloffsets_raise_the_same_error(tmp_path, name):
    g = erdos_renyi(40, 0.15, seed=16)
    p, lb = _stored(tmp_path, "int20",
                    g, _random_lists(g.num_arcs, 20, 17))
    lg = PL.BitStreamArcLabelledGraph.load(lb)
    data, lo = SPOIL[name](lg.label_data, lg.label_offsets)
    offs = p.graph.offsets
    with pytest.raises(ValueError) as native_err:
        labelcodec.unpack_labels(data, lo, offs, lg.prototype)
    assert "disagrees with .labeloffsets" in str(native_err.value)
    if name == "cut":
        return   # the plain reader may run off the stream first
    with pytest.raises(ValueError) as plain_err:
        labelcodec.unpack_lists_plain(data, lo, offs, 20)
    assert str(native_err.value) == str(plain_err.value)
