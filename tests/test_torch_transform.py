"""The port's transforms against ``webgraph_tpu/transform``.

Every function of ``webgraph_tpu_torch/transform`` on the CPU, on the
``tests/graphs.py`` generators and on small synthetic web graphs, against
the JAX function on the same input: graphs equal list by list, permutations
equal as arrays (the row sorts of the synthetic graphs reach tie groups
deeper than the first 8 columns, in lexicographic and Gray order), offline
transforms equal in their lists, their arc counts and their batches.  The
cases of ``tests/test_transform.py`` that these functions cover run on the
port too.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import transform as JT
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu_torch import transform as T
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.transform import offline as OFF
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .graphs import (complete_binary_intree, complete_graph, cycle_graph,
                     erdos_renyi, star_graph)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _port(g) -> CSRGraph:
    return CSRGraph(np.asarray(g.offsets), np.asarray(g.succ),
                    num_nodes=g.num_nodes, device=CPU)


def _jax(g: CSRGraph) -> JCSR:
    return JCSR(g.offsets.numpy(), g.succ.numpy().astype(np.int64))


def _synth(n, seed):
    co, su = E.simple(*synthesize_webgraph(n, seed=seed))
    return JCSR(co, su)


GRAPHS = {
    "er": lambda: erdos_renyi(60, 0.1, seed=0),
    "er_dense": lambda: erdos_renyi(40, 0.3, seed=6),
    "complete": lambda: complete_graph(9),
    "star": lambda: star_graph(20),
    "cycle": lambda: cycle_graph(30),
    "intree": lambda: complete_binary_intree(4),
    "synth": lambda: _synth(3000, seed=2),
    "empty": lambda: JCSR.from_lists([np.zeros(0, np.int64)] * 4),
}


def _same(p: CSRGraph, j):
    """A port graph equals a JAX graph: node count, offsets, successors."""
    assert p.num_nodes == j.num_nodes
    jc = j if isinstance(j, JCSR) else j.to_csr()
    np.testing.assert_array_equal(p.offsets.numpy(), jc.offsets)
    np.testing.assert_array_equal(p.succ.numpy(), jc.succ)


def _same_lists(a, b):
    """Two graphs with ``iter_nodes`` (numpy or tensor lists) agree."""
    assert a.num_nodes == b.num_nodes
    for (x, sa), (y, sb) in zip(a.iter_nodes(), b.iter_nodes()):
        assert x == y
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb),
                                      err_msg=f"node {x}")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_permutations_equal(name):
    g = GRAPHS[name]()
    p = _port(g)
    for fn in ("lexicographical_permutation", "gray_code_permutation"):
        got = getattr(T, fn)(p)
        assert got.dtype == torch.int64 and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), getattr(JT, fn)(g),
                                      err_msg=fn)
    for seed in (0, 7):
        np.testing.assert_array_equal(T.random_permutation(p, seed).numpy(),
                                      JT.random_permutation(g, seed))
    perm = JT.random_permutation(g, 3)
    _same(T.apply_permutation(p, perm), JT.apply_permutation(g, perm))
    _same(T.apply_permutation(p, torch.from_numpy(perm)),
          JT.apply_permutation(g, perm))


@pytest.mark.parametrize("gray", [False, True])
def test_deep_tie_groups_resolved_in_bulk(gray):
    """A synthetic web graph's copied lists tie far past 8 columns; the
    bulk resolution must reproduce the comparator sort exactly."""
    g = _synth(5000, seed=4)
    stats = {}
    fn = "gray_code_permutation" if gray else "lexicographical_permutation"
    got = getattr(T, fn)(_port(g), stats=stats)
    np.testing.assert_array_equal(got.numpy(), getattr(JT, fn)(g))
    deg = np.diff(g.offsets)
    assert stats["tie_groups"] > 100 and stats["rounds"] >= 2
    assert (deg > 8).sum() > 1000
    # fewer key columns: every group is a tie group, resolved the same
    order = T._row_sort_order(_port(g), gray, key_cols=1)
    np.testing.assert_array_equal(T._invert(order).numpy(),
                                  getattr(JT, fn)(g))


def test_row_order_of_equal_and_prefix_rows():
    """Rows equal in full keep their original order; a row that is a prefix
    of another sorts first in lexicographic order, and by the parity of its
    length in Gray order."""
    base = np.arange(2, 14, dtype=np.int64)
    e = np.zeros(0, np.int64)
    lists = [base, base[:11], base, e, base[:10], base,
             np.concatenate([base, [20]]), base[:11]] + [e] * 14
    g = JCSR.from_lists([np.asarray(x) for x in lists])
    for fn in ("lexicographical_permutation", "gray_code_permutation"):
        np.testing.assert_array_equal(getattr(T, fn)(_port(g)).numpy(),
                                      getattr(JT, fn)(g), err_msg=fn)


def test_transpose_symmetrize_simplify_union():
    g = erdos_renyi(60, 0.1, seed=0)
    p = _port(g)
    _same(T.transpose(p), JT.transpose(g))
    _same(T.symmetrize(p), JT.symmetrize(g))
    _same(T.simplify(p), JT.simplify(g))
    h = cycle_graph(60)
    _same(T.union(p, _port(h)), JT.union(g, h))
    # double transpose is the identity; a symmetric graph is its transpose
    _same(T.transpose(T.transpose(p)), g)
    s = T.symmetrize(p)
    _same(T.transpose(s), _jax(s))


@pytest.mark.parametrize("name", ["er", "synth", "cycle"])
def test_map_offline_equal(name):
    g = GRAPHS[name]()
    p = _port(g)
    n = g.num_nodes
    rng = np.random.default_rng(1)
    maps = {"perm": JT.random_permutation(g, seed=7),
            "merge_drop": np.where(rng.random(n) < 0.2, -1,
                                   rng.integers(0, max(n // 3, 1), n))}
    for k, node_map in maps.items():
        _same(T.map_offline(p, node_map), JT.map_offline(g, node_map))
        _same(T.map_offline(p, node_map, num_nodes=n + 2),
              JT.map_offline(g, node_map, num_nodes=n + 2))


def test_map_offline_merge_and_drop_cycle():
    g = _port(cycle_graph(6))
    node_map = np.asarray([0, 0, 1, 1, 2, -1], dtype=np.int64)
    mapped = T.map_offline(g, node_map)
    assert mapped.num_nodes == 3
    assert mapped.successors(0).tolist() == [0, 1]
    assert mapped.successors(1).tolist() == [1, 2]
    assert mapped.successors(2).tolist() == []
    bg = T.map_offline_batched(g, node_map, batch_size=3)
    _same_lists(mapped, bg)
    bg.cleanup()


@pytest.mark.parametrize("pair", ["path", "er", "synth"])
def test_compose_equal(pair):
    if pair == "path":
        g0 = g1 = JCSR.from_lists([np.asarray([1]), np.asarray([2]),
                                   np.asarray([3]), np.zeros(0, np.int64)])
    elif pair == "er":
        g0, g1 = erdos_renyi(50, 0.08, seed=1), erdos_renyi(50, 0.08, seed=2)
    else:
        g0, g1 = _synth(600, seed=1), _synth(600, seed=2)
    _same(T.compose(_port(g0), _port(g1)), JT.compose(g0, g1))


def test_compose_identity_and_memory_check(monkeypatch):
    g = _port(erdos_renyi(30, 0.1, seed=3))
    ident = CSRGraph.from_lists([[i] for i in range(30)], device=CPU)
    for c in (T.compose(g, ident), T.compose(ident, g)):
        assert torch.equal(c.offsets, g.offsets)
        assert torch.equal(c.succ, g.succ)
    monkeypatch.setattr(T, "_free_bytes", lambda dev: 100)
    with pytest.raises(MemoryError):
        T.compose(g, g)


def test_filter_arcs_equal():
    g = complete_graph(6)
    p = _port(g)
    _same(T.filter_arcs(p, T.no_loops), JT.filter_arcs(g, JT.no_loops))
    cls = np.asarray([0, 0, 0, 1, 1, 1])
    _same(T.filter_arcs(p, T.NodeClassFilter(cls)),
          JT.filter_arcs(g, JT.NodeClassFilter(cls)))
    _same(T.filter_arcs(p, T.NodeClassFilter(torch.from_numpy(cls))),
          JT.filter_arcs(g, JT.NodeClassFilter(cls)))
    f = T.filter_arcs(p, T.no_loops)
    assert all(x not in f.successors(x).tolist() for x in range(6))


def test_transforms_take_device_graphs_only():
    with pytest.raises(TypeError):
        T.lexicographical_permutation(cycle_graph(5))
    with pytest.raises(TypeError):
        T.transpose_offline(cycle_graph(5))


# -- offline ------------------------------------------------------------------


def _same_batches(bp, bj):
    """Port and JAX BatchGraphs: the same lists, arc counts and batch
    files."""
    assert (bp.num_nodes, bp.num_arcs) == (bj.num_nodes, bj.num_arcs)
    assert len(bp.batches) == len(bj.batches)
    for a, b in zip(bp.batches, bj.batches):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    _same_lists(bp, bj)


@pytest.mark.parametrize("fn", ["transpose_offline", "symmetrize_offline",
                                "simplify_offline", "map_offline_batched"])
@pytest.mark.parametrize("read_arcs", [50, 1 << 24])
def test_offline_equal(tmp_path, monkeypatch, fn, read_arcs):
    """Several batches (and, with ``read_arcs`` 50, many node chunks per
    batch and batches across chunks): equal to the JAX function's."""
    monkeypatch.setattr(OFF, "_READ_ARCS", read_arcs)
    g = _synth(800, seed=5)
    loops = np.arange(0, 800, 7)
    g = JCSR.from_arcs(np.concatenate([g.arcs()[0], loops]),
                       np.concatenate([g.arcs()[1], loops]), 800)
    args = (JT.random_permutation(g, 2),) if fn == "map_offline_batched" \
        else ()
    bs = max(g.num_arcs // 5, 1)
    bp = getattr(T, fn)(_port(g), *args, batch_size=bs,
                        temp_dir=str(tmp_path))
    bj = getattr(JT, fn)(g, *args, batch_size=bs, temp_dir=str(tmp_path))
    assert len(bp.batches) >= 4
    _same_batches(bp, bj)
    bp.cleanup()
    bj.cleanup()


def test_offline_equals_in_memory(tmp_path):
    g = _port(_synth(1500, seed=6))
    for off, mem in ((T.transpose_offline, T.transpose),
                     (T.symmetrize_offline, T.symmetrize),
                     (T.simplify_offline, T.simplify)):
        bg = off(g, batch_size=3000, temp_dir=str(tmp_path))
        assert len(bg.batches) >= 4
        c = bg.to_csr(device=CPU)
        m = mem(g)
        assert torch.equal(c.offsets, m.offsets) and torch.equal(c.succ,
                                                                 m.succ)
        bg.cleanup()


def test_batchgraph_mid_stream_split(tmp_path):
    """iter_nodes(start) positions the merge mid-stream (no replay from
    node 0) and agrees with a full scan (Transform.java:771-789)."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 300, 5000)
    tgt = rng.integers(0, 300, 5000)
    g = CSRGraph.from_arcs(src, tgt, 300, device=CPU)
    bt = T.transpose_offline(g, batch_size=600, temp_dir=str(tmp_path))
    assert len(bt.batches) > 3
    full = {x: succ.tolist() for x, succ in bt.iter_nodes()}
    for start in (0, 1, 137, 299, 300):
        part = {x: succ.tolist() for x, succ in bt.iter_nodes(start)}
        assert part == {x: v for x, v in full.items() if x >= start}
    joined = torch.cat([bt.to_csr(0, 150, device=CPU).succ,
                        bt.to_csr(150, 300, device=CPU).succ])
    assert torch.equal(joined, bt.to_csr(device=CPU).succ)
    bt.cleanup()


@pytest.mark.parametrize("merge_arcs", [16, 1 << 22])
def test_batchgraph_blocks_equal_jax(tmp_path, monkeypatch, merge_arcs):
    """The merge by blocks of nodes (blocks of a few arcs, so a hub of
    more arcs than a block is a block alone; or one block) reads the same
    lists from every start as the JAX BatchGraph over the same batch
    files; ``host_csr`` and the native streaming store read whole
    blocks and give the same CSR and the single-stream encode's bytes."""
    from webgraph_tpu.transform.offline import BatchGraph as JBatchGraph
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.core.graph import host_csr
    monkeypatch.setattr(OFF, "_MERGE_ARCS", merge_arcs)
    rng = np.random.default_rng(9)
    src = rng.integers(0, 400, 6000)
    tgt = rng.integers(0, 400, 6000)
    src[:500] = 123
    g = CSRGraph.from_arcs(src, tgt, 420, device=CPU)
    bt = T.symmetrize_offline(g, batch_size=1500, temp_dir=str(tmp_path))
    assert len(bt.batches) > 3
    jb = JBatchGraph(bt.num_nodes, bt.num_arcs, bt.batches)
    want = {x: succ.tolist() for x, succ in jb.iter_nodes()}
    for start in (0, 1, 123, 124, 419, 420):
        assert ({x: succ.tolist() for x, succ in bt.iter_nodes(start)}
                == {x: v for x, v in want.items() if x >= start})
    co, su = host_csr(bt)
    mem = T.symmetrize(g)
    np.testing.assert_array_equal(co, mem.offsets.numpy())
    np.testing.assert_array_equal(su, mem.succ.numpy())
    BVGraph.store(bt, str(tmp_path / "blocks"))
    BVGraph.store(mem, str(tmp_path / "csr"), num_threads=1)
    for ext in (".graph", ".offsets"):
        assert ((tmp_path / ("blocks" + ext)).read_bytes()
                == (tmp_path / ("csr" + ext)).read_bytes())
    bt.cleanup()


def test_simplify_loops():
    g = CSRGraph.from_lists([[0, 1], [2], []], device=CPU)
    s = T.simplify(g)
    for x in range(3):
        assert x not in s.successors(x).tolist()
    _same(T.transpose(s), _jax(s))
    bg = T.simplify_offline(g, batch_size=10)
    c = bg.to_csr(device=CPU)
    assert torch.equal(c.offsets, s.offsets) and torch.equal(c.succ, s.succ)
    bg.cleanup()
