"""HyperBall's merge, ``merge_rows``, on CPU tensors: its plain twin against
a node-by-node merge, the JAX package's ``device_round``, the scatter-max
over a prebuilt source index, and whole runs against the sequential oracle.
Every value is an integer: every comparison is exact.  The cases are
``tests/torch_hyperball_cases.py``'s, which the card's tests share."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgraph_tpu.algo import hyperball as J
from webgraph_tpu_torch.algo import hyperball as PHB
from webgraph_tpu_torch.core.graph import CSRGraph

from . import torch_hyperball_cases as H

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 6000


@pytest.fixture(scope="module")
def graph():
    co, su = H.crawl(N)
    return co, su, CSRGraph(co, su, device=CPU)


@pytest.mark.parametrize("log2m", H.LOG2MS)
def test_dense_merge_matches_every_reference(graph, log2m):
    co, su, g = graph
    regs = H.registers(N, log2m)
    want, want_ch = H.merge_reference(co, su, regs)
    assert want_ch.any() and not want_ch.all()
    t = torch.from_numpy(regs)
    out, ch = PHB.merge_rows(g.offsets, g.succ, t)
    assert out.dtype == torch.uint8 and ch.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(ch.numpy(), want_ch)
    # the round as it was computed before the merge had a wrapper: one
    # scatter-max over the per-arc source index
    old = PHB._scatter_max_rows(t.clone(), g.arc_sources(), t, g.succ)
    assert torch.equal(out, old)
    assert torch.equal(PHB.device_round(co, g.succ, t), out)
    jax_round = J.device_round(co, jnp.asarray(su.astype(np.int32)),
                               jnp.asarray(regs))
    np.testing.assert_array_equal(np.asarray(jax_round), want)


@pytest.mark.parametrize("log2m", H.LOG2MS)
def test_sparse_node_list_matches_reference(graph, log2m):
    co, su, g = graph
    regs = H.registers(N, log2m, seed=log2m)
    nodes = H.node_list(N, seed=log2m)
    want, want_ch = H.merge_reference(co, su, regs, nodes)
    out, ch = PHB.merge_rows(g.offsets, g.succ, torch.from_numpy(regs),
                             torch.from_numpy(nodes))
    assert out.shape == (len(nodes), 1 << log2m)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(ch.numpy(), want_ch)
    # the same rows as the dense merge's
    dense, dense_ch = PHB.merge_rows(g.offsets, g.succ, torch.from_numpy(regs))
    assert torch.equal(dense[nodes], out)
    assert torch.equal(dense_ch[nodes], ch)


def test_int64_successors_merge_as_int32(graph):
    co, su, g = graph
    regs = torch.from_numpy(H.registers(N, 6))
    nodes = torch.from_numpy(H.node_list(N))
    for nd in (None, nodes):
        a = PHB.merge_rows(g.offsets, g.succ, regs, nd)
        b = PHB.merge_rows(g.offsets, g.succ.to(torch.int64), regs, nd)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_empty_node_list_and_a_graph_without_arcs(graph):
    co, su, g = graph
    regs = torch.from_numpy(H.registers(N, 4))
    out, ch = PHB.merge_rows(g.offsets, g.succ, regs,
                             torch.zeros(0, dtype=torch.int64))
    assert out.shape == (0, 16) and ch.shape == (0,)
    bare = CSRGraph(np.zeros(N + 1, dtype=np.int64), np.zeros(0, np.int64),
                    device=CPU)
    out, ch = PHB.merge_rows(bare.offsets, bare.succ, regs)
    assert torch.equal(out, regs) and not ch.any()


def test_merge_rejects_what_the_kernel_does_not_take(graph):
    co, su, g = graph
    regs = torch.from_numpy(H.registers(N, 4))
    bad = [
        (g.offsets, g.succ, regs.to(torch.int16)),
        (g.offsets, g.succ, regs[:, :12].contiguous()),
        (g.offsets, g.succ, regs[:, ::2]),
        (g.offsets.to(torch.int32), g.succ, regs),
        (g.offsets[1:], g.succ, regs),
        (g.offsets, g.succ.to(torch.float32), regs),
        (g.offsets, g.succ, regs, torch.arange(5, dtype=torch.int32)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            PHB.merge_rows(*args)


@pytest.mark.parametrize("log2m", [2, 8])
@pytest.mark.parametrize("transpose", [False, True])
def test_runs_match_the_sequential_oracle(log2m, transpose):
    co, su = H.crawl(1500, seed=4)
    g = CSRGraph(co, su, device=CPU)
    hb = PHB.HyperBall(g, log2m=log2m, seed=5,
                       gt=g.transpose() if transpose else None)
    hb.run()
    if transpose:
        assert {"systolic", "local"} & set(hb.mode_history)
    seq = PHB.sequential_hyperball(g, log2m=log2m, seed=5)
    np.testing.assert_array_equal(hb.regs.numpy(), seq)
    # the arcs of a round are those of its node list's offsets
    assert hb.arcs_touched[0] == len(su)
    assert all(a <= len(su) for a in hb.arcs_touched)
