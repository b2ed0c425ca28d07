"""The port's HyperBall class against the JAX package's, case by case
(the HyperBall cases of ``tests/test_algo.py``), on CPU tensors.

Registers, ``mode_history``, ``arcs_touched``, ``modified`` and
``iteration`` are integers: exactly equal.  The neighbourhood function and
the distance sums are float64 sums in another order: ``rtol = 1e-12``.
Within the port, what the JAX tests assert exactly (external NF against a
standard run, a resumed run against an unbroken one) is asserted exactly.

The count estimate's wrapper, ``estimate_rows``, runs its plain twin on
CPU tensors: it equals ``estimate_counts_device`` of the gathered rows
exactly, and the JAX package's numpy ``estimate_counts`` at ``rtol``.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as J
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu_torch import algo as P
from webgraph_tpu_torch import state
from webgraph_tpu_torch.algo import hyperball as PHB
from webgraph_tpu_torch.core.graph import CSRGraph

from . import torch_hyperball_cases as H
from .graphs import cycle_graph, erdos_renyi

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-12


def port(g) -> CSRGraph:
    return state.csr_from_numpy(g.offsets, g.succ, CPU)


def regs_of(hb) -> np.ndarray:
    r = hb.regs
    return (state.registers_to_jax(r) if isinstance(r, torch.Tensor)
            else np.asarray(r))


def assert_same_run(p, j, sums=True):
    np.testing.assert_array_equal(regs_of(p), np.asarray(j.regs))
    assert p.mode_history == j.mode_history
    assert p.arcs_touched == j.arcs_touched
    assert (p.modified, p.iteration) == (j.modified, j.iteration)
    np.testing.assert_allclose(p.neighbourhood_function,
                               j.neighbourhood_function, rtol=RTOL, atol=0)
    np.testing.assert_allclose(p.reachable_counts().numpy(),
                               j.reachable_counts(), rtol=RTOL, atol=0)
    for name in ("sum_of_distances", "sum_of_inverse_distances"):
        a, b = getattr(p, name), getattr(j, name)
        assert (a is None) == (b is None)
        if sums and a is not None:
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=0)


def both(g, gt=False, **kw):
    j = J.HyperBall(g, gt=g.transpose() if gt else None, **kw)
    pg = port(g)
    p = P.HyperBall(pg, gt=pg.transpose() if gt else None, **kw)
    return j, p


def path_with_cluster():
    lists = [[i + 1] for i in range(299)] + [[0, 150]]
    return JCSR.from_lists([np.asarray(x, dtype=np.int64) for x in lists])


def random_lists(n=400, seed=7):
    rng = np.random.default_rng(seed)
    return JCSR.from_lists([
        np.unique(rng.integers(0, n, rng.integers(1, 5))).astype(np.int64)
        for _ in range(n)])


def test_dense_matches_jax_and_both_oracles():
    g = erdos_renyi(60, 0.06, seed=4)
    j, p = both(g, log2m=4, seed=1)
    j.run()
    p.run()
    assert_same_run(p, j)
    seq = J.sequential_hyperball(g, log2m=4, seed=1)
    np.testing.assert_array_equal(P.sequential_hyperball(port(g), 4, 1), seq)
    np.testing.assert_array_equal(regs_of(p), seq)


def test_neighbourhood_function_on_a_cycle():
    j, p = both(cycle_graph(40), log2m=6, seed=0)
    assert_same_run(p, j)
    np.testing.assert_allclose(p.run(), j.run(), rtol=RTOL, atol=0)
    assert p.neighbourhood_function[0] == 40.0
    assert_same_run(p, j)


def test_systolic_and_local_engage_on_a_path():
    g = path_with_cluster()
    j, p = both(g, gt=True, log2m=4, seed=3)
    j.run()
    p.run()
    assert_same_run(p, j)
    assert "systolic" in p.mode_history and "local" in p.mode_history
    np.testing.assert_array_equal(
        regs_of(p), J.sequential_hyperball(g, log2m=4, seed=3))


def test_sparse_rounds_cost_less_and_agree_with_dense():
    g = random_lists()
    j, p = both(g, gt=True, log2m=5, seed=2)
    jd, pd = both(g, log2m=5, seed=2)
    for hb in (j, p, jd, pd):
        hb.run()
    assert_same_run(p, j)
    assert_same_run(pd, jd)
    np.testing.assert_array_equal(regs_of(p), regs_of(pd))
    # the changed sets agree, so the NF agrees exactly within the port
    assert p.neighbourhood_function == pd.neighbourhood_function
    sparse = [a for md, a in zip(p.mode_history, p.arcs_touched)
              if md != "dense"]
    assert sparse and min(sparse) < g.num_arcs


def test_save_load_resume(tmp_path):
    g = erdos_renyi(50, 0.08, seed=9)
    pg = port(g)
    kw = dict(log2m=4, seed=1, do_sum_of_distances=True)
    p = P.HyperBall(pg, gt=pg.transpose(), **kw)
    j = J.HyperBall(g, gt=g.transpose(), **kw)
    for hb in (p, j):
        hb.iterate()
        hb.iterate()
    path = str(tmp_path / "state.npz")
    p.save_state(path)
    p.run()
    j.run()
    assert_same_run(p, j)
    p2 = P.HyperBall(pg, gt=pg.transpose(), **kw)
    p2.load_state(path)
    p2.run()
    np.testing.assert_array_equal(regs_of(p2), regs_of(p))
    assert torch.equal(p2.sum_of_distances, p.sum_of_distances)
    assert p2.neighbourhood_function == p.neighbourhood_function
    with pytest.raises(ValueError):
        P.HyperBall(pg, log2m=5, seed=1).load_state(path)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_state_resumes_across_packages(tmp_path, saver):
    """A state saved by one package after two iterations finishes in the
    other: the JAX .npz keys and dtypes, registers through state's
    converters."""
    g = erdos_renyi(80, 0.05, seed=12)
    pg = port(g)
    kw = dict(log2m=5, seed=4, do_sum_of_distances=True,
              do_sum_of_inverse_distances=True)
    whole = J.HyperBall(g, gt=g.transpose(), **kw)
    whole.run()
    first = (J.HyperBall(g, gt=g.transpose(), **kw) if saver == "jax"
             else P.HyperBall(pg, gt=pg.transpose(), **kw))
    first.iterate()
    first.iterate()
    path = str(tmp_path / "half")
    first.save_state(path)
    z = np.load(path + ".npz")
    assert z["regs"].dtype == np.uint8 and z["counts"].dtype == np.float64
    assert z["mod_mask"].dtype == bool
    rest = (P.HyperBall(pg, gt=pg.transpose(), **kw) if saver == "jax"
            else J.HyperBall(g, gt=g.transpose(), **kw))
    rest.load_state(path)
    rest.run()
    assert rest.iteration == whole.iteration
    assert rest.mode_history == whole.mode_history[2:]
    np.testing.assert_array_equal(regs_of(rest), np.asarray(whole.regs))
    np.testing.assert_allclose(rest.neighbourhood_function,
                               whole.neighbourhood_function, rtol=RTOL)
    for name in ("sum_of_distances", "sum_of_inverse_distances"):
        a = getattr(rest, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, getattr(whole, name), rtol=RTOL,
                                   atol=0)


def test_centralities_accumulate():
    j, p = both(cycle_graph(8), log2m=6, seed=0, do_sum_of_distances=True,
                do_sum_of_inverse_distances=True)
    j.run()
    p.run()
    assert_same_run(p, j)
    assert bool((p.sum_of_distances > 0).all())
    assert bool((p.sum_of_inverse_distances > 0).all())


def test_effective_diameter():
    j, p = both(cycle_graph(30), log2m=7, seed=0)
    jed = J.effective_diameter(j.run(), 0.9)
    ped = P.effective_diameter(p.run(), 0.9)
    np.testing.assert_allclose(ped, jed, rtol=1e-9)
    for nf in ([], [5.0], [1.0, 1.0, 3.0], [2.0, 4.0, 8.0, 9.0]):
        for a in (0.5, 0.9, 1.0):
            assert P.effective_diameter(nf, a) == J.effective_diameter(nf, a)


def test_external_in_memory_and_memmap(tmp_path):
    g = erdos_renyi(120, 0.05, seed=9)
    pg = port(g)
    jx = J.HyperBall(g, log2m=4, seed=1, external_chunk=64)
    px = P.HyperBall(pg, log2m=4, seed=1, external_chunk=64)
    jx.run()
    px.run()
    assert_same_run(px, jx)
    assert isinstance(px.regs, np.ndarray)
    assert "dense-external" in px.mode_history
    jm = J.HyperBall(g, log2m=4, seed=1, gt=g.transpose(), external_chunk=64,
                     regs_path=str(tmp_path / "j.npy"))
    pm = P.HyperBall(pg, log2m=4, seed=1, gt=pg.transpose(),
                     external_chunk=64, regs_path=str(tmp_path / "p.npy"))
    jm.run()
    pm.run()
    assert_same_run(pm, jm)
    assert isinstance(pm.regs, np.memmap)
    assert any(m.endswith("-external") and m != "dense-external"
               for m in pm.mode_history)
    seq = J.sequential_hyperball(g, log2m=4, seed=1)
    np.testing.assert_array_equal(regs_of(pm), seq)
    # within the port the NF of external runs equals a standard run's
    ps = P.HyperBall(pg, log2m=4, seed=1)
    ps.run()
    assert ps.neighbourhood_function == px.neighbourhood_function
    assert ps.neighbourhood_function == pm.neighbourhood_function


def test_device_round_with_a_source_index_built_once():
    """``device_round`` (host or device offsets) equals the scatter-max
    over the graph's source index, built once and kept."""
    g = erdos_renyi(150, 0.06, seed=2)
    pg = port(g)
    regs = torch.from_numpy(PHB.hyperloglog_init(150, 4, seed=3))
    want = PHB._scatter_max_rows(regs.clone(), pg.arc_sources(), regs,
                                 pg.succ)
    assert torch.equal(PHB.device_round(g.offsets, pg.succ, regs), want)
    assert torch.equal(PHB.device_round(pg.offsets, pg.succ, regs), want)
    assert pg.arc_sources() is pg.arc_sources()
    with pytest.raises(ValueError):
        PHB.device_round(pg.offsets[1:], pg.succ, regs)


@pytest.mark.parametrize("n,log2m,seed", [(1000, 4, 0), (777, 6, 1),
                                          (50, 7, 2 ** 40 + 3)])
def test_init_on_the_device_matches_numpy(n, log2m, seed):
    want = J.hyperloglog_init(n, log2m, seed)
    np.testing.assert_array_equal(PHB.hyperloglog_init(n, log2m, seed), want)
    got = PHB.hyperloglog_init_device(n, log2m, seed, CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_estimate_counts_device_matches_numpy():
    regs = PHB.hyperloglog_init(300, 5, seed=2)
    regs[7, :] = 0
    regs[9, :] = 40
    np.testing.assert_allclose(
        PHB.estimate_counts_device(torch.from_numpy(regs)).numpy(),
        J.estimate_counts(regs), rtol=RTOL, atol=0)


# -- the count estimate's wrapper on CPU tensors ----------------------------

EST_N = 900


@pytest.mark.parametrize("log2m", H.LOG2MS)
def test_estimate_rows_equals_the_library_estimate(log2m):
    top = min(46, H.exact_top(log2m))
    regs = torch.from_numpy(H.counters(EST_N, log2m, top, seed=log2m))
    nodes = torch.from_numpy(H.node_list(EST_N, seed=log2m))
    rev = nodes.flip(0).contiguous()
    for nd in (nodes, rev):
        got = PHB.estimate_rows(regs, nd)
        assert got.dtype == torch.float64 and got.shape == (nd.numel(),)
        assert torch.equal(got, PHB.estimate_counts_device(regs[nd]))
    whole = PHB.estimate_rows(regs)
    assert torch.equal(whole, PHB.estimate_counts_device(regs))
    np.testing.assert_allclose(whole.numpy(),
                               J.estimate_counts(regs.numpy()), rtol=RTOL,
                               atol=0)
    none = PHB.estimate_rows(regs, torch.zeros(0, dtype=torch.int64))
    assert none.dtype == torch.float64 and none.shape == (0,)


@pytest.mark.parametrize("log2m", H.LOG2MS)
def test_estimate_rows_small_range_and_the_highest_registers(log2m):
    """Rows of zeros take the small-range branch (a count of 0); registers
    up to 64 - log2m + 1, the most ``hyperloglog_init`` writes."""
    top = 64 - log2m + 1
    regs = H.counters(EST_N, log2m, top, seed=log2m)
    assert regs.max() == top and not regs[0].any()
    t = torch.from_numpy(regs)
    got = PHB.estimate_rows(t)
    assert torch.equal(got, PHB.estimate_counts_device(t))
    np.testing.assert_allclose(got.numpy(), J.estimate_counts(regs),
                               rtol=RTOL, atol=0)
    assert float(got[0]) == 0.0
    m = 1 << log2m
    small = (regs == 0).any(1) & (got.numpy() <= 2.5 * m)
    assert small[1::4].any() and (~small[3::4]).any()


def test_estimate_rows_rejects_what_the_kernel_does_not_take():
    regs = torch.from_numpy(H.counters(50, 4, 46))
    nodes = torch.arange(5, dtype=torch.int64)
    bad = [
        (regs.to(torch.int16), nodes),
        (regs[:, :12].contiguous(), nodes),
        (regs[:, ::2], nodes),
        (regs[0], None),
        (regs, nodes.to(torch.int32)),
        (regs, torch.zeros(5, dtype=torch.int64, device="meta")),
        (regs, nodes[::2]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            PHB.estimate_rows(*args)


@pytest.mark.parametrize("bad_id", [EST_N, 1 << 40])
def test_estimate_rows_refuses_an_id_past_the_rows_on_the_cpu(bad_id):
    """An id >= n is refused on CPU tensors (the card does not check ids;
    the wrapper asks for ids in [0, n))."""
    regs = torch.from_numpy(H.counters(EST_N, 4, 46))
    nodes = torch.tensor([0, bad_id, 3], dtype=torch.int64)
    with pytest.raises(IndexError):
        PHB.estimate_rows(regs, nodes)


@pytest.mark.parametrize("external_chunk", [0, 64])
def test_estimate_on_the_cpu_runs_the_library_estimate(monkeypatch,
                                                       external_chunk):
    """``_estimate`` reaches ``estimate_counts_device`` through the module,
    by name, in both modes: a patch there lands in the counts."""
    g = port(erdos_renyi(120, 0.05, seed=9))
    real, rows = PHB.estimate_counts_device, []

    def doubled(regs):
        rows.append(regs.shape[0])
        return real(regs) * 2

    plain = P.HyperBall(g, log2m=4, seed=1, external_chunk=external_chunk)
    monkeypatch.setattr(PHB, "estimate_counts_device", doubled)
    hb = P.HyperBall(g, log2m=4, seed=1, external_chunk=external_chunk)
    assert rows == [120]
    assert torch.equal(hb.reachable_counts(), 2 * plain.reachable_counts())
    hb.iterate()
    assert len(rows) == 2 and rows[1] == hb.modified > 0


@pytest.mark.parametrize("log2m", H.LOG2MS)
def test_external_counts_equal_the_resident_run(tmp_path, log2m):
    g = port(erdos_renyi(150, 0.04, seed=log2m))
    gt = g.transpose()
    resident = P.HyperBall(g, log2m=log2m, seed=2, gt=gt,
                           do_sum_of_distances=True)
    external = P.HyperBall(g, log2m=log2m, seed=2, gt=gt,
                           do_sum_of_distances=True, external_chunk=40,
                           regs_path=str(tmp_path / "r.npy"))
    assert torch.equal(external.reachable_counts(),
                       resident.reachable_counts())
    resident.run()
    external.run()
    np.testing.assert_array_equal(regs_of(external), regs_of(resident))
    assert torch.equal(external.reachable_counts(),
                       resident.reachable_counts())
    assert external.neighbourhood_function == resident.neighbourhood_function
    assert torch.equal(external.sum_of_distances, resident.sum_of_distances)
