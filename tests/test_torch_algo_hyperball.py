"""The port's HyperBall class against the JAX package's, case by case
(the HyperBall cases of ``tests/test_algo.py``), on CPU tensors.

Registers, ``mode_history``, ``arcs_touched``, ``modified`` and
``iteration`` are integers: exactly equal.  The neighbourhood function and
the distance sums are float64 sums in another order: ``rtol = 1e-12``.
Within the port, what the JAX tests assert exactly (external NF against a
standard run, a resumed run against an unbroken one) is asserted exactly.
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
