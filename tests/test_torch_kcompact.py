"""The port's compaction (B2, plain twin on the CPU) against the JAX package.

Random ragged layouts as in tests/test_kcompact.py, with invalid runs and
empty runs: the JAX kernel runs in interpret mode, the port's ``compact``
runs ``compact_plain`` on CPU tensors.  Exact on every valid position (and,
for JAX, outside its gather-fallback positions, which its caller splices).
"""

import numpy as np
import pytest
import torch

from webgraph_tpu.ops import kcompact as KC
from webgraph_tpu_torch.ops import kcompact as PKC

jnp = pytest.importorskip("jax.numpy")

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _random_layout(rng, R, V, max_arcs, empty_frac=0.2):
    arcs = rng.integers(0, max_arcs, size=R)
    arcs[rng.random(R) < empty_frac] = 0
    halo = rng.integers(0, V - max_arcs, size=R)
    halo = np.minimum(halo, V - arcs - 1)
    arc_start = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(arcs, out=arc_start[1:])
    src0 = np.arange(R, dtype=np.int64) * V + halo
    m = int(arc_start[-1])
    store = rng.integers(0, 1 << 30, size=R * V).astype(np.int32)
    exp = np.empty(m, dtype=np.int32)
    for i in range(R):
        a, b = arc_start[i], arc_start[i + 1]
        exp[a:b] = store[src0[i]:src0[i] + (b - a)]
    return arc_start, src0, m, store, exp


@pytest.mark.parametrize("seed,R,V,ma,invalid", [
    (0, 40, 64, 40, 0.0), (1, 300, 96, 90, 0.0), (2, 7, 512, 500, 0.0),
    (3, 128, 32, 2, 0.0), (4, 60, 64, 50, 0.3), (5, 500, 128, 100, 0.5)])
def test_compact_matches_jax(seed, R, V, ma, invalid):
    rng = np.random.default_rng(seed)
    arc_start, src0, m, store, exp = _random_layout(rng, R, V, ma)
    valid = rng.random(R) >= invalid
    vmask = np.zeros(m, dtype=bool)
    for i in np.flatnonzero(valid):
        vmask[arc_start[i]:arc_start[i + 1]] = True

    cp = PKC.plan_compact(arc_start, src0, valid, m, device=CPU)
    got = PKC.compact(cp, torch.from_numpy(store)).numpy()
    assert got.shape == (m,)
    np.testing.assert_array_equal(got[vmask], exp[vmask])

    jcp = KC.plan_compact(arc_start, src0, valid, m, store_elems=R * V)
    jgot = np.asarray(KC.compact(jcp, jnp.asarray(store), m,
                                 interpret=True))
    keep = vmask.copy()
    if jcp.fb_dst is not None:
        keep[np.asarray(jcp.fb_dst)] = False
    np.testing.assert_array_equal(got[keep], jgot[keep])


def test_compact_long_single_run():
    """One run spanning many output tiles."""
    m = 3 * PKC.TILE + 17
    store = np.arange(m + 64, dtype=np.int32)
    cp = PKC.plan_compact(np.asarray([0, m]), np.asarray([64]),
                          np.ones(1, bool), m, device=CPU)
    got = PKC.compact(cp, torch.from_numpy(store)).numpy()
    np.testing.assert_array_equal(got, np.arange(64, 64 + m))


def test_tile_index_bounds_every_run():
    """tile_run0 brackets the runs of every tile (the kernel's binary
    search range), including empty runs at tile boundaries."""
    rng = np.random.default_rng(9)
    arcs = rng.integers(0, 3000, size=50)
    arcs[::7] = 0
    arc_start = np.concatenate([[0], np.cumsum(arcs)])
    m = int(arc_start[-1])
    cp = PKC.plan_compact(arc_start, np.zeros(50, np.int64),
                          np.ones(50, bool), m, device=CPU)
    run0 = cp.tile_run0.numpy()
    assert run0[-1] == 49
    p = np.arange(m)
    run = np.searchsorted(arc_start[:-1], p, side="right") - 1
    tile = p // PKC.TILE
    assert (run0[tile] <= run).all() and (run <= run0[tile + 1]).all()


def test_plan_compact_rejects_bad_runs():
    with pytest.raises(ValueError):
        PKC.plan_compact(np.asarray([0, 5, 3]), np.zeros(2, np.int64),
                         np.ones(2, bool), 3, device=CPU)
    with pytest.raises(ValueError):
        PKC.plan_compact(np.asarray([1, 5]), np.zeros(1, np.int64),
                         np.ones(1, bool), 5, device=CPU)


def test_compact_rejects_runs_past_the_store():
    cp = PKC.plan_compact(np.asarray([0, 5, 9]), np.asarray([0, 10]),
                          np.ones(2, bool), 9, device=CPU)
    assert cp.src_end == 14
    with pytest.raises(ValueError, match="past the end"):
        PKC.compact(cp, torch.zeros(13, dtype=torch.int32))
    got = PKC.compact(cp, torch.arange(14, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 4, 10, 11, 12, 13])
    with pytest.raises(ValueError):
        PKC.plan_compact(np.asarray([0, 5]), np.asarray([-1]),
                         np.ones(1, bool), 5, device=CPU)
