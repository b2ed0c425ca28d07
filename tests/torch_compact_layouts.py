"""Run layouts for the compaction kernel's tests (B2, ``csrc/compact.cu``):
the edge cases of its 16-byte path (every output and source alignment,
empty and 1-3-arc runs, a run over several tiles, more runs in a tile than
its shared-memory slice holds, invalid runs, a run ending at the store's
last word) and the random layouts of ``test_torch_kcompact.py``.  Used on
the CPU by ``test_torch_kcompact_host.py`` and on the card by
``test_torch_gpu.py``.
"""

import numpy as np
import torch

from webgraph_tpu_torch.ops import kcompact as PKC

# each layout: rng -> (arcs per run, src0, valid, store length)

def _src_after(arcs, gap):
    """Runs laid out one after another in the store, ``gap`` words before
    each (a lane's halo rows)."""
    seg = arcs + gap
    return np.cumsum(seg) - arcs, int(seg.sum())


def layout_alignments(rng):
    """Every pair of output and source alignment (mod 4), in runs of 1 to
    40 arcs."""
    R = 600
    arcs = rng.integers(1, 41, size=R)
    src0, n = _src_after(arcs, rng.integers(0, 8, size=R))
    return arcs, src0, np.ones(R, bool), n


def layout_short_runs(rng):
    """Empty runs and runs of 1-3 arcs only."""
    R = 3000
    arcs = rng.integers(0, 4, size=R)
    src0, n = _src_after(arcs, rng.integers(0, 5, size=R))
    return arcs, src0, np.ones(R, bool), n


def layout_long_run(rng):
    """One run of several shipped tiles between short ones, its source at
    an odd offset."""
    arcs = np.asarray([3, 0, 1, 5 * PKC.TILE + 7, 2, 0, 9, 1])
    src0, n = _src_after(arcs, np.asarray([1, 2, 0, 3, 1, 0, 2, 5]))
    return arcs, src0, np.ones(len(arcs), bool), n


def layout_many_runs(rng):
    """More runs in a shipped tile than its shared-memory slice holds (256),
    with long empty stretches: the chunked path."""
    R = 6000
    arcs = rng.integers(0, 6, size=R)
    arcs[1000:1400] = 0
    src0, n = _src_after(arcs, rng.integers(0, 3, size=R))
    return arcs, src0, np.ones(R, bool), n


def layout_invalid(rng):
    """Invalid runs among valid ones, short and long, at every alignment."""
    R = 900
    arcs = rng.integers(0, 30, size=R)
    arcs[::17] = rng.integers(100, 3000, size=len(arcs[::17]))
    src0, n = _src_after(arcs, rng.integers(0, 6, size=R))
    valid = rng.random(R) >= 0.4
    return arcs, src0, valid, n


def layout_store_end(rng):
    """The last run ends at the last store word, off a 16-byte boundary:
    the aligned window past it is never read."""
    arcs = np.asarray([4100, 7, 3, 5, 0, 13])
    src0, n = _src_after(arcs, np.asarray([2, 1, 0, 3, 1, 2]))
    assert n % 4 != 0
    return arcs, src0, np.ones(len(arcs), bool), n


def layout_scattered(rng):
    """Runs whose sources are scattered out of order over the store."""
    R = 400
    arcs = rng.integers(0, 200, size=R)
    slot = 256
    src0 = rng.permutation(R).astype(np.int64) * slot + rng.integers(
        0, slot - 199, size=R)
    return arcs, src0, rng.random(R) >= 0.1, R * slot


def layout_random(seed, R, V, ma, invalid):
    """The ragged layouts of test_torch_kcompact.py, from their seeds."""
    def make(_rng):
        rng = np.random.default_rng(seed)
        arcs = rng.integers(0, ma, size=R)
        arcs[rng.random(R) < 0.2] = 0
        halo = rng.integers(0, V - ma, size=R)
        halo = np.minimum(halo, V - arcs - 1)
        src0 = np.arange(R, dtype=np.int64) * V + halo
        return arcs, src0, rng.random(R) >= invalid, R * V
    return make


LAYOUTS = {
    "alignments": layout_alignments,
    "short_runs": layout_short_runs,
    "long_run": layout_long_run,
    "many_runs": layout_many_runs,
    "invalid": layout_invalid,
    "store_end": layout_store_end,
    "scattered": layout_scattered,
    "random0": layout_random(0, 40, 64, 40, 0.0),
    "random1": layout_random(1, 300, 96, 90, 0.0),
    "random2": layout_random(2, 7, 512, 500, 0.0),
    "random3": layout_random(3, 128, 32, 2, 0.0),
    "random4": layout_random(4, 60, 64, 50, 0.3),
    "random5": layout_random(5, 500, 128, 100, 0.5),
}


def build_layout(name, tile=PKC.TILE, device="cpu"):
    """Layout ``name`` planned for ``tile`` on ``device``: (plan, store,
    mask of valid positions, arcs per run, arc_start, src0)."""
    rng = np.random.default_rng(sorted(LAYOUTS).index(name) + 11)
    arcs, src0, valid, n = LAYOUTS[name](rng)
    arc_start = np.zeros(len(arcs) + 1, dtype=np.int64)
    np.cumsum(arcs, out=arc_start[1:])
    m = int(arc_start[-1])
    store = torch.from_numpy(rng.integers(-2**31, 2**31, size=n)
                             .astype(np.int32)).to(device)
    cp = PKC.plan_compact(arc_start, src0, valid, m, device=device, tile=tile)
    vmask = torch.from_numpy(np.repeat(np.asarray(valid, bool), arcs))
    return cp, store, vmask.to(device), arcs, arc_start, np.asarray(src0)
