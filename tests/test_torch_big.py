"""The port past 2^31 arcs: the procedural graph, its store by node ranges,
the sliced decode, and the twin of the JAX ``test_biggraph_over_2_31``.

At a small size on the CPU: ``tests/torch_big_graph.WebLikeGraph``'s
slices joined equal the whole graph, and ``chip_smoke.py``'s torch copy of
the generator equals it; the graph stored by node ranges
(``parallel.multihost.encode_shard`` with ``node_base``, joined by
``merge_shards``) decodes through ``decode_big_slices`` -- the plain
versions of B1 and B2 on the CPU -- and ``iter_csr_slices`` equal to the
generator, every slice on the kernel route with no lane decoded on the
host.  The full size (2^31 + 2^21 nodes, as the JAX test) runs with
``WEBGRAPH_BIG=1 pytest -m slow tests/test_torch_big.py``: about an hour,
since the streaming store is one host thread, in bounded memory (one
slice at a time).  And ``chip_smoke.hub_graph``, the graph of its
``hubs`` phase, replaces only its hubs' lists.
"""

import os

import numpy as np
import pytest
import torch

from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
from webgraph_tpu_torch.parallel.multihost import encode_shard, merge_shards
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from .torch_big_graph import WebLikeGraph

torch.set_num_threads(1)
CPU = torch.device("cpu")


# a copy of the JAX tests' BigGraph (tests/test_bigbv.py), for the twin of
# test_biggraph_over_2_31
class BigGraph:
    """Procedural graph of BVGraphSlowTest.java:30-52: nodes 0 and 1 have
    `outdegree` successors {0, step, 2*step, ...}; every other node has
    {x-2, x-1}.  Slices are produced vectorized."""

    def __init__(self, num_nodes, outdegree, step):
        assert outdegree * step <= num_nodes
        self.num_nodes = num_nodes
        self.outdegree = outdegree
        self.step = step

    @property
    def num_arcs(self):
        return 2 * self.outdegree + (self.num_nodes - 2) * 2

    def slice(self, lo, hi):
        """(csr_off, succ) for nodes [lo, hi)."""
        d = np.full(hi - lo, 2, dtype=np.int64)
        if lo == 0:
            d[0] = self.outdegree
        if lo <= 1 < hi:
            d[1 - lo] = self.outdegree
        co = np.zeros(hi - lo + 1, dtype=np.int64)
        np.cumsum(d, out=co[1:])
        su = np.empty(int(co[-1]), dtype=np.int64)
        x = np.arange(max(lo, 2), hi, dtype=np.int64)
        a = int(co[max(lo, 2) - lo])
        rest = np.empty((hi - max(lo, 2), 2), dtype=np.int64)
        rest[:, 0] = x - 2
        rest[:, 1] = x - 1
        su[a:] = rest.reshape(-1)
        head = np.arange(self.outdegree, dtype=np.int64) * self.step
        if lo == 0:
            su[:self.outdegree] = head
        if lo <= 1 < hi:
            b = int(co[1 - lo])
            su[b:b + self.outdegree] = head
        return co, su

    def slices(self, step_nodes=1 << 20):
        lo = 0
        while lo < self.num_nodes:
            hi = min(lo + step_nodes, self.num_nodes)
            yield self.slice(lo, hi)
            lo = hi


@pytest.mark.parametrize("n,step", [(100, 7), (5000, 1024), (4099, 4099)])
def test_slices_join_to_the_whole(n, step):
    g = WebLikeGraph(n, seed=3)
    co, su = g.slice(0, n)
    parts = list(g.slices(step))
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert np.array_equal(np.concatenate([p[3] for p in parts]), su)
    offs = np.concatenate([[0]] + [p[2][1:] + co[p[0]] for p in parts])
    assert np.array_equal(offs, co)
    # sorted, deduplicated lists inside [0, n): 12 local arcs and at most
    # 5 hashed ones each
    d = np.diff(co)
    assert d.min() >= 12 and d.max() <= 17
    for x in range(0, n, max(1, n // 50)):
        lst = su[co[x]:co[x + 1]]
        assert (np.diff(lst) > 0).all() and lst.min() >= 0 and lst.max() < n
        assert set((x + np.arange(1, 13)) % n) <= set(lst.tolist())


def test_chip_smoke_generator_is_the_same():
    import chip_smoke
    g = WebLikeGraph(3000, seed=chip_smoke.BIG_SEED)
    for lo, hi in [(0, 3000), (17, 1000), (2990, 3000)]:
        co, su = chip_smoke.web_like_slice(3000, chip_smoke.BIG_SEED, lo, hi,
                                           CPU)
        eco, esu = g.slice(lo, hi)
        assert np.array_equal(co.numpy(), eco)
        assert np.array_equal(su.numpy(), esu)


def test_a_large_range_keeps_both_limits_apart():
    """At 2^27 nodes the generator passes 2^31 arcs: its mean outdegree is
    17 less the rare duplicates, so 2^27 * 17 > 2^31 with room."""
    g = WebLikeGraph(1 << 27, seed=0)
    co, _ = g.slice(5 << 24, (5 << 24) + (1 << 16))
    assert co[-1] / (1 << 16) * (1 << 27) > 1.06 * (1 << 31)


def _store_by_ranges(g, base, settings, ranges, threads):
    for k, (lo, hi) in enumerate(ranges):
        co, su = g.slice(lo, hi)
        encode_shard(co, su, settings, base, k, lo, hi, threads=threads,
                     node_base=lo)
    return merge_shards(base, len(ranges), settings)


SETTINGS = {
    "default": BVGraphSettings(),
    "w3_int2": BVGraphSettings(window_size=3, min_interval_length=2),
}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_range_store_equals_a_whole_shard_store(tmp_path, name):
    """``encode_shard(node_base=lo)`` on a host's own range writes the
    bytes of ``encode_shard`` on the whole graph's arrays."""
    s = SETTINGS[name]
    g = WebLikeGraph(2000, seed=5)
    co, su = g.slice(0, 2000)
    ranges = [(0, 700), (700, 1500), (1500, 2000)]
    whole = str(tmp_path / "whole")
    for k, (lo, hi) in enumerate(ranges):
        encode_shard(co, su, s, whole, k, lo, hi, threads=2)
    merge_shards(whole, 3, s)
    part = str(tmp_path / "part")
    _store_by_ranges(g, part, s, ranges, threads=2)
    for ext in (".graph", ".offsets"):
        with open(whole + ext, "rb") as a, open(part + ext, "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_sliced_decode_of_a_range_store(tmp_path, name):
    s = SETTINGS[name]
    n = 3000
    g = WebLikeGraph(n, seed=7)
    base = str(tmp_path / "big")
    props = _store_by_ranges(g, base, s, [(0, 1024), (1024, 2048),
                                          (2048, n)], threads=3)
    co, _ = g.slice(0, n)
    assert int(props["nodes"]) == n and int(props["arcs"]) == co[-1]
    bv = BVGraph.load(base)
    offsets = bv.offsets_array()
    outd = PN.decode_outdegrees(bv.data, offsets, s.outdegree_coding)
    assert np.array_equal(outd, np.diff(co))
    rep = []
    x = 0
    for lo, hi, sco, ssu in decode_big_slices(
            offsets, outd, s, bv.data, slice_arcs=9000, device=CPU,
            target_arcs_per_lane=16, report=rep):
        eco, esu = g.slice(lo, hi)
        assert lo == x
        assert torch.equal(sco, torch.from_numpy(eco))
        assert torch.equal(ssu, torch.from_numpy(esu.astype(np.int32)))
        x = hi
    assert x == n and len(rep) >= 5
    assert all(r["route"] == "kernel" and r["fallback_arcs"] == 0
               for r in rep)
    bo = BVGraph.load(base, mode="offline")
    x = 0
    for lo, hi, sco, ssu in bo.iter_csr_slices(slice_nodes=700):
        eco, esu = g.slice(lo, hi)
        assert lo == x and np.array_equal(sco, eco)
        assert np.array_equal(ssu, esu)
        x = hi
    assert x == n


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("WEBGRAPH_BIG"),
                    reason="set WEBGRAPH_BIG=1 for the > 2^31 run (an hour)")
def test_biggraph_over_2_31(tmp_path):
    """The twin of the JAX ``test_biggraph_over_2_31``: > 2^31 nodes AND
    arcs, the port's streaming store + slice scan
    (BVGraphSlowTest.java:60-69 semantics)."""
    n = (1 << 31) + (1 << 21)
    bg = BigGraph(n, 1 << 20, 2)
    assert bg.num_arcs > (1 << 31) and bg.num_nodes > (1 << 31)
    base = str(tmp_path / "huge")
    props = BVGraph.store_slices(bg.slices(4 << 20), base)
    assert int(props["nodes"]) == n and int(props["arcs"]) == bg.num_arcs
    bv = BVGraph.load(base, mode="offline")
    checked = 0
    for lo, hi, co, su in bv.iter_csr_slices(slice_nodes=16 << 20):
        eco, esu = bg.slice(lo, hi)
        assert np.array_equal(co, eco) and np.array_equal(su, esu)
        checked = hi
    assert checked == n


def test_hub_graph_replaces_only_the_hubs_lists():
    import chip_smoke
    n, ids, degrees = 5000, (0, 1200, 4999), (300, 4000, 2500)
    co, su = chip_smoke.hub_graph(n, ids, degrees, seed=2)
    bco, bsu = synthesize_webgraph(n)
    assert len(co) == n + 1 and co[-1] == len(su)
    deg, bdeg = np.diff(co), np.diff(bco)
    others = np.setdiff1d(np.arange(n), ids)
    np.testing.assert_array_equal(deg[others], bdeg[others])
    for x in others[::97]:
        np.testing.assert_array_equal(su[co[x]:co[x + 1]],
                                      bsu[bco[x]:bco[x + 1]])
    for x, d in zip(ids, degrees):
        lst = su[co[x]:co[x + 1]]
        assert len(lst) == d and (np.diff(lst) > 0).all()
        assert 0 <= lst[0] and lst[-1] < n
    again = chip_smoke.hub_graph(n, ids, degrees, seed=2)
    np.testing.assert_array_equal(again[1], su)
