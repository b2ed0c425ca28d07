"""The port's multi-host encode and shard decode (``parallel/multihost``)
against the JAX package's (``tests/test_multihost.py``).

- A cold plan that starts past node 0 (``first_node``, a shard's plan)
  decodes the lists its first nodes reference before that node on the host:
  random shards under four stream formats equal ``native.bv_decode_all``.
- ``shard_bounds`` equals the JAX function's; ``store_multihost`` writes the
  JAX ``store_multihost``'s bytes with either backend and, one thread a
  host, those of the N-thread native encode; shard parts written by one
  package merge in the other to the same bytes.
- ``plan_shard_decode`` shards equal the JAX shards; ``initialize`` joins a
  two-process gloo group, and two ranks encode, merge and decode a graph.

Every comparison is exact.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.ops import kdecode as K
from webgraph_tpu.parallel import multihost as JMH
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.csr import decode_to_csr
from webgraph_tpu_torch.parallel import multihost as MH
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_multihost_rank as R
from .graphs import erdos_renyi
from .torch_edge_cases import simple
from .torch_file_cases import props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the stream formats of the shard-plan cases
SHARD_SETTINGS = {
    "default": BVGraphSettings(),
    "minint0": BVGraphSettings(min_interval_length=0),
    "w3": BVGraphSettings(window_size=3),
    "zeta2": BVGraphSettings(zeta_k=2),
}


def _webgraph(n=600, seed=3):
    return simple(*synthesize_webgraph(n, seed=seed))


def _crosses(refs, lo, hi, W):
    """A node of [lo, min(lo + W, hi)) references a list before lo."""
    x = np.arange(lo, min(lo + W, hi))
    return bool(((refs[x] > 0) & (x - refs[x] < lo)).any())


@pytest.mark.parametrize("target", [32, 128])
@pytest.mark.parametrize("sname", sorted(SHARD_SETTINGS))
def test_cold_shard_plan_matches_native(sname, target):
    """Random (lo, hi) shards decoded through ``decode_to_csr``: a halo list
    whose predecessor lies before lo has no lane; its values come from the
    host at plan time, and the shard equals the native decode."""
    s = SHARD_SETTINGS[sname]
    co, su = _webgraph()
    n = len(co) - 1
    graph, _gb, offs, _ob, _st = PN.bv_encode(co, su, s, threads=1)
    offsets = PN.decode_offset_stream(offs, n, s.offset_coding)
    hco, hsu = PN.bv_decode_all(graph, n, int(co[-1]), s)
    refs = PN.bv_scan_refs(graph, offsets, s)
    outd = np.diff(hco)
    rng = np.random.default_rng(len(sname) * 1000 + target)
    crossed = 0
    for _ in range(3):
        lo, hi = sorted(rng.choice(np.arange(1, n + 1), 2, replace=False))
        crossed += _crosses(refs, lo, hi, s.window_size)
        plan = PP.plan_kernel_decode(offsets[:hi + 1], outd[:hi], s, graph,
                                     device=CPU, first_node=lo,
                                     target_arcs_per_lane=target)
        assert plan.cold
        pco, succ, filled = decode_to_csr(plan)
        assert filled == 0
        np.testing.assert_array_equal(pco, hco[lo:hi + 1] - hco[lo])
        np.testing.assert_array_equal(succ.numpy(), hsu[hco[lo]:hco[hi]])
    assert crossed, "no shard references a list before its first node"


def test_cold_shard_plan_lists_stay_on_device_past_the_first_node():
    """Only the lists before ``first_node`` leave the wavefront: the others
    keep their device source, their depths are the chain depths, and a
    ``first_node == 0`` plan keeps every list."""
    s = BVGraphSettings()
    co, su = _webgraph()
    n = len(co) - 1
    graph, _gb, offs, _ob, _st = PN.bv_encode(co, su, s, threads=1)
    offsets = PN.decode_offset_stream(offs, n, s.offset_coding)
    outd = np.diff(co)
    whole = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU)
    lo = 300
    part = PP.plan_kernel_decode(offsets, outd, s, graph, device=CPU,
                                 first_node=lo)
    assert (whole.wf_nodes >= 0).all() and len(whole.wf_nodes)
    assert (part.wf_nodes >= lo).all() and not part.resolved
    refs = PN.bv_scan_refs(graph, offsets, s).astype(np.int64)
    D, first = PP.chain_depths(refs, part.chunk_starts, s.max_ref_count)
    np.testing.assert_array_equal(part.wf_depth, D[part.wf_nodes - first])


def test_shard_plan_beside_jax_interpret(tmp_path):
    """Two shards, beside the JAX ``plan_shard_decode`` + ``decode_full``
    (interpret mode), as ``tests/test_multihost.py`` runs them."""
    g = erdos_renyi(500, 0.04, seed=5)
    base = str(tmp_path / "g")
    JBV.store(g, base)
    jbv = JBV.load(base)
    bv = BVGraph.load(base)
    data = np.asarray(jbv.data)
    for k in range(2):
        prep, jlo, jhi = JMH.plan_shard_decode(jbv, data, k, 2)
        out, diag, hv = K.decode_full(prep)
        errs = K.check_diag(prep, diag)
        jco, jsu = K.chunked_to_csr(prep, out, data=data,
                                    settings=jbv.settings, errs=errs,
                                    hub_vals=hv)
        plan, lo, hi = MH.plan_shard_decode(bv, bv.data, k, 2, device=CPU)
        assert (lo, hi) == (jlo, jhi)
        pco, succ, filled = decode_to_csr(plan)
        assert filled == 0
        np.testing.assert_array_equal(pco, np.asarray(jco))
        np.testing.assert_array_equal(succ.numpy(), np.asarray(jsu))


@pytest.mark.parametrize("procs", [2, 3])
def test_plan_shard_decode_partitions(tmp_path, procs):
    """Each process's shard is the JAX shard's node range (the JAX
    ``shard_bounds`` over the outdegrees) and holds its CSR; the shards
    concatenate to the whole graph."""
    g = erdos_renyi(500, 0.04, seed=5)
    base = str(tmp_path / "g")
    JBV.store(g, base)
    exp = g.to_csr()
    jb = JMH.shard_bounds(exp.offsets, procs)
    bv = BVGraph.load(base)
    got = []
    for k in range(procs):
        plan, lo, hi = MH.plan_shard_decode(bv, bv.data, k, procs,
                                            device=CPU)
        assert (lo, hi) == (jb[k], jb[k + 1])
        pco, succ, _ = decode_to_csr(plan)
        np.testing.assert_array_equal(
            pco, exp.offsets[lo:hi + 1] - exp.offsets[lo])
        got.append(succ.numpy())
    np.testing.assert_array_equal(np.concatenate(got), exp.succ)


@pytest.mark.parametrize("n,m,shards", [(500, 2000, 7), (5, 40, 9),
                                         (50, 0, 4), (0, 0, 3)])
def test_shard_bounds_match_jax(n, m, shards):
    rng = np.random.default_rng(n + m)
    co = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(rng.multinomial(m, np.ones(n) / n), out=co[1:])
    b = MH.shard_bounds(co, shards)
    np.testing.assert_array_equal(b, JMH.shard_bounds(co, shards))
    assert b[0] == 0 and b[-1] == n and (np.diff(b) >= 0).all()


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """The JAX ``store_multihost`` of the test graph at each (hosts,
    threads a host)."""
    d = tmp_path_factory.mktemp("jax_mh")
    g = erdos_renyi(600, 0.03, seed=13).to_csr()
    out = {}
    for hosts in (2, 4):
        for tph in (1, 2):
            base = str(d / f"j{hosts}_{tph}")
            JMH.store_multihost(g, base, hosts, settings=JSettings(),
                                threads_per_host=tph)
            out[hosts, tph] = base
    return g, out


def _same_files(a, b):
    for ext in (".graph", ".offsets"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    assert props_lines(a + ".properties") == props_lines(b + ".properties")


@pytest.mark.parametrize("backend", ["native", "cuda"])
@pytest.mark.parametrize("tph", [1, 2])
@pytest.mark.parametrize("hosts", [2, 4])
def test_store_multihost_matches_jax(tmp_path, jax_stores, hosts, tph,
                                     backend):
    g, jbases = jax_stores
    s = BVGraphSettings()
    base = str(tmp_path / "mh")
    props = MH.store_multihost(CSRGraph(g.offsets, g.succ, device=CPU), base,
                               hosts, settings=s, threads_per_host=tph,
                               backend=backend, device="cpu")
    _same_files(base, jbases[hosts, tph])
    assert int(props["arcs"]) == g.num_arcs
    assert not [f for f in os.listdir(tmp_path) if "-h" in f]
    if tph == 1:
        gb, _b, ob, _o, _st = PN.bv_encode(g.offsets, g.succ, s,
                                           threads=hosts)
        with open(base + ".graph", "rb") as f:
            assert f.read() == gb.tobytes()
        with open(base + ".offsets", "rb") as f:
            assert f.read() == ob.tobytes()
    bv = BVGraph.load(base)
    co, su = PN.bv_decode_all(bv.data, bv.num_nodes, bv.num_arcs,
                              bv.settings)
    np.testing.assert_array_equal(co, g.offsets)
    np.testing.assert_array_equal(su, g.succ)


@pytest.mark.parametrize("n,hosts", [(0, 2), (3, 5), (40, 3)])
def test_store_multihost_edges_match_jax(tmp_path, n, hosts):
    """n = 0, and more hosts than nodes (empty shards)."""
    g = erdos_renyi(n, 0.2, seed=4).to_csr()
    jb, pb = str(tmp_path / "j"), str(tmp_path / "p")
    JMH.store_multihost(g, jb, hosts)
    for backend in ("native", "cuda"):
        MH.store_multihost(CSRGraph(g.offsets, g.succ, num_nodes=n,
                                    device=CPU),
                           pb, hosts, backend=backend, device="cpu")
        _same_files(pb, jb)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_parts_cross_packages(tmp_path, writer):
    """Parts written by one package's ``encode_shard`` merge in the other's
    ``merge_shards`` to the same files as a merge in the writer's own."""
    g = erdos_renyi(300, 0.04, seed=8).to_csr()
    s, js = BVGraphSettings(), JSettings()
    bounds = MH.shard_bounds(g.offsets, 3)
    own, other = str(tmp_path / "own"), str(tmp_path / "other")
    for base in (own, other):
        for k in range(3):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            if writer == "jax":
                JMH.encode_shard(g.offsets, g.succ, js, base, k, lo, hi,
                                 threads=2)
            else:
                MH.encode_shard(g.offsets, g.succ, s, base, k, lo, hi,
                                threads=2)
    if writer == "jax":
        JMH.merge_shards(own, 3, js)
        MH.merge_shards(other, 3, s)
    else:
        MH.merge_shards(own, 3, s)
        JMH.merge_shards(other, 3, js)
    _same_files(own, other)


def test_encode_shard_parts_match_jax(tmp_path):
    """One shard's ``.graph``/``.offsets``/``.meta`` from either backend
    equal the JAX ``encode_shard``'s."""
    g = erdos_renyi(300, 0.04, seed=8).to_csr()
    jb = str(tmp_path / "j")
    JMH.encode_shard(g.offsets, g.succ, JSettings(), jb, 1, 90, 260,
                     threads=3)
    for backend in ("native", "cuda"):
        pb = str(tmp_path / backend)
        meta = MH.encode_shard(torch.from_numpy(g.offsets),
                               torch.from_numpy(g.succ), BVGraphSettings(),
                               pb, 1, 90, 260, threads=3, backend=backend,
                               device="cpu")
        assert meta["lo"] == 90 and meta["hi"] == 260
        for ext in (".graph", ".offsets", ".meta"):
            with open(f"{jb}-h1{ext}", "rb") as a, \
                    open(f"{pb}-h1{ext}", "rb") as b:
                assert a.read() == b.read(), (backend, ext)


def test_encode_shard_rejects_unknown_backend(tmp_path):
    co = np.array([0, 1], dtype=np.int64)
    with pytest.raises(ValueError, match="backend"):
        MH.encode_shard(co, np.zeros(1, np.int64), BVGraphSettings(),
                        str(tmp_path / "x"), 0, 0, 1, backend="tpu")


def test_initialize_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize() == (0, 1)


def test_two_ranks_encode_merge_and_decode(tmp_path):
    """Two gloo ranks on the CPU (spawn, ``file://`` rendezvous): each
    encodes its shard, rank 0 merges after a barrier, and each then plans
    and decodes its shard of the merged files.  The merge equals the
    2-thread native encode; the shards equal the graph's."""
    co, su = _webgraph(400, seed=6)
    np.save(tmp_path / "co.npy", co)
    np.save(tmp_path / "su.npy", su)
    ctx = mp.spawn(R.rank_main, args=(str(tmp_path),), nprocs=2, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in 240 s")
    base = str(tmp_path / "g")
    gb, _b, ob, _o, _st = PN.bv_encode(co, su, BVGraphSettings(), threads=2)
    with open(base + ".graph", "rb") as f:
        assert f.read() == gb.tobytes()
    with open(base + ".offsets", "rb") as f:
        assert f.read() == ob.tobytes()
    b = MH.shard_bounds(co, 2)
    for k in range(2):
        lo, hi = b[k], b[k + 1]
        got = np.load(tmp_path / f"succ{k}.npy")
        np.testing.assert_array_equal(got, su[co[lo]:co[hi]])

