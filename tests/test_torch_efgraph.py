"""The port's EFGraph files and device decode against the JAX package's.

The cases of ``tests/test_efgraph.py``, ``tests/test_ef_golden.py``,
``tests/test_efdecode.py`` and ``tests/test_ef_index.py``, run through both
packages on the same graphs:

- the port's bulk writer (numpy, every node at once) writes the bytes of
  the JAX ``EFGraph.store`` for every quantum, upper bound, empty list and
  byte order, and so does its per-arc loop (``backend="python"``, the plain
  version); ``.properties`` is equal bar the date comment line;
- the port's host readers (``successors``, ``successors_from``,
  ``iter_nodes`` with and without offsets) equal the JAX package's;
- ``EFGraph.to_device("cpu")`` equals the JAX ``ef_decode_to_csr``, also
  with the decode cut into chunks of a few arcs;
- the ``.obl`` Elias-Fano list and its torch select equal the JAX
  package's.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu.codecs import efgraph as JE
from webgraph_tpu.core import graph as jcore
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.ops import ef_index as JI
from webgraph_tpu.ops.bitio import BitWriter as JBitWriter
from webgraph_tpu.ops.efdecode import ef_decode_to_csr as j_ef_decode
from webgraph_tpu.ops.longword import LongWordWriter as JLongWordWriter
from webgraph_tpu_torch.codecs import efgraph as PE
from webgraph_tpu_torch.codecs.efgraph import EFGraph
from webgraph_tpu_torch.core import graph as core
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops import ef_index as PI
from webgraph_tpu_torch.ops import efdecode as PD
from webgraph_tpu_torch.ops.longword import LongWordReader, LongWordWriter

from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph
from .test_ef_golden import bits_to_le_longwords, java_ef_graph_bits
from .torch_file_cases import edge_graphs, props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graphs():
    g = {"er_80_1_0": erdos_renyi(80, 0.1, seed=0),
         "er_200_02_1": erdos_renyi(200, 0.02, seed=1),
         "er_150_15_3": erdos_renyi(150, 0.15, seed=3),
         "er_150_3_2": erdos_renyi(150, 0.3, seed=2),
         "er_120_2_7": erdos_renyi(120, 0.2, seed=7),
         "er_60_1_5": erdos_renyi(60, 0.1, seed=5),
         "complete12": complete_graph(12), "cycle33": cycle_graph(33),
         "star19": star_graph(19),
         "empty_lists": JCSR.from_lists([np.zeros(0, np.int64),
                                         np.asarray([0, 2]),
                                         np.zeros(0, np.int64)])}
    g.update(edge_graphs())
    return g


def _port(g) -> CSRGraph:
    return CSRGraph(g.offsets, g.succ, num_nodes=g.num_nodes, device=CPU)


def _same(a, b):
    for ext in (".graph", ".offsets"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    assert props_lines(a + ".properties") == props_lines(b + ".properties")


def both(g, tmp_path, **kw):
    """Store with the JAX package, the bulk writer and the per-arc loop:
    all three byte-identical; returns the port's basename and the JAX's."""
    j, p, q = (str(tmp_path / x) for x in ("j", "p", "q"))
    JE.EFGraph.store(g, j, **kw)
    EFGraph.store(_port(g), p, **kw)
    EFGraph.store(_port(g), q, backend="python", **kw)
    _same(j, p)
    _same(j, q)
    return p, j


def check_decodes(g, p, j):
    """Host readers and the device decode on the CPU against the graph
    and the JAX package."""
    ef = EFGraph.load(p)
    jef = JE.EFGraph.load(j)
    assert (ef.num_nodes, ef.num_arcs) == (g.num_nodes, g.num_arcs)
    np.testing.assert_array_equal(ef.offsets, jef.offsets)
    for x in range(g.num_nodes):
        np.testing.assert_array_equal(ef.successors(x), g.successors(x))
        assert ef.outdegree(x) == g.outdegree(x)
    seq = EFGraph.load(p, mode="offline")
    assert seq.offsets is None
    pairs = list(zip(seq.iter_nodes(), g.iter_nodes()))
    assert len(pairs) == g.num_nodes
    for (x, a), (y, b) in pairs:
        assert x == y
        np.testing.assert_array_equal(a, b)
    csr = ef.to_device("cpu")
    assert csr.report["route"] == "torch" and csr.num_nodes == g.num_nodes
    np.testing.assert_array_equal(csr.offsets.numpy(), g.offsets)
    np.testing.assert_array_equal(csr.succ.numpy(), g.succ)
    co, su = PD.ef_decode_to_csr(ef.words, ef.offsets, ef.upper_bound,
                                 ef.log2_quantum, device=CPU)
    assert torch.equal(co, csr.offsets) and torch.equal(su, csr.succ)
    if g.num_arcs:
        jco, jsu = j_ef_decode(jef.words, jef.offsets, jef.upper_bound,
                               jef.log2_quantum)
        np.testing.assert_array_equal(co.numpy(), jco)
        np.testing.assert_array_equal(su.numpy(), jsu)
    return csr


@pytest.mark.parametrize("name", ["er_80_1_0", "er_200_02_1", "complete12",
                                  "cycle33", "star19", "empty_lists"])
def test_ef_roundtrip(graphs, tmp_path, name):
    g = graphs[name]
    check_decodes(g, *both(g, tmp_path))


@pytest.mark.parametrize("log2q", [0, 1, 2, 4, 8])
def test_ef_quantum_sweep(graphs, tmp_path, log2q):
    g = graphs["er_150_15_3"]
    check_decodes(g, *both(g, tmp_path, log2_quantum=log2q))


@pytest.mark.parametrize("ub", [1000, 5000, 1 << 30])
def test_ef_upper_bound(graphs, tmp_path, ub):
    g = graphs["er_60_1_5"]
    p, j = both(g, tmp_path, upper_bound=ub)
    assert EFGraph.load(p).upper_bound == ub
    check_decodes(g, p, j)


@pytest.mark.parametrize("log2q", [2, 8])
def test_ef_byte_order(graphs, tmp_path, log2q):
    g = graphs["er_150_3_2"]
    p, j = both(g, tmp_path, byte_order="big", log2_quantum=log2q)
    assert EFGraph.load(p).properties["byteorder"] == "BIG_ENDIAN"
    check_decodes(g, p, j)


@pytest.mark.parametrize("name", sorted(edge_graphs()))
def test_ef_edge_graphs(graphs, tmp_path, name):
    g = graphs[name]
    csr = check_decodes(g, *both(g, tmp_path))
    if g.num_nodes == 0:
        assert csr.offsets.tolist() == [0] and csr.num_arcs == 0


def test_ef_skip_to(graphs, tmp_path):
    """``successors_from`` (the skip pointers) equals the JAX method."""
    g = graphs["er_120_2_7"]
    p, j = both(g, tmp_path, log2_quantum=2)  # tiny quantum: pointers
    ef, jef = EFGraph.load(p), JE.EFGraph.load(j)
    for x in range(0, 120, 7):
        succ = g.successors(x)
        for bound in [0, 1, 30, 60, 90, 119, 120, 500]:
            got = ef.successors_from(x, bound)
            np.testing.assert_array_equal(got, succ[succ >= bound])
            np.testing.assert_array_equal(got, jef.successors_from(x, bound))


def test_ef_load_dispatch(graphs, tmp_path):
    g = graphs["er_60_1_5"]
    p, _j = both(g, tmp_path)
    loaded = core.load(p)
    assert isinstance(loaded, EFGraph) and loaded.equals(g)
    csr = core.load_csr(p, device="cpu")
    assert csr.report["format"] == "EFGraph" and csr.report["load_s"] >= 0
    np.testing.assert_array_equal(csr.succ.numpy(), g.succ)
    assert isinstance(jcore.load(p), JE.EFGraph)


def test_ef_to_device_defaults_to_the_card(graphs, tmp_path, monkeypatch):
    p, _j = both(graphs["cycle33"], tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EFGraph.load(p).to_device()


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_ef_decode_in_chunks(graphs, tmp_path, chunk):
    """The device decode cut into chunks of whole nodes of a few arcs."""
    g = graphs["er_150_3_2"]
    p, _j = both(g, tmp_path, log2_quantum=1)
    ef = EFGraph.load(p)
    plan = PD.EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                           ef.log2_quantum, device=CPU)
    co, su = plan.decode(chunk_arcs=chunk)
    np.testing.assert_array_equal(co.numpy(), g.offsets)
    np.testing.assert_array_equal(su.numpy(), g.succ)


def test_ef_decode_rejects_wide_upper_bound(graphs, tmp_path):
    g = graphs["cycle33"]
    p, _j = both(g, tmp_path, upper_bound=1 << 31)
    with pytest.raises(ValueError):
        EFGraph.load(p).to_device("cpu")


@pytest.mark.parametrize("lists,kw", [
    ([[0, 5], [9]], dict(upper_bound=9)),     # a successor at u
    ([[0, 12], [1]], dict(upper_bound=10)),   # a successor above u
    ([[3, 3]], {}), ([[4, 1]], dict(upper_bound=10))])  # repeated, decreasing
def test_ef_store_refuses_bad_lists(tmp_path, lists, kw):
    """Both packages refuse lists EF cannot hold, with ValueError."""
    g = JCSR.from_lists([np.asarray(x) for x in lists])
    with pytest.raises(ValueError):
        JE.EFGraph.store(g, str(tmp_path / "j"), **kw)
    for backend in ("numpy", "python"):
        with pytest.raises(ValueError):
            EFGraph.store(_port(g), str(tmp_path / "p"), backend=backend,
                          **kw)


# -- golden bit vectors (tests/test_ef_golden.py) ----------------------------


def _store_bytes(lists, tmp_path, log2_quantum=8, upper_bound=-1):
    g = CSRGraph.from_lists([np.asarray(s, dtype=np.int64) for s in lists],
                            device=CPU)
    base = str(tmp_path / "ef")
    EFGraph.store(g, base, log2_quantum=log2_quantum, upper_bound=upper_bound)
    with open(base + ".graph", "rb") as f:
        return f.read()


def test_ef_golden_hand_derived(tmp_path):
    """The 4-node example worked by hand in tests/test_ef_golden.py."""
    lists = [[1, 2], [], [0, 3], [3]]
    assert _store_bytes(lists, tmp_path) == bits_to_le_longwords(
        java_ef_graph_bits(lists, 4, 4, 8))


@pytest.mark.parametrize("log2q", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_ef_golden_sweep(tmp_path, log2q, seed):
    g = erdos_renyi(70, 0.2, seed=seed)
    lists = [g.successors(x).tolist() for x in range(g.num_nodes)]
    assert _store_bytes(lists, tmp_path, log2_quantum=log2q) == \
        bits_to_le_longwords(java_ef_graph_bits(lists, 70, 70, log2q))


def test_ef_golden_upper_bound_and_dense(tmp_path):
    lists = [[0, 1, 2, 3, 4, 5, 6, 7], [9], []]
    assert _store_bytes(lists, tmp_path, log2_quantum=4, upper_bound=10) \
        == bits_to_le_longwords(java_ef_graph_bits(lists, 3, 10, 4))


# -- the bit streams and the closed forms ------------------------------------


def test_ef_params_equal():
    for length in range(0, 40):
        for u in (0, 1, 2, 7, 100, 1000, 12345, 1 << 30):
            assert PE.lower_bits(length, u) == JE.lower_bits(length, u)
            assert PE.pointer_size(length, u) == JE.pointer_size(length, u)
            for q in (0, 2, 8):
                assert (PE.number_of_pointers(length, u, q)
                        == JE.number_of_pointers(length, u, q))


def test_longword_streams_equal():
    rng = np.random.default_rng(0)
    pw, jw = LongWordWriter(), JLongWordWriter()
    ops = []
    for _ in range(2000):
        kind = int(rng.integers(3))
        v = int(rng.integers(0, 1 << 40)) if kind else int(
            rng.integers(0, 300))
        for w in (pw, jw):
            (w.write_unary, w.write_gamma, lambda v: w.append(
                v, max(v.bit_length(), 1)))[kind](v)
        ops.append((kind, v))
    words = pw.to_words()
    np.testing.assert_array_equal(words, jw.to_words())
    assert pw.to_bytes("big") == jw.to_bytes("big")
    r = LongWordReader(words)
    r.position(0)
    for kind, v in ops:
        got = (r.read_unary, r.read_gamma,
               lambda: r.extract(max(v.bit_length(), 1)))[kind]()
        assert got == v


def test_delta_codes_equal_bitwriter():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.arange(70), rng.integers(0, 1 << 45, 3000)])
    w = JBitWriter()
    for v in x.tolist():
        w.write_delta(v)
    got, bits = PE.pack_msb_codes(*PE.delta_codes(x))
    assert bits == w.written_bits and got == w.to_bytes()


# -- the offsets cache's Elias-Fano list (tests/test_ef_index.py) -----------


@pytest.mark.parametrize("n,u", [(1, 10), (100, 1000), (10_000, 10**7),
                                 (50_000, 3 * 10**9), (7, 7),
                                 (10_000, 10**12)])
def test_ef_list_equal(n, u, tmp_path):
    rng = np.random.default_rng(42)
    vals = np.sort(rng.integers(0, u, n)).astype(np.int64)
    ef, jef = PI.build_ef(vals), JI.build_ef(vals)
    assert (ef.n, ef.u, ef.ell) == (jef.n, jef.u, jef.ell)
    for f in ("lower", "upper", "rank"):
        np.testing.assert_array_equal(getattr(ef, f), getattr(jef, f))
    np.testing.assert_array_equal(ef.to_array(), vals)
    idx = rng.integers(0, n, 333)
    np.testing.assert_array_equal(ef.get_batch(idx), vals[idx])
    assert ef[n // 2] == vals[n // 2]
    np.testing.assert_array_equal(ef[10:20], vals[10:20])
    # the .obl bytes are the JAX package's, and each loads the other's
    ef.dump(str(tmp_path / "p.obl"))
    jef.dump(str(tmp_path / "j.obl"))
    assert (tmp_path / "p.obl").read_bytes() == (tmp_path / "j.obl"
                                                 ).read_bytes()
    np.testing.assert_array_equal(
        PI.EliasFanoMonotoneList.load(str(tmp_path / "j.obl")).to_array(),
        vals)
    np.testing.assert_array_equal(
        JI.EliasFanoMonotoneList.load(str(tmp_path / "p.obl")).to_array(),
        vals)
    # the torch select
    lo, up, rk = ef.device_arrays(CPU)
    np.testing.assert_array_equal(
        PI.device_select(lo, up, rk, ef.ell, idx).numpy(), vals[idx])
    if ef.ell <= 32:
        jl, ju, jr = jef.device_arrays()
        hi, low = JI.device_select(jl, ju, jr, jef.ell, idx.astype(np.int32))
        np.testing.assert_array_equal(
            (np.asarray(hi).astype(np.int64) << jef.ell)
            | np.asarray(low).astype(np.int64), vals[idx])


def test_obl_junk_raises(tmp_path):
    p = str(tmp_path / "x.obl")
    PI.build_ef(np.arange(50, dtype=np.int64) * 3).dump(p)
    with open(p, "r+b") as f:
        f.write(b"JUNKJUNK")
    with pytest.raises(IOError):
        PI.EliasFanoMonotoneList.load(p)
    with open(p, "wb") as f:
        f.write(b"WGOBL1\x00\x00" + b"\x01" * 20)
    with pytest.raises(IOError):
        PI.EliasFanoMonotoneList.load(p)


def test_word_select_helpers():
    """popcount64 / select_in_word / low_rank on words of every sign."""
    rng = np.random.default_rng(1)
    w = rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)
    w[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    t = torch.from_numpy(w)
    pc = np.unpackbits(w.view(np.uint8).reshape(-1, 8), axis=1).sum(1)
    np.testing.assert_array_equal(PI.popcount64(t).numpy(), pc)
    nz = pc > 0
    k = (rng.random(len(w)) * pc).astype(np.int64)[nz]
    np.testing.assert_array_equal(
        PI.select_in_word(t[nz], torch.from_numpy(k)).numpy(),
        JI._select_in_word(w[nz].view(np.uint64), k))
    sh = rng.integers(0, 64, len(w))
    want = [bin(int(x) & ((1 << int(s)) - 1)).count("1")
            for x, s in zip(w.view(np.uint64), sh)]
    np.testing.assert_array_equal(
        PI.low_rank(t, torch.from_numpy(sh)).numpy(), want)
