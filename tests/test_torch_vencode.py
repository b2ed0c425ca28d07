"""The port's device encoder against the JAX package's.

``webgraph_tpu_torch/ops/vencode.py`` runs its torch ops on the CPU here;
the JAX ``vencode`` runs under XLA on the CPU.  The cases of
``tests/test_vencode.py``, through both packages:

- ``BVGraph.store(..., backend="cuda", device="cpu")`` writes ``.graph``
  and ``.offsets`` byte-identical to the JAX ``backend="tpu"`` store and
  to the port's ``"python"`` oracle, and ``.properties`` equal bar the date
  line;
- module by module (masks, cost matrix, pack, gaps), the port's arrays
  equal the JAX function's;
- chunked encodes equal one-chunk encodes, whatever the chunk size.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import native as JN
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.ops import vencode as JV
from webgraph_tpu_torch import native as PN
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops import vencode as V
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph
from .torch_file_cases import props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _port(g) -> CSRGraph:
    return CSRGraph(np.asarray(g.offsets), np.asarray(g.succ),
                    num_nodes=g.num_nodes, device=CPU)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _three_stores(g, tmp_path, settings):
    """Store ``g`` with the JAX ``"tpu"`` backend, the port's ``"cuda"``
    on the CPU and the port's ``"python"``; all three must agree."""
    j, c, p = (str(tmp_path / k) for k in ("jax_tpu", "cuda", "python"))
    JBV.store(g, j, settings=JSettings(**vars(settings)), backend="tpu")
    BVGraph.store(_port(g), c, settings=settings, backend="cuda",
                  device="cpu")
    BVGraph.store(_port(g), p, settings=settings, backend="python")
    for ext in (".graph", ".offsets"):
        assert _read(c + ext) == _read(j + ext), ext
        assert _read(c + ext) == _read(p + ext), ext
    assert props_lines(c + ".properties") == props_lines(j + ".properties")
    assert props_lines(c + ".properties") == props_lines(p + ".properties")
    return c


@pytest.mark.parametrize("window,minint", [(0, 0), (0, 4), (2, 2), (7, 4)])
def test_byte_identity_vs_python(tmp_path, window, minint):
    s = BVGraphSettings(window_size=window, max_ref_count=3,
                        min_interval_length=minint)
    _three_stores(erdos_renyi(200, 0.04, seed=7), tmp_path, s)


@pytest.mark.parametrize("coding", ["DELTA", "GAMMA", "ZETA"])
def test_byte_identity_residual_codings(tmp_path, coding):
    s = BVGraphSettings(residual_coding=getattr(C, coding), window_size=3,
                        min_interval_length=2)
    _three_stores(erdos_renyi(120, 0.06, seed=11), tmp_path, s)


@pytest.mark.parametrize("name", ["complete", "star", "cycle", "er"])
def test_edge_case_graphs(tmp_path, name):
    g = {"complete": lambda: complete_graph(12),
         "star": lambda: star_graph(64),
         "cycle": lambda: cycle_graph(100),
         "er": lambda: erdos_renyi(400, 0.03, seed=1)}[name]()
    _three_stores(g, tmp_path, BVGraphSettings())


@pytest.mark.parametrize("attrs", [
    dict(outdegree_coding=C.DELTA, reference_coding=C.GAMMA,
         block_count_coding=C.DELTA, block_coding=C.UNARY),
    dict(reference_coding=C.DELTA, block_coding=C.DELTA, zeta_k=5,
         offset_coding=C.DELTA, max_ref_count=1)])
def test_component_codings(tmp_path, attrs):
    _three_stores(erdos_renyi(150, 0.08, seed=2), tmp_path,
                  BVGraphSettings(**attrs))


@pytest.mark.parametrize("name", ["n0", "no_arcs"])
def test_empty_graphs(tmp_path, name):
    from webgraph_tpu.core.graph import CSRGraph as JCSR
    e = np.zeros(0, np.int64)
    g = JCSR.from_lists([] if name == "n0" else [e] * 5)
    _three_stores(g, tmp_path, BVGraphSettings())


def _simple_synth(n, seed):
    return E.simple(*synthesize_webgraph(n, seed=seed))


def test_synthetic_web_graph_equals_the_single_stream_native(tmp_path):
    """The store of a synthetic web graph (copies, intervals, long
    residual gaps) equals ``native.bv_encode(..., threads=1)``, the
    single-stream oracle, in both libraries, stats words included."""
    co, su = _simple_synth(4000, seed=3)
    s = BVGraphSettings()
    base = str(tmp_path / "c")
    BVGraph.store(CSRGraph(co, su, device=CPU), base, backend="cuda",
                  device="cpu")
    for lib in (PN, JN):
        graph, gbits, offs, _ob, st = lib.bv_encode(co, su, s, threads=1)
        assert _read(base + ".graph") == graph.tobytes()
        assert _read(base + ".offsets") == offs.tobytes()
    gb, bits, _starts, stats = V.encode_csr_chunked(co, su, s, device="cpu")
    assert bits == gbits and gb == graph.tobytes()
    np.testing.assert_array_equal(stats, st)


@pytest.mark.parametrize("chunk_arcs", [20, 400, 3000, 1 << 30])
def test_chunked_identical_to_single(chunk_arcs):
    """Chunked encodes (halo-carried windows + bit concatenation) equal the
    one-piece encode, and the JAX package's, at any chunk size."""
    g = erdos_renyi(500, 0.03, seed=3)
    co, su = np.asarray(g.offsets), np.asarray(g.succ)
    s = BVGraphSettings(window_size=7, max_ref_count=3, min_interval_length=3)
    one, bits1, starts1, refs1, rcs1, st1 = V.encode_csr(co, su, s,
                                                         device="cpu")
    many, bits2, starts2, st2 = V.encode_csr_chunked(co, su, s,
                                                     chunk_arcs=chunk_arcs,
                                                     device="cpu")
    assert (bits1, one) == (bits2, many)
    assert torch.equal(starts1, starts2)
    np.testing.assert_array_equal(st1, st2)
    if chunk_arcs == 400:
        jone, jbits, jstarts, jrefs, jrcs, jst = JV.encode_csr(
            co, su, JSettings(**vars(s)))
        assert (jbits, jone) == (bits1, one)
        np.testing.assert_array_equal(starts1.numpy(), jstarts)
        np.testing.assert_array_equal(refs1, jrefs)
        np.testing.assert_array_equal(rcs1, jrcs)
        np.testing.assert_array_equal(st1, jst)


def test_bitcat_random_streams():
    rng = np.random.default_rng(0)
    cat, jcat = V.BitCat(), JV.BitCat()
    want = []
    for _ in range(50):
        nbits = int(rng.integers(1, 70))
        bits = rng.integers(0, 2, nbits)
        want.extend(bits.tolist())
        nb = -(-nbits // 8)
        by = np.zeros(nb, np.uint8)
        for i, v in enumerate(bits):
            by[i >> 3] |= v << (7 - (i & 7))
        # stale low bits past the chunk's end must not leak
        by[-1] |= (1 << ((-nbits) % 8)) - 1
        cat.push(by.tobytes(), nbits)
        jcat.push(by.tobytes(), nbits)
    got = np.unpackbits(np.frombuffer(cat.to_bytes(), np.uint8))
    np.testing.assert_array_equal(got[:len(want)], np.asarray(want))
    assert not got[len(want):].any()
    assert cat.to_bytes() == jcat.to_bytes() and cat.bits == jcat.bits


def test_encode_device_plan():
    """EncodeDevicePlan: byte-identical to the single-stream native encode,
    equal on a second call, and the struck device scan raises."""
    g = erdos_renyi(400, 0.04, seed=5)
    co, su = np.asarray(g.offsets), np.asarray(g.succ)
    s = BVGraphSettings()
    plan = V.EncodeDevicePlan(co, su, s, device="cpu")
    gbytes, gbits, starts, refs, rcs, stats = plan.encode()
    ng, nbits, _o, _ob, nst = PN.bv_encode(co, su, s, threads=1)
    assert gbits == nbits and gbytes == ng.tobytes()
    np.testing.assert_array_equal(stats, nst)
    jplan = JV.EncodeDevicePlan(co, su, JSettings())
    jb, jbits, jstarts, jrefs, jrcs, jst = jplan.encode()
    assert (jb, jbits) == (gbytes, gbits)
    np.testing.assert_array_equal(refs, jrefs)
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    assert plan.encode()[0] == gbytes
    with pytest.raises(ValueError, match="A12"):
        plan.encode(selection="scan")


# -- module by module ----------------------------------------------------------


def _slice(n=300, seed=4):
    co, su = _simple_synth(n, seed)
    seg = np.repeat(np.arange(n, dtype=np.int32), np.diff(co))
    return co, su, seg


@pytest.mark.parametrize("W", [0, 1, 3, 7])
def test_member_masks_equal(W):
    co, su, seg = _slice()
    down, up = V.member_masks(seg, su, W, device="cpu")
    jd, ju = JV.member_masks(seg, su, W)
    np.testing.assert_array_equal(down.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(up.numpy(), np.asarray(ju))
    if W:
        assert (down.numpy() != 0).any() and (up.numpy() != 0).any()


@pytest.mark.parametrize("sname", ["default", "w0_noint", "gamma_w3_int2"])
@pytest.mark.parametrize("node_base", [0, 37])
def test_cost_matrix_equal(sname, node_base):
    s = {"default": BVGraphSettings(),
         "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
         "gamma_w3_int2": BVGraphSettings(residual_coding=C.GAMMA,
                                          window_size=3,
                                          min_interval_length=2)}[sname]
    co, su, _ = _slice(seed=6)
    got = V.cost_matrix(co, su, s, node_base=node_base, device="cpu")
    exp = JV.cost_matrix(co, su, JSettings(**vars(s)), node_base=node_base)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("emit_from", [0, 7])
def test_pack_chunk_equal(emit_from):
    """Words, node starts and stats of a pack with a halo (emit_from > 0,
    node_base > 0) equal the JAX pack_chunk's."""
    co, su, _ = _slice(seed=8)
    s = BVGraphSettings()
    js = JSettings()
    costs = JV.cost_matrix(co, su, js, node_base=50)
    refs, _ = JV.select_refs(costs, np.diff(co), js)
    words, total, starts, stats = V.pack_chunk(co, su, s, refs, node_base=50,
                                               emit_from=emit_from,
                                               device="cpu")
    jw, jtotal, jstarts, jstats = JV.pack_chunk(co, su, js, refs,
                                                node_base=50,
                                                emit_from=emit_from)
    assert total == jtotal
    nw = words.numel()
    assert (words >= 0).all() and (words < 1 << 32).all()
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw)[:nw]
                                  .astype(np.int64))
    assert not np.asarray(jw)[nw:].any()
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    np.testing.assert_array_equal(stats.numpy(), jstats)
    if emit_from:
        assert (starts[:emit_from] == -1).all()


def test_select_refs_equal():
    co, su, _ = _slice(seed=9)
    s = BVGraphSettings(max_ref_count=2)
    costs = V.cost_matrix(co, su, s, device="cpu")
    bounds = np.asarray([0, 100, 101, 300])
    for cb in (None, bounds):
        got = V.select_refs(costs, np.diff(co), s, chunk_bounds=cb)
        exp = JV.select_refs(costs.numpy(), np.diff(co), JSettings(**vars(s)),
                             chunk_bounds=cb)
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("coding", [C.GAMMA, C.DELTA])
def test_pack_gaps_equal(coding):
    rng = np.random.default_rng(coding)
    vals = np.concatenate([[0], rng.integers(0, 1 << 20, 500),
                           [(1 << 33) - 1, 1 << 33, 7]])
    got = V.pack_gaps(vals, coding, device="cpu")
    assert got == JV.pack_gaps(vals, coding)


def test_msb64_edges():
    """floor(log2) at 2**k - 1, 2**k and 2**k + 1, up to 2**52."""
    k = np.arange(1, 53)
    z = np.concatenate([(1 << k) - 1, 1 << k, (1 << k) + 1])
    got = V.msb64(torch.from_numpy(z)).numpy()
    want = np.asarray([int(x).bit_length() - 1 for x in z])
    np.testing.assert_array_equal(got, want)
    assert int(V.msb64(torch.tensor([1]))) == 0


@pytest.mark.parametrize("kind", [C.GAMMA, C.DELTA, C.ZETA])
def test_codes_refuse_values_past_int64(kind):
    V._code(kind, torch.tensor([0, 1 << 40]))
    with pytest.raises(OverflowError):
        V._code(kind, torch.tensor([1 << 53]))


@pytest.mark.parametrize("attrs", [dict(residual_coding=C.GOLOMB),
                                   dict(residual_coding=C.NIBBLE),
                                   dict(outdegree_coding=C.UNARY),
                                   dict(offset_coding=C.ZETA),
                                   dict(window_size=8)])
def test_unsupported_settings_raise(tmp_path, attrs):
    s = BVGraphSettings(**attrs)
    assert not V.supported(s) and not JV.supported(JSettings(**vars(s)))
    g = _port(erdos_renyi(30, 0.1, seed=1))
    with pytest.raises(ValueError, match="cuda backend"):
        BVGraph.store(g, str(tmp_path / "x"), settings=s, backend="cuda",
                      device="cpu")
    with pytest.raises(ValueError):
        V.EncodeDevicePlan(np.zeros(1, np.int64), np.zeros(0, np.int64), s,
                           device="cpu")


def test_cuda_backend_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """With no device named, the cuda backend asks for the card and raises
    without one; nothing falls back to the host encoder."""
    from webgraph_tpu_torch.codecs import bvgraph as PB

    def no_card():
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(PB, "require_cuda", no_card)
    monkeypatch.setattr(PN, "bv_encode", None)
    g = _port(erdos_renyi(30, 0.1, seed=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BVGraph.store(g, str(tmp_path / "x"), backend="cuda")


def test_store_report_and_host_graphs(tmp_path):
    """The report names every stage; a host graph with ``iter_nodes`` goes
    through the same encoder."""
    from webgraph_tpu_torch.transform.offline import transpose_offline
    co, su = _simple_synth(2000, seed=1)
    g = CSRGraph(co, su, device=CPU)
    rep = {}
    BVGraph.store(g, str(tmp_path / "a"), backend="cuda", device="cpu",
                  report=rep)
    for k in ("setup_s", "arcs_masks_s", "cost_matrix_s", "cost_copy_s",
              "select_refs_s", "pack_s", "concat_s", "offsets_s", "write_s"):
        assert rep[k] >= 0, k
    assert rep["chunks"] == 1 and rep["chunk_arcs"] == V.DEFAULT_CHUNK_ARCS
    bt = transpose_offline(g, batch_size=5000, temp_dir=str(tmp_path))
    BVGraph.store(bt, str(tmp_path / "b"), backend="cuda", device="cpu")
    BVGraph.store(g.transpose(), str(tmp_path / "c"), backend="python")
    bt.cleanup()
    for ext in (".graph", ".offsets"):
        assert _read(str(tmp_path / "b") + ext) == \
            _read(str(tmp_path / "c") + ext)
