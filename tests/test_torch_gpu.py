"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (and no jax), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernels are built from ``webgraph_tpu_torch/csrc`` on first use, the
port's host library from ``webgraph_tpu_torch/native``.  Every value is an
integer: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu_torch import native
from webgraph_tpu_torch.algo import hyperball as PHB
from webgraph_tpu_torch.ops import _build
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kcompact as PKC
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.bitstream import stream_words
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E
from .torch_compact_layouts import LAYOUTS as COMPACT_LAYOUTS
from .torch_compact_layouts import build_layout

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

SETTINGS = [BVGraphSettings(),
            BVGraphSettings(window_size=0, min_interval_length=0),
            BVGraphSettings(outdegree_coding=C.DELTA, window_size=4,
                            min_interval_length=2),
            BVGraphSettings(residual_coding=C.GAMMA, max_ref_count=1)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    native.lib_path()
    return torch.device("cuda", 0)


def _graph(n, settings, seed=2):
    co, su = synthesize_webgraph(n, seed=seed)
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, settings,
                                                  threads=4)
    offsets = native.decode_offset_stream(offs, n, settings.offset_coding)
    return co, su, graph, offsets


@pytest.mark.parametrize("si", range(len(SETTINGS)))
def test_decode_kernel_matches_plain(cuda, si):
    s = SETTINGS[si]
    co, su, graph, offsets = _graph(30_000, s)
    plan = PP.plan_kernel_decode(offsets, np.diff(co), s, graph,
                                 device=cuda, halo_csr=(co, su))
    store_p = plan.store.clone()
    before = _build.LAUNCHES["bv_decode_lanes"]
    diag = PK.decode_chunked(plan)
    assert _build.LAUNCHES["bv_decode_lanes"] == before + 1
    diag_p = PK.decode_lanes_plain(plan.words, plan.meta, store_p, plan.spec)
    torch.cuda.synchronize()
    assert torch.equal(diag, diag_p)
    assert torch.equal(plan.store, store_p)
    assert not PK.check_diag(plan, diag).any()
    _, succ, filled = PC.decode_to_csr(plan)
    assert filled == 0
    np.testing.assert_array_equal(succ.cpu().numpy(), su)


def test_decode_kernel_garbled_stream(cuda):
    s = BVGraphSettings()
    co, su, graph, offsets = _graph(20_000, s)
    graph = graph.copy()
    graph[len(graph) // 2:] = 0xFF
    plan = PP.plan_kernel_decode(offsets, np.diff(co), s, graph,
                                 device=cuda, halo_csr=(co, su))
    store_p = plan.store.clone()
    diag = PK.decode_chunked(plan)
    diag_p = PK.decode_lanes_plain(plan.words, plan.meta, store_p, plan.spec)
    assert torch.equal(diag, diag_p)
    assert torch.equal(plan.store, store_p)
    errs = PK.check_diag(plan, diag)
    assert errs.any()
    # the intact first half of the stream decodes clean
    assert not errs[plan.chunk_starts[1:] < 1000].any()


def _kernel_vs_plain(plan):
    store_p = plan.store.clone()
    diag = PK.decode_chunked(plan)
    diag_p = PK.decode_lanes_plain(plan.words, plan.meta, store_p, plan.spec)
    torch.cuda.synchronize()
    assert torch.equal(diag, diag_p)
    assert torch.equal(plan.store, store_p)
    return diag


@pytest.mark.parametrize("name", sorted(E.CASES))
def test_decode_kernel_edge_cases(cuda, name):
    """The inputs of test_torch_kdecode_host.py's edge cases: codes across
    the reader's refill point, ~240 copy blocks and 40 intervals in a node,
    a 6,000-arc node alone in its lane, a slice off the window's cycle."""
    co, su, s, kw, graph, offsets, outd = E.build(name)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=cuda, **kw)
    diag = _kernel_vs_plain(plan)
    assert not PK.check_diag(plan, diag).any()
    E.check_store(plan, plan.store.cpu(), co, su)


@pytest.mark.parametrize("garble", E.GARBLES)
def test_decode_kernel_garbled_variants(cuda, garble):
    """Planned on the clean stream, decoded from a damaged one, as in
    test_torch_kdecode_host.py: kernel and twin agree on every lane."""
    s = BVGraphSettings()
    n = 2500
    co, su = E.simple(*synthesize_webgraph(n, seed=7))
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=2)
    offsets = native.decode_offset_stream(offs, n, s.offset_coding)
    plan = PP.plan_kernel_decode(offsets, np.diff(co), s, graph, device=cuda,
                                 halo_csr=(co, su), target_arcs_per_lane=24)
    plan.words = stream_words(E.garble(graph, garble), cuda)
    diag = _kernel_vs_plain(plan)
    assert PK.check_diag(plan, diag).any() == (garble != "clean")


def test_decode_rejects_cpu_cuda_mix(cuda):
    spec = PK.KernelSpec.from_settings(BVGraphSettings())
    meta = torch.zeros((2, PK.nmeta(7)), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        PK.decode_lanes(torch.zeros(20, dtype=torch.int32), meta,
                        torch.zeros(4, dtype=torch.int32, device=cuda), spec)


@pytest.mark.parametrize("invalid", [0.0, 0.4])
def test_compact_kernel_matches_plain(cuda, invalid):
    rng = np.random.default_rng(11)
    R = 5000
    arcs = rng.integers(0, 3000, size=R)
    arcs[rng.random(R) < 0.2] = 0
    gap = rng.integers(0, 50, size=R)
    arc_start = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(arcs, out=arc_start[1:])
    seg = arcs + gap
    src0 = np.cumsum(seg) - arcs
    valid = rng.random(R) >= invalid
    store = torch.randint(0, 1 << 30, (int(seg.sum()),), dtype=torch.int32,
                          device=cuda)
    cp = PKC.plan_compact(arc_start, src0, valid, int(arc_start[-1]),
                          device=cuda)
    got = PKC.compact(cp, store)
    exp = PKC.compact_plain(cp, store)
    vmask = torch.from_numpy(np.repeat(valid, arcs)).to(cuda)
    assert torch.equal(got[vmask], exp[vmask])


@pytest.mark.parametrize("layout", sorted(COMPACT_LAYOUTS))
def test_compact_kernel_edge_layouts(cuda, layout):
    """The layouts of test_torch_kcompact_host.py on the card: every
    alignment pair, short and empty runs, a run over several tiles, more
    runs in a tile than the kernel's slice holds, invalid runs, a run
    ending at the store's last word.  Valid positions only: the others
    are unspecified."""
    cp, store, vmask, *_ = build_layout(layout, device=cuda)
    before = _build.LAUNCHES["compact_runs"]
    got = PKC.compact(cp, store)
    assert _build.LAUNCHES["compact_runs"] == before + 1
    exp = PKC.compact_plain(cp, store)
    torch.cuda.synchronize()
    assert torch.equal(got[vmask], exp[vmask])


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_compact_kernel_store_view_off_16_bytes(cuda, shift):
    """A store that is a view starting off a 16-byte boundary: the kernel
    reads it word by word, so any start is taken."""
    cp, store, vmask, *_ = build_layout("alignments", device=cuda)
    padded = torch.empty(store.numel() + shift, dtype=torch.int32,
                         device=cuda)
    view = padded[shift:]
    view.copy_(store)
    assert view.data_ptr() % 16 == 4 * shift
    got = PKC.compact(cp, view)
    exp = PKC.compact_plain(cp, store)
    torch.cuda.synchronize()
    assert torch.equal(got[vmask], exp[vmask])


def test_cold_slice_on_card(cuda):
    s = BVGraphSettings()
    n = 60_000
    co, su, graph, offsets = _graph(n, s, seed=4)
    outd = native.decode_outdegrees(graph, offsets, s.outdegree_coding)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device=cuda)
    assert plan.cold
    assert resolve_halos(plan) >= 1
    pco, succ, filled = PC.decode_to_csr(plan)
    assert filled == 0
    np.testing.assert_array_equal(pco, co)
    np.testing.assert_array_equal(succ.cpu().numpy(), su)
    regs = torch.from_numpy(PHB.hyperloglog_init(n, 4, seed=3))
    got = PHB.device_round(pco, succ, regs.to(cuda)).cpu()
    exp = PHB.device_round(pco, succ.cpu(), regs)
    assert torch.equal(got, exp)


# -- the analytics on the card against the port on the CPU ------------------


def _analytics_graphs(cuda):
    """One small synthetic web graph (distinct successors below n,
    ascending) on the CPU and on the card."""
    from webgraph_tpu_torch.core.graph import CSRGraph
    n = 3000
    co, su = synthesize_webgraph(n, seed=5)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(co))
    key = np.unique((rows * n + su)[su < n])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=co[1:])
    return (CSRGraph(co, key % n, device="cpu"),
            CSRGraph(co, key % n, device=cuda))


def _same(a, b):
    """Exact for integers and booleans, rtol 1e-12 for floats."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       rtol=1e-12, atol=0)
        else:
            assert torch.equal(b.cpu(), a)
    elif isinstance(a, float):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    else:
        assert a == b


def _graph_pair(g):
    return g.offsets, g.succ


ANALYTICS = {
    "transpose": lambda A, T, g: _graph_pair(T.transpose(g)),
    "symmetrize": lambda A, T, g: _graph_pair(T.symmetrize(g)),
    "simplify": lambda A, T, g: _graph_pair(T.simplify(g)),
    "union": lambda A, T, g: _graph_pair(T.union(g, T.transpose(g))),
    "bfs": lambda A, T, g: A.bfs(g, [0, 7]),
    "visit": lambda A, T, g: A.visit(g, 11),
    "cc": lambda A, T, g: A.sort_by_size(A.connected_components(
        T.symmetrize(g))),
    "scc": lambda A, T, g: (lambda kc: (kc, A.scc_buckets(g, kc[1])))(
        A.strongly_connected_components(g)),
    "harmonic": lambda A, T, g: A.harmonic_centrality(g, batch=128),
    "closeness": lambda A, T, g: A.closeness_centrality(
        g, sources=torch.arange(0, 3000, 7, device=g.device), batch=64),
}


@pytest.mark.parametrize("name", sorted(ANALYTICS))
def test_analytics_on_card_match_cpu(cuda, name):
    from webgraph_tpu_torch import algo as A
    from webgraph_tpu_torch import transform as T
    gc, gg = _analytics_graphs(cuda)
    _same(ANALYTICS[name](A, T, gc), ANALYTICS[name](A, T, gg))


def test_packed_centrality_on_card_matches_cpu(cuda, monkeypatch):
    from webgraph_tpu_torch import algo as A
    from webgraph_tpu_torch.algo import centrality as CE
    monkeypatch.setattr(CE, "DENSE_LIMIT", 1)
    monkeypatch.setattr(CE, "PACKED_CHUNK", 997)
    gc, gg = _analytics_graphs(cuda)
    src = np.arange(0, 3000, 13)
    _same(A.harmonic_centrality(gc, sources=src, batch=96),
          A.harmonic_centrality(gg, sources=src, batch=96))


def test_stats_on_card_match_cpu(cuda):
    from webgraph_tpu_torch import algo as A
    from webgraph_tpu_torch.utils.stats import compute_stats
    gc, gg = _analytics_graphs(cuda)
    sc = compute_stats(gc, A.strongly_connected_components(gc)[1])
    sg = compute_stats(gg, A.strongly_connected_components(gg)[1])
    assert list(sc) == list(sg)
    for k in sc:
        _same(sc[k], sg[k])


@pytest.mark.parametrize("mode", ["dense", "sparse", "external"])
def test_hyperball_on_card_matches_cpu(cuda, mode, tmp_path):
    from webgraph_tpu_torch import algo as A
    from webgraph_tpu_torch import transform as T
    gc, gg = _analytics_graphs(cuda)
    runs = []
    for g in (gc, gg):
        kw = dict(log2m=6, seed=3, do_sum_of_distances=True,
                  do_sum_of_inverse_distances=True)
        if mode != "dense":
            kw["gt"] = T.transpose(g)
        if mode == "external":
            kw.update(external_chunk=5000,
                      regs_path=str(tmp_path / f"{g.device.type}.npy"))
        hb = A.HyperBall(g, **kw)
        hb.run()
        runs.append(hb)
    c, k = runs
    if mode == "external":
        np.testing.assert_array_equal(np.asarray(k.regs), np.asarray(c.regs))
    else:
        assert k.regs.is_cuda and torch.equal(k.regs.cpu(), c.regs)
    assert (k.mode_history, k.arcs_touched, k.modified, k.iteration) == (
        c.mode_history, c.arcs_touched, c.modified, c.iteration)
    _same(c.neighbourhood_function, k.neighbourhood_function)
    _same([c.sum_of_distances, c.sum_of_inverse_distances,
           c.reachable_counts()],
          [k.sum_of_distances, k.sum_of_inverse_distances,
           k.reachable_counts()])
    if mode == "sparse":
        assert "systolic" in k.mode_history or "local" in k.mode_history


# -- the file entries on the card against the same entries on the CPU -------


def _file_graph(tmp_path, settings=None):
    """A small synthetic web graph written as a BVGraph and an EFGraph
    basename by the port; returns (co, su, BVGraph base, EFGraph base)."""
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.codecs.efgraph import EFGraph
    from webgraph_tpu_torch.core.graph import CSRGraph
    co, su = E.simple(*synthesize_webgraph(4000, seed=9))
    g = CSRGraph(co, su, device="cpu")
    bv, ef = str(tmp_path / "bv"), str(tmp_path / "ef")
    BVGraph.store(g, bv, settings=settings)
    EFGraph.store(g, ef, log2_quantum=4)
    return co, su, bv, ef


@pytest.mark.parametrize("residuals", [C.ZETA, C.GOLOMB])
def test_load_csr_on_card_matches_cpu(cuda, tmp_path, residuals):
    """``load_csr`` with no device runs on the card: the kernel route
    launches B1 and B2 (Golomb codes take the host route) and the CSR
    equals the CPU entry's."""
    from webgraph_tpu_torch.core.graph import load_csr
    co, su, bv, _ef = _file_graph(
        tmp_path, BVGraphSettings(residual_coding=residuals))
    _build.reset_launches()
    g = load_csr(bv)
    torch.cuda.synchronize()
    route = "kernel" if residuals == C.ZETA else "host"
    assert g.device.type == "cuda" and g.report["route"] == route
    launched = [_build.LAUNCHES[k] for k in ("bv_decode_lanes",
                                             "compact_runs")]
    assert all(v > 0 for v in launched) == (route == "kernel")
    c = load_csr(bv, device="cpu")
    assert c.report["route"] == route
    assert torch.equal(g.offsets.cpu(), c.offsets)
    assert torch.equal(g.succ.cpu(), c.succ)
    np.testing.assert_array_equal(c.succ.numpy(), su)


@pytest.mark.parametrize("chunk", [None, 1000])
def test_ef_to_device_on_card_matches_cpu(cuda, tmp_path, chunk):
    from webgraph_tpu_torch.codecs.efgraph import EFGraph
    from webgraph_tpu_torch.ops.efdecode import EFDevicePlan
    co, su, _bv, ef = _file_graph(tmp_path)
    efg = EFGraph.load(ef)
    if chunk is None:
        g = efg.to_device()
        offs, succ = g.offsets, g.succ
    else:
        offs, succ = EFDevicePlan(efg.words, efg.offsets, efg.upper_bound,
                                  efg.log2_quantum, device=cuda).decode(
                                      chunk_arcs=chunk)
    torch.cuda.synchronize()
    assert succ.is_cuda
    c = efg.to_device("cpu")
    assert torch.equal(offs.cpu(), c.offsets)
    assert torch.equal(succ.cpu(), c.succ)
    np.testing.assert_array_equal(c.succ.numpy(), su)


# -- the device encoder and the transforms on the card against the CPU ------


ENCODE_SETTINGS = {
    "default": BVGraphSettings(),
    "w3_int2_gamma": BVGraphSettings(residual_coding=C.GAMMA, window_size=3,
                                     min_interval_length=2),
    "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
}


@pytest.mark.parametrize("sname", sorted(ENCODE_SETTINGS))
def test_device_encode_on_card_matches_cpu(cuda, tmp_path, sname):
    """``BVGraph.store(backend="cuda")`` with no device encodes on the card,
    byte-equal to the same call on the CPU and to the single-stream native
    encoder; a chunked encode on the card gives the same bytes."""
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.core.graph import CSRGraph
    from webgraph_tpu_torch.ops import vencode
    s = ENCODE_SETTINGS[sname]
    co, su = E.simple(*synthesize_webgraph(6000, seed=11))
    gg = CSRGraph(co, su, device=cuda)
    card, cpu = str(tmp_path / "card"), str(tmp_path / "cpu")
    rep = {}
    BVGraph.store(gg, card, settings=s, backend="cuda", report=rep)
    BVGraph.store(CSRGraph(co, su, device="cpu"), cpu, settings=s,
                  backend="cuda", device="cpu")
    graph, gbits, offs, _ob, _st = native.bv_encode(co, su, s, threads=1)
    for ext, want in ((".graph", graph), (".offsets", offs)):
        with open(card + ext, "rb") as f, open(cpu + ext, "rb") as h:
            data = f.read()
            assert data == h.read() and data == want.tobytes(), ext
    assert rep["pack_s"] > 0 and rep["chunks"] == 1
    gb, bits, starts, _ = vencode.encode_csr_chunked(
        gg.offsets, gg.succ, s, chunk_arcs=5000)
    assert starts.device == gg.device
    assert bits == gbits and gb == graph.tobytes()


def _transform_graphs(cuda):
    from webgraph_tpu_torch.core.graph import CSRGraph
    co, su = E.simple(*synthesize_webgraph(4000, seed=12))
    return (CSRGraph(co, su, device="cpu"), CSRGraph(co, su, device=cuda))


def _batch_lists(bg):
    out = [succ for _x, succ in bg.iter_nodes()]
    bg.cleanup()
    return out


TRANSFORMS = {
    "lexicographical": lambda T, g: T.lexicographical_permutation(g),
    "gray": lambda T, g: T.gray_code_permutation(g),
    "random": lambda T, g: T.random_permutation(g, seed=4),
    "apply": lambda T, g: _graph_pair(T.apply_permutation(
        g, T.gray_code_permutation(g))),
    "map": lambda T, g: _graph_pair(T.map_offline(
        g, torch.arange(g.num_nodes, device=g.device) // 3)),
    "compose": lambda T, g: _graph_pair(T.compose(g, T.transpose(g))),
    "filter": lambda T, g: _graph_pair(T.filter_arcs(g, T.no_loops)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_on_card_match_cpu(cuda, name):
    from webgraph_tpu_torch import transform as T
    gc, gg = _transform_graphs(cuda)
    _same(TRANSFORMS[name](T, gc), TRANSFORMS[name](T, gg))


@pytest.mark.parametrize("fn", ["transpose_offline", "symmetrize_offline"])
def test_offline_transforms_on_card_match_cpu(cuda, tmp_path, fn):
    from webgraph_tpu_torch import transform as T
    gc, gg = _transform_graphs(cuda)
    bc = getattr(T, fn)(gc, batch_size=20_000, temp_dir=str(tmp_path))
    bg = getattr(T, fn)(gg, batch_size=20_000, temp_dir=str(tmp_path))
    assert len(bg.batches) >= 4 and bg.num_arcs == bc.num_arcs
    for a, b in zip(_batch_lists(bc), _batch_lists(bg)):
        np.testing.assert_array_equal(a, b)


# -- labelling on the card against the CPU -----------------------------------


def _labelled_pair(cuda, kind):
    """One labelled graph, on the CPU and on the card: scalar labels, or
    63-bit list labels holding 2**63 - 1 and empty lists."""
    from webgraph_tpu_torch import labelling as L
    from webgraph_tpu_torch.core.graph import CSRGraph
    co, su = E.simple(*synthesize_webgraph(5000, seed=13))
    m = len(su)
    rng = np.random.default_rng(5)
    if kind == "long63":
        counts = torch.from_numpy(rng.integers(0, 4, m))
        entries = torch.from_numpy(rng.integers(0, 1 << 62, int(counts.sum())))
        entries[::5] = (1 << 63) - 1
        proto, vals = L.FixedWidthLongListLabel("L", 63), (counts, entries)
    elif kind == "fixed10":
        proto = L.FixedWidthIntLabel("W", 10)
        vals = torch.from_numpy(rng.integers(0, 1000, m))
    else:
        proto = L.GammaCodedIntLabel("W")
        vals = torch.from_numpy(rng.geometric(0.2, m) - 1)
        vals[::11] = (1 << 31) - 1
    out = []
    for dev in ("cpu", cuda):
        g = CSRGraph(co, su, device=dev)
        v = (tuple(x.to(dev) for x in vals) if isinstance(vals, tuple)
             else vals.to(dev))
        out.append(L.ArcLabelledGraph(g, v, proto))
    return out


@pytest.mark.parametrize("kind", ["fixed10", "gamma", "long63"])
def test_label_codec_on_card_matches_cpu(cuda, kind):
    """The label pack on the card gives the CPU's bytes; the unpack on the
    card gives the values back."""
    from webgraph_tpu_torch.ops import labelcodec
    cpu_g, card_g = _labelled_pair(cuda, kind)
    a = labelcodec.pack_labels(cpu_g.values, cpu_g.graph.offsets,
                               cpu_g.prototype)
    b = labelcodec.pack_labels(card_g.values, card_g.graph.offsets,
                               card_g.prototype, chunk_arcs=7000)
    assert a[:3] == b[:3] and b[3].device == card_g.device
    lo = labelcodec.gamma_prefix_sums(np.frombuffer(a[2], np.uint8),
                                      cpu_g.num_nodes + 1)
    got = labelcodec.unpack_labels(np.frombuffer(b[0], np.uint8), lo,
                                   card_g.graph.offsets, card_g.prototype)
    torch.cuda.synchronize()
    if kind == "long63":
        assert all(torch.equal(x, y) for x, y in zip(got, card_g.values))
    else:
        assert got.device == card_g.device and torch.equal(got,
                                                           card_g.values)


@pytest.mark.parametrize("kind", ["fixed10", "gamma"])
def test_store_labelled_cuda_on_card_matches_host(cuda, tmp_path, kind):
    """``store_labelled(backend="cuda")`` on the card writes the host
    stores' bytes (native and the fused pass); ``to_device`` reads them
    back to the card through B1 and B2, equal."""
    from webgraph_tpu_torch import labelling as L
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    cpu_g, card_g = _labelled_pair(cuda, kind)
    bases = {}
    for backend, g in (("cuda", card_g), ("native", cpu_g),
                       ("python", cpu_g)):
        (tmp_path / backend).mkdir()
        bases[backend] = str(tmp_path / backend / "g")
        BVGraph.store_labelled(g, bases[backend], backend=backend)
    for other in ("native", "python"):
        for ext in (".graph", ".offsets", "-labelled.labels",
                    "-labelled.labeloffsets"):
            with open(bases["cuda"] + ext, "rb") as f, \
                    open(bases[other] + ext, "rb") as h:
                assert f.read() == h.read(), (other, ext)
    before = dict(_build.LAUNCHES)
    back = L.BitStreamArcLabelledGraph.load(
        bases["cuda"] + "-labelled").to_device()
    torch.cuda.synchronize()
    for k in ("bv_decode_lanes", "compact_runs"):
        assert _build.LAUNCHES[k] > before[k]
    assert back.device == card_g.device and back.equals_labelled(card_g)


def _b1_b2():
    return [_build.LAUNCHES[k] for k in ("bv_decode_lanes", "compact_runs")]


@pytest.mark.parametrize("argv,outs", [
    (["bfs", "{d}/bv", "{d}/dist", "-s", "5"], ["dist"]),
    (["scc", "{d}/bv", "{d}/comp"], ["comp"]),
    (["stats", "{d}/bv", "{d}/st", "--scc"], ["st.stats", "st.outdegrees",
                                              "st.indegrees"]),
    (["hyperball", "{d}/bv", "-l", "5"], []),
    (["transform", "symmetrize", "{d}/bv", "{d}/sym"],
     ["sym.graph", "sym.offsets"]),
    (["bvgraph", "{d}/bv", "{d}/re", "-w", "3"], ["re.graph", "re.offsets"]),
    (["speedtest", "{d}/bv", "-R", "1"], [])])
def test_cli_on_card_matches_cpu(cuda, tmp_path, capsys, argv, outs):
    """``cli.main`` with no ``--device`` runs on the card: the decode
    launches B1 and B2, and the printed lines (bar speedtest's timing) and
    written files equal the CPU run's."""
    from webgraph_tpu_torch.cli import main
    _file_graph(tmp_path)
    runs = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        for ext in (".graph", ".offsets", ".properties"):
            (d / ("bv" + ext)).write_bytes((tmp_path / ("bv" + ext))
                                           .read_bytes())
        _build.reset_launches()
        assert main([a.format(d=d) for a in argv] + extra) == 0
        torch.cuda.synchronize()
        runs[name] = (capsys.readouterr().out, _b1_b2(), d)
    assert all(v > 0 for v in runs["card"][1]), runs["card"][1]
    assert runs["cpu"][1] == [0, 0]
    if argv[0] == "speedtest":
        assert "M links/s" in runs["card"][0]
    elif argv[0] == "hyperball":
        a = [float(x.split("\t")[1]) for x in runs["card"][0].split("\n")
             if x]
        b = [float(x.split("\t")[1]) for x in runs["cpu"][0].split("\n")
             if x]
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    else:
        assert runs["card"][0] == runs["cpu"][0]
    for f in outs:
        assert (runs["card"][2] / f).read_bytes() == (
            runs["cpu"][2] / f).read_bytes(), f


@pytest.mark.parametrize("slice_arcs", [20_000, 1 << 40])
def test_sliced_decode_on_card_matches_plain(cuda, slice_arcs):
    """``decode_big_slices`` on the card equals its run on the CPU (the
    plain versions), slice for slice, and launches B1 and B2 per slice."""
    from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
    s = BVGraphSettings()
    co, su = E.simple(*synthesize_webgraph(6000, seed=4))
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=1)
    offsets = native.decode_offset_stream(offs, len(co) - 1,
                                          s.offset_coding)
    outd = np.diff(co)
    card = []
    for lo, hi, c, succ in decode_big_slices(offsets, outd, s, graph,
                                             slice_arcs=slice_arcs):
        assert c.device.type == "cuda" and succ.device.type == "cuda"
        card.append((lo, hi, c.cpu(), succ.cpu()))
    _build.reset_launches()
    plain = list(decode_big_slices(offsets, outd, s, graph,
                                   slice_arcs=slice_arcs, device="cpu"))
    assert _b1_b2() == [0, 0]
    assert len(card) == len(plain) >= (2 if slice_arcs < len(su) else 1)
    for (lo, hi, c, succ), (plo, phi, pc, psucc) in zip(card, plain):
        assert (lo, hi) == (plo, phi)
        assert torch.equal(c, pc) and torch.equal(succ, psucc)
    assert torch.equal(torch.cat([x[3] for x in card]).to(torch.int64),
                       torch.from_numpy(su))


def test_sliced_decode_launches_per_slice(cuda):
    from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
    s = BVGraphSettings()
    co, su = E.simple(*synthesize_webgraph(6000, seed=5))
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=1)
    offsets = native.decode_offset_stream(offs, len(co) - 1,
                                          s.offset_coding)
    _build.reset_launches()
    seen = []
    for _lo, _hi, _c, _succ in decode_big_slices(offsets, np.diff(co), s,
                                                 graph, slice_arcs=15_000):
        seen.append(_b1_b2())
        _build.reset_launches()
    assert len(seen) >= 3 and all(b1 >= 1 and b2 >= 1 for b1, b2 in seen)


def _shard_graph(n=6000, seed=6):
    s = BVGraphSettings()
    co, su = E.simple(*synthesize_webgraph(n, seed=seed))
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=1)
    offsets = native.decode_offset_stream(offs, len(co) - 1,
                                          s.offset_coding)
    return s, co, su, graph, offsets


def test_decode_sharded_kernel_on_card_matches_cpu(cuda):
    """Two shares on the card (one device listed twice): one B1 launch
    each, the store and the diagnostics equal to the CPU run."""
    from webgraph_tpu_torch.parallel.sharded import decode_sharded_kernel
    s, co, su, graph, offsets = _shard_graph()
    runs = {}
    for dev, devices in ((cuda, ["cuda:0"] * 2), (torch.device("cpu"),
                                                  ["cpu"] * 2)):
        plan = PP.plan_kernel_decode(offsets, np.diff(co), s, graph,
                                     device=dev)
        resolve_halos(plan)
        PC.plan_csr_index(plan)
        _build.reset_launches()
        store, diag = decode_sharded_kernel(plan, devices)
        runs[dev.type] = (store.cpu(), diag.cpu(),
                          PKC.compact(plan.compact_plan, store).cpu())
        if dev.type == "cuda":
            assert _build.LAUNCHES["bv_decode_lanes"] == 2
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(a, b)
    assert torch.equal(runs["cuda"][2].to(torch.int64), torch.from_numpy(su))


def test_store_multihost_cuda_on_card_matches_native(cuda, tmp_path):
    from webgraph_tpu_torch.core.graph import CSRGraph
    from webgraph_tpu_torch.parallel import multihost as MH
    s, co, su, _graph, _offsets = _shard_graph()
    g = CSRGraph(co, su, device=cuda)
    for backend in ("cuda", "native"):
        MH.store_multihost(g, str(tmp_path / backend), 3, settings=s,
                           backend=backend)
    gb, _b, ob, _o, _st = native.bv_encode(co, su, s, threads=3)
    props = []
    for backend in ("cuda", "native"):
        base = str(tmp_path / backend)
        assert (tmp_path / (backend + ".graph")).read_bytes() == gb.tobytes()
        assert (tmp_path / (backend + ".offsets")).read_bytes() == \
            ob.tobytes()
        with open(base + ".properties", encoding="iso-8859-1") as f:
            lines = f.read().split("\n")
        del lines[1]   # the date comment
        props.append(lines)
    assert props[0] == props[1]


def test_plan_shard_decode_on_card(cuda, tmp_path):
    """The second of three shards, planned cold on the card and decoded
    through B1 and B2, equals its range of the graph."""
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.core.graph import CSRGraph
    from webgraph_tpu_torch.parallel import multihost as MH
    s, co, su, _graph, _offsets = _shard_graph()
    base = str(tmp_path / "g")
    BVGraph.store(CSRGraph(co, su, device="cpu"), base, settings=s)
    bv = BVGraph.load(base)
    _build.reset_launches()
    plan, lo, hi = MH.plan_shard_decode(bv, bv.data, 1, 3)
    assert plan.device == cuda and 0 < lo < hi < len(co) - 1
    pco, succ, filled = PC.decode_to_csr(plan)
    assert filled == 0 and min(_b1_b2()) >= 1
    np.testing.assert_array_equal(pco, co[lo:hi + 1] - co[lo])
    np.testing.assert_array_equal(succ.cpu().numpy(), su[co[lo]:co[hi]])


def test_list_decode_on_card_matches_cpu(cuda, tmp_path):
    """List labels read back to the card (the threaded native decode into
    pinned buffers, one upload) equal the CPU's read and the labels
    stored; B1 and B2 decode the graph."""
    from webgraph_tpu_torch import labelling as L
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    cpu_g, card_g = _labelled_pair(cuda, "long63")
    b = str(tmp_path / "g")
    BVGraph.store_labelled(card_g, b, backend="cuda")
    lg = L.BitStreamArcLabelledGraph.load(b + "-labelled")
    before = dict(_build.LAUNCHES)
    on = lg.to_device()
    torch.cuda.synchronize()
    for k in ("bv_decode_lanes", "compact_runs"):
        assert _build.LAUNCHES[k] > before[k]
    assert on.device == card_g.device and on.equals_labelled(card_g)
    assert set(on.report["labels_split"]) == {"native_s", "upload_s"}
    assert lg.to_device("cpu").equals_labelled(cpu_g)


def _list_merge_cases(g, tmp):
    """The list merges of one labelled graph on its device: union with a
    relabelled copy, the offline symmetrize both ways, compose, and the
    filter with a list predicate."""
    from webgraph_tpu_torch import labelling
    from webgraph_tpu_torch import transform
    from webgraph_tpu_torch.labelling.graph import filter_labelled

    def below(v, x, t):
        arc = torch.repeat_interleave(
            torch.arange(v[0].numel(), device=v[0].device), v[0],
            output_size=v[1].numel())
        hit = torch.zeros(v[0].numel(), dtype=torch.bool, device=v[0].device)
        hit[arc[v[1] < (1 << 61)]] = True
        return hit

    cat = labelling.concat_lists
    r = labelling.relabel(g, lambda v, a, b: (v[0], v[1] >> 1), g.prototype)
    out = {"union": labelling.union_labelled(g, r, cat)}
    bs = transform.symmetrize_offline_labelled(g, merge=cat, batch_size=7001,
                                               temp_dir=str(tmp))
    out["symmetrize"] = bs.to_arc_labelled()
    _, succ, labs = next(bs.iter_labelled(17))
    out["iter_node_17"] = (succ.tolist(), [l.value.tolist() for l in labs])
    bs.cleanup()
    sub = filter_labelled(g, lambda v, x, t: (x < 300) & (t < 300))
    empty = (torch.zeros(0, dtype=torch.int64, device=g.device),) * 2
    out["compose"] = transform.compose_labelled(
        sub, sub, labelling.LabelSemiring(cat, cat, empty, empty))
    out["filter"] = filter_labelled(g, below)
    return out


def test_list_merges_on_card_match_cpu(cuda, tmp_path):
    cpu_g, card_g = _labelled_pair(cuda, "long63")
    (tmp_path / "c").mkdir()
    (tmp_path / "g").mkdir()
    want = _list_merge_cases(cpu_g, tmp_path / "c")
    got = _list_merge_cases(card_g, tmp_path / "g")
    torch.cuda.synchronize()
    for k, w in want.items():
        if k == "iter_node_17":
            assert got[k] == w
            continue
        assert got[k].device == card_g.device
        assert got[k].equals_labelled(w), k


def test_sliced_decode_past_a_range_store_on_card(cuda, tmp_path):
    """The big phase at a small size: the generator's torch copy on the
    card equals the numpy one, the graph stored by node ranges decodes
    slice by slice through B1 and B2 equal to it."""
    import chip_smoke
    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.ops import vencode
    from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
    from webgraph_tpu_torch.parallel.multihost import (encode_shard,
                                                       merge_shards)
    from .torch_big_graph import WebLikeGraph
    n, s = 200_000, BVGraphSettings()
    g = WebLikeGraph(n, seed=chip_smoke.BIG_SEED)
    base = str(tmp_path / "big")
    bounds = [0, 70_000, 150_000, n]
    for k in range(3):
        lo, hi = bounds[k], bounds[k + 1]
        co, su = chip_smoke.web_like_slice(n, chip_smoke.BIG_SEED, lo, hi,
                                           cuda)
        eco, esu = g.slice(lo, hi)
        assert np.array_equal(co.cpu().numpy(), eco)
        assert np.array_equal(su.cpu().numpy(), esu)
        encode_shard(eco, esu, s, base, k, lo, hi, threads=4, node_base=lo)
    # the offsets' gaps packed on the card: the bytes of a pack on the host
    merge_shards(base, 3, s)
    with open(base + ".offsets", "rb") as f:
        on_card = f.read()
    starts = native.decode_offset_stream(np.frombuffer(on_card, np.uint8),
                                         n, s.offset_coding)
    on_host, _ = vencode.pack_gaps(torch.from_numpy(np.diff(starts,
                                                            prepend=0)),
                                   s.offset_coding, s.zeta_k, device="cpu")
    assert on_host == on_card
    bv = BVGraph.load(base)
    offsets = bv.offsets_array()
    outd = native.decode_outdegrees(bv.data, offsets, s.outdegree_coding)
    rep, x = [], 0
    it = decode_big_slices(offsets, outd, s, bv.data, slice_arcs=1 << 20,
                           report=rep)
    while True:
        before = dict(_build.LAUNCHES)
        try:
            lo, hi, co, succ = next(it)
        except StopIteration:
            break
        for k in ("bv_decode_lanes", "compact_runs"):
            assert _build.LAUNCHES[k] > before[k]
        eco, esu = g.slice(lo, hi)
        assert lo == x and co.device == cuda
        assert np.array_equal(co.cpu().numpy(), eco)
        assert np.array_equal(succ.cpu().numpy(), esu)
        x = hi
    assert x == n and len(rep) >= 3
    assert all(r["route"] == "kernel" and r["fallback_arcs"] == 0
               for r in rep)
