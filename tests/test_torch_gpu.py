"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (and no jax), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernels are built from ``webgraph_tpu_torch/csrc`` on first use, and the
shared host library is rebuilt for the host.  Every value is an integer:
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import BVGraphSettings
from webgraph_tpu.codecs.bvgraph import CompressionFlags as C
from webgraph_tpu.utils.synth import synthesize_webgraph
from webgraph_tpu_torch.algo import hyperball as PHB
from webgraph_tpu_torch.ops import _build
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kcompact as PKC
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.resolve import resolve_halos

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
    _build.use_built_native()
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
