"""The decode kernel's own source (``csrc/bv_decode.cu``) on the CPU, held
against its plain PyTorch twin.

The kernel body is plain C++ apart from the CUDA qualifiers, so it is built
here with g++ under ``WG_HOST_BUILD``, a header that defines the qualifiers
away, and run one lane after another (each lane is one thread, which shares
nothing with the others).  That holds the kernel's arithmetic, control flow
and diagnostics exactly against ``decode_lanes_plain`` on every stream
format the kernel takes, on garbled streams and on the edge inputs of
``torch_edge_cases``.  What only the card can show (the CUDA build, the
launch, timing) is left to ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import ctypes
import pathlib
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from webgraph_tpu_torch import native
from webgraph_tpu_torch.ops import kdecode as PK
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.bitstream import stream_words
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.settings import CompressionFlags as C
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from . import torch_edge_cases as E

torch.set_num_threads(1)
SRC = (pathlib.Path(__file__).resolve().parents[1] / "webgraph_tpu_torch"
       / "csrc" / "bv_decode.cu")

SHIM = r"""
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __clzll(long long x) {
  return x ? __builtin_clzll((unsigned long long)x) : 64;
}
struct wg_dim3 { unsigned x; };
static wg_dim3 threadIdx, blockIdx;
"""

RUNNER = r"""
#define WG_HOST_BUILD 1
#include "shim.h"
#include "%s"
extern "C" void wg_host_decode(const void* words, int64_t nwords,
    const void* meta, int64_t nmeta, int64_t lanes, void* store, void* diag,
    int W, int minint, int zk, int k_outd, int k_ref, int k_bc, int k_blk,
    int k_res) {
  Spec sp{W, minint, zk, k_outd, k_ref, k_bc, k_blk, k_res};
  for (int64_t l = 0; l < lanes; ++l) {
    blockIdx.x = unsigned(l / THREADS);
    threadIdx.x = unsigned(l %% THREADS);
    bv_decode_lanes_kernel((const uint32_t*)words, nwords,
                           (const int64_t*)meta, nmeta, lanes,
                           (int32_t*)store, (int32_t*)diag, nullptr, sp);
  }
}
"""

SETTINGS = {
    "default": BVGraphSettings(),
    "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
    "delta_w4_int2": BVGraphSettings(outdegree_coding=C.DELTA, window_size=4,
                                     min_interval_length=2),
    "gamma_res_maxref1": BVGraphSettings(residual_coding=C.GAMMA,
                                         max_ref_count=1),
    "zeta1_blocks": BVGraphSettings(zeta_k=1, block_coding=C.ZETA),
    "unary_bc_w2_int1": BVGraphSettings(block_count_coding=C.UNARY,
                                        window_size=2, min_interval_length=1),
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    d = tmp_path_factory.mktemp("bv_decode_host")
    (d / "shim.h").write_text(SHIM)
    (d / "run.cpp").write_text(RUNNER % SRC)
    out = d / "libbvhost.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    str(d / "run.cpp"), "-o", str(out)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.wg_host_decode.argtypes = [vp, i64, vp, i64, i64, vp, vp] + [ci] * 8
    lib.wg_host_decode.restype = None

    def run(words, meta, store, spec):
        diag = torch.zeros((meta.shape[0], PK.DIAG_ROWS), dtype=torch.int32)
        lib.wg_host_decode(
            words.data_ptr(), words.shape[0], meta.data_ptr(), meta.shape[1],
            meta.shape[0], store.data_ptr(), diag.data_ptr(),
            spec.window_size, spec.min_interval_length, spec.zeta_k,
            spec.outdegree_coding, spec.reference_coding,
            spec.block_count_coding, spec.block_coding, spec.residual_coding)
        return diag
    return run


def _both(run, plan):
    """Kernel source and twin from one store image: (diag, diag_plain)."""
    s_k, s_p = plan.store.clone(), plan.store.clone()
    diag = run(plan.words, plan.meta, s_k, plan.spec)
    diag_p = PK.decode_lanes_plain(plan.words, plan.meta, s_p, plan.spec)
    assert torch.equal(diag, diag_p)
    assert torch.equal(s_k, s_p)
    return diag, s_k


@pytest.mark.parametrize("garble", E.GARBLES)
@pytest.mark.parametrize("sname", sorted(SETTINGS))
def test_kernel_source_matches_twin(host_kernel, sname, garble):
    """Planned on the clean stream, decoded from a garbled one: the kernel
    source and the twin agree on every lane, flagged or not."""
    s = SETTINGS[sname]
    n = 2500
    co, su = synthesize_webgraph(n, seed=7)
    co, su = E.simple(co, su)
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=2)
    offsets = native.decode_offset_stream(offs, n, s.offset_coding)
    plan = PP.plan_kernel_decode(offsets, np.diff(co), s, graph, device="cpu",
                                 halo_csr=(co, su), target_arcs_per_lane=24)
    plan.words = stream_words(E.garble(graph, garble), "cpu")
    diag, _ = _both(host_kernel, plan)
    errs = PK.check_diag(plan, diag)
    assert errs.any() == (garble != "clean")


@pytest.mark.parametrize("name", sorted(E.CASES))
def test_kernel_source_edge_cases(host_kernel, name):
    co, su, s, kw, graph, offsets, outd = E.build(name)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device="cpu", **kw)
    diag, store = _both(host_kernel, plan)
    assert not PK.check_diag(plan, diag).any()
    E.check_store(plan, store, co, su)


def test_kernel_source_random_streams(host_kernel):
    """Lanes over random bits (and a run of zero words), with random
    windows and halo rows: the error paths, one after another."""
    rng = np.random.default_rng(3)
    for s in (BVGraphSettings(),
              BVGraphSettings(window_size=3, min_interval_length=2,
                              outdegree_coding=C.DELTA)):
        W = s.window_size
        L, seg = 600, 40
        # random words, a zero run inside, and the 16 zero guard words
        # every packed stream ends with (bitstream.pack_words_u32)
        w = rng.integers(-2**31, 2**31, 4016, dtype=np.int64)
        w[1000:1300] = 0
        w[4000:] = 0
        meta = np.zeros((L, PK.nmeta(W)), dtype=np.int64)
        meta[:, PK.M_NODES] = rng.integers(1, 6, L)
        meta[:, PK.M_BIT] = rng.integers(0, 4000 * 32, L)
        meta[:, PK.M_X] = rng.integers(0, 1000, L)
        meta[:, PK.M_WCUR0] = 8
        meta[:, PK.M_BASE] = np.arange(L) * seg
        meta[:, PK.M_SEG] = seg
        meta[:, PK.M_WIN:PK.M_WIN + W + 1] = rng.integers(0, 6, (L, W + 1))
        meta[:, PK.M_WIN + W + 1:PK.M_WIN + 2 * (W + 1)] = rng.integers(
            0, 4, (L, W + 1))
        plan = SimpleNamespace(
            words=torch.from_numpy(w.astype(np.int32)),
            meta=torch.from_numpy(meta),
            store=torch.from_numpy(rng.integers(0, 2000, L * seg)
                                   .astype(np.int32)),
            spec=PK.KernelSpec.from_settings(s))
        diag, _ = _both(host_kernel, plan)
        bits = np.bitwise_or.reduce(diag[:, PK.DIAG_ERR].numpy())
        assert bits & PK.E_UNARY and bits & PK.E_COUNT, bits
