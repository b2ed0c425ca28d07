"""The decode kernel's own source (``csrc/bv_decode.cu``) on the CPU, held
against its plain PyTorch twin.

The kernel body is plain C++ apart from the CUDA qualifiers, so it is built
here with g++ under ``WG_HOST_BUILD``, a header that defines the qualifiers
away, and run one lane after another (each lane is one thread, which shares
nothing with the others).  That holds the kernel's arithmetic, control flow
and diagnostics exactly against ``decode_lanes_plain`` on every stream
format the kernel takes, on garbled streams and on the edge inputs of
``torch_edge_cases``, split lists included; the kernel built without its
preset code (``WG_B1_SPLIT`` 0) must give what the one with it gives on a
plan without preset lanes.  The merge of split lists (``split_merge``) is
held against ``merge_split_plain`` the same way.  What only the card can
show (the CUDA build, the launch, timing) is left to ``test_torch_gpu.py``
and ``chip_smoke.py``.
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
static wg_dim3 threadIdx, blockIdx, blockDim, gridDim;
"""

RUNNER = r"""
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
    WG_B1_KERNEL((const uint32_t*)words, nwords, (const int64_t*)meta, nmeta,
                 lanes, (int32_t*)store, (int32_t*)diag, nullptr, sp);
  }
}
#if !WG_B1_SPLIT
// one thread walks every row, phase 0 then phase 1
extern "C" void wg_host_merge(void* store, void* tmp, const void* row0,
    const void* res, const void* base, const void* tile, int64_t total) {
  blockIdx.x = threadIdx.x = 0;
  blockDim.x = gridDim.x = 1;
  for (int phase = 0; phase < 2; ++phase)
    split_merge_kernel((int32_t*)store, (int32_t*)tmp, (const int64_t*)row0,
                       (const int64_t*)res, (const int64_t*)base,
                       (const int32_t*)tile, total, phase);
}
#endif
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
    """The kernel source built twice with g++ (``WG_B1_SPLIT`` 0 and 1, as
    ``bv_decode.cu`` and ``bv_decode_split.cu`` build it for the card):
    ``run`` decodes with the build the wrapper would pick, ``run.merge``
    runs ``split_merge``."""
    d = tmp_path_factory.mktemp("bv_decode_host")
    (d / "shim.h").write_text(SHIM)
    (d / "run.cpp").write_text(RUNNER % SRC)
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = []
    for split in (0, 1):
        out = d / f"libbvhost{split}.so"
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-DWG_HOST_BUILD", f"-DWG_B1_SPLIT={split}",
                        str(d / "run.cpp"), "-o", str(out)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(out))
        lib.wg_host_decode.argtypes = [vp, i64, vp, i64, i64, vp, vp] + [
            ci] * 8
        lib.wg_host_decode.restype = None
        libs.append(lib)
    libs[0].wg_host_merge.argtypes = [vp] * 6 + [i64]
    libs[0].wg_host_merge.restype = None

    def run(words, meta, store, spec, split=None):
        """The kernel on every lane; ``split`` picks the build (by default
        the wrapper's choice: whether a lane has preset fields)."""
        if split is None:
            split = bool(meta[:, PK.preset_col(spec.window_size)].any())
        diag = torch.zeros((meta.shape[0], PK.DIAG_ROWS), dtype=torch.int32)
        libs[int(split)].wg_host_decode(
            words.data_ptr(), words.shape[0], meta.data_ptr(), meta.shape[1],
            meta.shape[0], store.data_ptr(), diag.data_ptr(),
            spec.window_size, spec.min_interval_length, spec.zeta_k,
            spec.outdegree_coding, spec.reference_coding,
            spec.block_count_coding, spec.block_coding, spec.residual_coding)
        return diag

    def merge(store, sp):
        tmp = torch.zeros(max(sp.merge_rows, 1), dtype=torch.int32)
        libs[0].wg_host_merge(store.data_ptr(), tmp.data_ptr(),
                              sp.merge_row0.data_ptr(),
                              sp.merge_res.data_ptr(),
                              sp.merge_base.data_ptr(),
                              sp.merge_tile.data_ptr(), sp.merge_rows)
    run.merge = merge
    return run


def _both(run, plan):
    """Kernel source and twin from one store image: (diag, diag_plain).
    Without preset lanes the kernel built with its preset code gives the
    same too."""
    s_k, s_p = plan.store.clone(), plan.store.clone()
    diag = run(plan.words, plan.meta, s_k, plan.spec)
    diag_p = PK.decode_lanes_plain(plan.words, plan.meta, s_p, plan.spec)
    assert torch.equal(diag, diag_p)
    assert torch.equal(s_k, s_p)
    if not plan.meta[:, PK.preset_col(plan.spec.window_size)].any():
        s_t = plan.store.clone()
        assert torch.equal(run(plan.words, plan.meta, s_t, plan.spec, True),
                           diag)
        assert torch.equal(s_t, s_k)
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


@pytest.mark.parametrize("name", sorted(E.SPLIT_CASES) + ["corrupt_segment"])
def test_kernel_source_split_lists(host_kernel, name):
    """Split lists (preset lanes, low thresholds): the kernel source and the
    twin give the same store and diagnostics, the merge kernel and its twin
    the same rows; a warm plan's chunk rows are then the lists.  In
    ``corrupt_segment`` a preset lane starts a bit late: it and its list's
    head lane are flagged, nothing else (a flagged list's merged rows are
    left unspecified: the host fill replaces them)."""
    co, su, s, kw, graph, offsets, outd = E.build_split(
        "copies" if name == "corrupt_segment" else name)
    plan = PP.plan_kernel_decode(offsets, outd, s, graph, device="cpu", **kw)
    sp = plan.split
    assert sp is not None and sp.segments > 0
    if name == "corrupt_segment":
        plan.meta[plan.lanes + 3, PK.M_BIT] += 1
    diag, store = _both(host_kernel, plan)
    errs = PK.check_diag(plan, diag)
    if name == "corrupt_segment":
        assert np.flatnonzero(errs).tolist() == [int(sp.seg_head[3])]
        return
    assert sp.merged or name in ("pure_residual",)
    store_p = store.clone()
    host_kernel.merge(store, sp)
    PK.merge_split_plain(store_p, sp.merge_row0, sp.merge_res,
                         sp.merge_base)
    assert torch.equal(store, store_p)
    if kw["halo_csr"] is not None:
        assert not errs.any()
        E.check_store(plan, store, co, su)
