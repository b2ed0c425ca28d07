"""The compaction kernel's own source (``csrc/compact.cu``) on the CPU, held
against its plain PyTorch twin.

The per-tile arithmetic of the kernel (tile span, run slice, each vector's
run and source, the head and tail splits at run and chunk boundaries) is
in functions that compile for host and device alike.  Under
``WG_HOST_BUILD`` the source builds with g++ alone, and
``wg_compact_runs_host`` runs those functions tile by tile and thread by
thread as the kernel's blocks do.  Built with the shipped macros and with
other tiles, threads, K and run slices (down to one run a chunk and one
vector a round, so that chunks, several rounds of K vectors and the
position-by-position path all occur), it rebuilds the CSR exactly as
``compact_plain`` does on every valid position, writes no position of an
invalid run, and reads nothing outside the store.  What only the card can
show (the CUDA build, the launch, timing) is left to ``test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from webgraph_tpu_torch.ops import kcompact as PKC

from .torch_compact_layouts import LAYOUTS, build_layout

torch.set_num_threads(1)
CPU = torch.device("cpu")
SRC = (pathlib.Path(__file__).resolve().parents[1] / "webgraph_tpu_torch"
       / "csrc" / "compact.cu")
SENTINEL = -123456789

# name: macros; the tile each variant takes is its WG_B2_TILE (default TILE)
VARIANTS = {
    "shipped": {},
    "shipped_k8": {"WG_B2_K": 8},
    "small_k3_cap4": {"WG_B2_TILE": 512, "WG_B2_THREADS": 32, "WG_B2_K": 3,
                      "WG_B2_CAP": 4},
    "small_k2_cap5": {"WG_B2_TILE": 256, "WG_B2_THREADS": 32, "WG_B2_K": 2,
                      "WG_B2_CAP": 5},
    # every run a chunk of its own, one vector a round
    "small_k1_cap1": {"WG_B2_TILE": 256, "WG_B2_THREADS": 32, "WG_B2_K": 1,
                      "WG_B2_CAP": 1},
    "mid_t64_cap16": {"WG_B2_TILE": 1024, "WG_B2_THREADS": 64, "WG_B2_K": 4,
                      "WG_B2_CAP": 16},
    "tile4096": {"WG_B2_TILE": 4096},
}


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """name -> (run, tile): each variant built with g++ on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            if shutil.which("g++") is None:
                pytest.skip("needs g++ to build the kernel source")
            macros = VARIANTS[name]
            d = tmp_path_factory.mktemp(f"compact_{name}")
            out = d / "libcompacthost.so"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-DWG_HOST_BUILD", *[f"-D{k}={v}" for k, v in macros.items()],
                 "-x", "c++", str(SRC), "-o", str(out)],
                check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(out))
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.wg_compact_runs_host.argtypes = [vp, i64, vp, i64, vp, vp, vp,
                                                 vp, i64]
            lib.wg_compact_runs_host.restype = ctypes.c_int64
            cache[name] = (lib, macros.get("WG_B2_TILE", PKC.TILE))
        return cache[name]
    return get


def run_host(lib, cp, store: torch.Tensor) -> torch.Tensor:
    """The kernel's steps on the CPU; no read may leave the store."""
    csr = torch.full((cp.m,), SENTINEL, dtype=torch.int32)
    stray = lib.wg_compact_runs_host(
        store.data_ptr(), store.numel(), csr.data_ptr(), cp.m,
        cp.arc_start.data_ptr(), cp.src0.data_ptr(), cp.valid.data_ptr(),
        cp.tile_run0.data_ptr(), cp.n_tiles)
    assert stray == 0, f"{stray} reads outside the store"
    return csr


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_source_matches_twin(host_builds, layout, variant):
    lib, tile = host_builds(variant)
    cp, store, vmask, *_ = build_layout(layout, tile)
    got = run_host(lib, cp, store)
    exp = PKC.compact_plain(cp, store)
    assert torch.equal(got[vmask], exp[vmask])
    # the positions of invalid runs are not written
    assert bool((got[~vmask] == SENTINEL).all())


def test_alignment_layout_meets_every_pair():
    """The alignment layout holds runs of every (output, source) alignment
    pair, of lengths below and above one vector, inside tiles and across
    tile boundaries."""
    cp, store, vmask, arcs, arc_start, src0 = build_layout("alignments")
    ne = arcs > 0
    pairs = set(zip((arc_start[:-1][ne] % 4).tolist(),
                    (src0[ne] % 4).tolist()))
    assert pairs == {(a, b) for a in range(4) for b in range(4)}
    assert (arcs[ne] < 4).any() and (arcs[ne] > 8).any()
    crosses = (arc_start[:-1] // PKC.TILE) != ((arc_start[1:] - 1) // PKC.TILE)
    assert (crosses & ne).any()


def test_many_runs_layout_overflows_the_slice():
    """A tile of the many-runs layout spans more runs than the shipped
    slice holds, so the kernel walks it in chunks."""
    cp, *_ = build_layout("many_runs")
    spans = np.diff(cp.tile_run0.numpy()) + 1
    assert spans.max() > int(_macro("WG_B2_CAP"))


def _macro(name):
    m = re.search(rf"#define {name} (\d+)", SRC.read_text())
    assert m, name
    return m.group(1)


def test_shipped_tile_matches_the_planner():
    """The kernel's compiled tile is the tile the planner brackets."""
    assert int(_macro("WG_B2_TILE")) == PKC.TILE


def test_plan_rejects_bad_tiles():
    with pytest.raises(ValueError, match="multiple of 4"):
        PKC.plan_compact(np.asarray([0, 5]), np.zeros(1, np.int64),
                         np.ones(1, bool), 5, device=CPU, tile=6)
    cp = PKC.plan_compact(np.asarray([0, 5]), np.zeros(1, np.int64),
                          np.ones(1, bool), 5, device=CPU, tile=8)
    assert cp.tile == 8 and cp.n_tiles == 1
