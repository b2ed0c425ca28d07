"""The EF decode kernel (``csrc/ef_decode.cu``) and its two routes.

On the CPU (no card needed):

- ``_build`` carries the kernel's C entry and its launch key;
- the plan lists the kernel's segments: each list of more than
  ``HUB_ARCS`` arcs cut into ceil(d / HUB_ARCS) segments, at most one more
  than its skip pointers;
- a CPU plan decodes through the plain twin: the route "torch", the
  twin's spans, no ``ef.kernel_arcs``, no launch;
- the CUDA route's wrapper, driven with a stand-in for the kernel library
  on CPU tensors: the plan's own tensors and numbers reach the C entry,
  one launch a decode (none with no arcs), the span ``wg.ef.decode`` with
  the one child ``.kernel``, ``ef.kernel_arcs`` equal to ``ef.arcs``.

Marked ``gpu`` (skipped without a card): the kernel ``torch.equal`` to the
plain twin and to the lists it was given, on empty lists and a graph with
no arcs, l = 0 and u = 2^31 - 1, log2 quanta 2, 4 and 8, upper regions of
one, two and more than 32 words, lower fields across a word boundary, lists
of 4,097, 2^17 and 400,000 arcs, long lists with no skip pointer, and a
stream past 2^32 bits; one launch a decode, and no
``cudaStreamSynchronize`` inside ``wg.ef.decode``.  No jax here:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_ef_kernel.py
"""

import ctypes
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from webgraph_tpu_torch.codecs.efgraph import (EFGraph, ef_stream, lower_bits,
                                               number_of_pointers,
                                               pointer_size)
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops import _build
from webgraph_tpu_torch.ops.efdecode import HUB_ARCS, EFDevicePlan
from webgraph_tpu_torch.utils import trace as T

CPU = torch.device("cpu")
U_MAX = (1 << 31) - 1


def _lists(u, degrees, seed):
    """Sorted distinct seeded-random lists below ``u`` of ``degrees``."""
    rng = np.random.default_rng(seed)
    out = []
    for d in degrees:
        d = min(int(d), u)
        if u < 1 << 22:
            out.append(np.sort(rng.choice(u, size=d, replace=False)))
        else:
            v = np.unique(rng.integers(0, u, size=d + d // 8 + 8))
            out.append(np.sort(rng.choice(v, size=d, replace=False)))
    return out


def _csr(lists):
    co = np.zeros(len(lists) + 1, dtype=np.int64)
    co[1:] = np.cumsum([len(x) for x in lists])
    su = (np.concatenate(lists).astype(np.int64) if co[-1]
          else np.zeros(0, np.int64))
    return co, su


def _stream(co, su, u, q):
    """(words, per-node bit offsets) of the EF stream of (co, su)."""
    words, entry, _, _ = ef_stream(co, su, u, q)
    offsets = np.zeros(len(entry) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(entry)
    return words, offsets


def _plan(co, su, u, q, device):
    words, offsets = _stream(co, su, u, q)
    return EFDevicePlan(words, offsets, u, q, device=device)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("wg.")]


def _kids(evs, parent):
    return [e.name for e in evs if e.cpu_parent is parent]


# -- on the CPU -------------------------------------------------------------


def test_build_carries_the_kernel():
    assert _build.SIGNATURES["wg_ef_decode"] == [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    assert "ef_decode" in _build.LAUNCHES
    _build.LAUNCHES["ef_decode"] = 5
    _build.reset_launches()
    assert _build.LAUNCHES["ef_decode"] == 0


def test_cpu_plan_takes_the_plain_twin(tmp_path):
    co, su = _csr(_lists(300, [0, 3, 40, 7, 300, 1] * 20, seed=1))
    g = CSRGraph(co, su, device=CPU)
    base = str(tmp_path / "g")
    EFGraph.store(g, base, upper_bound=300)
    ef = EFGraph.load(base)
    csr = ef.to_device("cpu")
    assert csr.report["route"] == "torch"
    assert torch.equal(csr.succ, g.succ)
    plan = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                        ef.log2_quantum, device=CPU)
    _build.reset_launches()
    T.reset_counters()
    (co_t, su_t), evs = _profiled(lambda: plan.decode(chunk_arcs=500))
    assert torch.equal(co_t, g.offsets) and torch.equal(su_t, g.succ)
    assert _build.LAUNCHES["ef_decode"] == 0
    root = [e for e in evs if e.name == "wg.ef.decode"]
    assert len(root) == 1
    nchunks = -(-g.num_arcs // 500)
    assert _kids(evs, root[0]) == ["wg.ef.decode.layout",
                                   "wg.ef.decode.ranks",
                                   "wg.ef.decode.chunks"] + \
        ["wg.ef.decode.select"] * nchunks
    c = T.counters()
    assert c.get("ef.kernel_arcs", 0) == 0
    assert c == {"ef.arcs": g.num_arcs, "ef.chunks": nchunks}
    again = plan.decode_plain(chunk_arcs=500)
    assert torch.equal(again[1], su_t)


@pytest.mark.parametrize("q", [2, 8, 16])
def test_plan_lists_the_segments(q):
    u = 1 << 20
    degrees = [0, 5, HUB_ARCS, HUB_ARCS + 1, 3000, 40, 20000, 1]
    co, su = _csr(_lists(u, degrees, seed=3))
    plan = _plan(co, su, u, q, CPU)
    want = []
    for x, d in enumerate(degrees):
        if d > HUB_ARCS:
            npt = number_of_pointers(d + 1, u, q)
            ns = min(npt + 1, -(-d // HUB_ARCS))
            want += [[x, (s << 32) | ns] for s in range(ns)]
    assert plan.segments.dtype == torch.int64
    assert plan.segments.tolist() == want
    assert q < 16 or len(want) == 3     # no pointer: one segment a list
    assert q > 2 or len(want) == 2 + 6 + 40   # ceil(d / HUB_ARCS) each


class _StandIn:
    """A kernel library whose ``wg_ef_decode`` records its arguments and
    writes the plain twin's successors where the kernel would."""

    def __init__(self, plan):
        self.want, self.calls = plan.decode_plain()[1], []

    def wg_ef_decode(self, *args):
        self.calls.append(args)
        ctypes.memmove(args[10], self.want.data_ptr(), self.want.numel() * 4)
        return 0


@pytest.mark.parametrize("degrees", [[0, 5, 33, 0, 2], [0, 0, 0]])
def test_cuda_route_wrapper(monkeypatch, degrees):
    co, su = _csr(_lists(50, degrees, seed=2))
    plan = _plan(co, su, 50, 4, CPU)
    lib = _StandIn(plan)
    monkeypatch.setattr(plan, "device", torch.device("cuda", 0))
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 1234)
    _build.reset_launches()
    T.reset_counters()
    outs, evs = _profiled(lambda: [plan.decode(chunk_arcs=1)
                                   for _ in range(2)])
    m = int(co[-1])
    for off, succ in outs:
        assert off is plan.csr_off
        assert torch.equal(succ, torch.from_numpy(su).to(torch.int32))
    assert _build.LAUNCHES["ef_decode"] == (2 if m else 0)
    assert len(lib.calls) == (2 if m else 0)
    for (words, nwords, starts, off, n, u, q, hub, segs, nsegs, succ_p,
         stream), (_, succ) in zip(lib.calls, outs):
        assert (words, nwords, starts, off) == (
            plan.words.data_ptr(), plan.nwords, plan.starts.data_ptr(),
            plan.csr_off.data_ptr())
        assert plan.words.numel() == plan.nwords + 2
        assert (hub, segs, nsegs) == (HUB_ARCS, plan.segments.data_ptr(),
                                      len(plan.segments))
        assert (n, u, q, succ_p, stream) == (plan.n, 50, 4, succ.data_ptr(),
                                            1234)
    roots = [e for e in evs if e.name == "wg.ef.decode"]
    assert len(roots) == 2
    for r in roots:
        assert _kids(evs, r) == (["wg.ef.decode.kernel"] if m else [])
    assert T.counters() == {"ef.arcs": 2 * m, "ef.kernel_arcs": 2 * m}


# -- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fields_across_a_word(co, u, q, offsets) -> int:
    """Lower fields that cross a 64-bit word boundary."""
    n = 0
    for x in np.flatnonzero(np.diff(co)):
        d = int(co[x + 1] - co[x])
        lb = lower_bits(d + 1, u)
        base = (int(offsets[x]) + 2 * ((d + 1).bit_length() - 1) + 1
                + number_of_pointers(d + 1, u, q) * pointer_size(d + 1, u))
        pos = base + np.arange(d, dtype=np.int64) * lb
        n += int(((pos & 63) + lb > 64).sum()) if lb else 0
    return n


def _against_twin(plan, su=None):
    _build.reset_launches()
    off, got = plan.decode()
    assert _build.LAUNCHES["ef_decode"] == (1 if plan.m else 0)
    off_p, want = plan.decode_plain()
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.int32 and got.numel() == plan.m
    assert torch.equal(off, off_p)
    assert torch.equal(got, want)
    if su is not None:
        assert torch.equal(got.cpu(), torch.from_numpy(su).to(torch.int32))


CASES = {
    # name: (upper bound, outdegrees)
    "empty_lists": (1000, [0, 0, 3, 0, 17, 0, 0, 1, 0] * 40),
    "l_zero": (40, [39, 40, 25, 38, 33, 0, 40] * 10),
    "u_max": (U_MAX, [1, 2, 9, 31, 32, 33, 64, 200, 1000] * 8),
    "region_words": (1 << 20, [5, 10, 20, 28, 40, 60, 90, 700, 1500, 3000]
                     * 9),
    "mixed_crawl": (200_000, list(np.random.default_rng(4).geometric(
        1 / 16, size=5000))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("q", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_twin(cuda, name, q):
    u, degrees = CASES[name]
    co, su = _csr(_lists(u, degrees, seed=len(name) + q))
    words, offsets = _stream(co, su, u, q)
    if name == "l_zero":
        assert all(lower_bits(int(d) + 1, u) == 0 for d in np.diff(co) if d)
    if name == "region_words":
        # upper regions of 1, 2 and more than 32 words
        d = np.diff(co)
        region = (u >> np.array([lower_bits(int(c), u) for c in d + 1])) \
            + d + 1
        assert region.min() <= 64 and ((region > 64) & (region <= 128)).any()
        assert region.max() > 32 * 64
    if name in ("u_max", "region_words", "mixed_crawl"):
        assert _fields_across_a_word(co, u, q, offsets) > 0
    plan = EFDevicePlan(words, offsets, u, q, device=cuda)
    _against_twin(plan, su)


@pytest.mark.gpu
def test_graph_with_no_arcs(cuda):
    co, su = _csr([np.zeros(0, np.int64)] * 300)
    plan = _plan(co, su, 300, 8, cuda)
    assert plan.m == 0
    _against_twin(plan, su)


@pytest.mark.gpu
@pytest.mark.parametrize("degrees,u", [([4097, 3, 0, 4097, 12], 18_520_486),
                                       ([1 << 17, 5, 40, 1 << 17], 1 << 20),
                                       ([1 << 17, 16385, 16384], U_MAX),
                                       ([400_000, 3, 700, 0, 513], 1 << 24)])
def test_long_lists(cuda, degrees, u):
    co, su = _csr(_lists(u, degrees, seed=7))
    for q in (4, 8):
        _against_twin(_plan(co, su, u, q, cuda), su)


@pytest.mark.gpu
def test_long_lists_without_pointers(cuda):
    """A quantum past every list's zeros: each long list is one segment,
    decoded whole by one warp."""
    u, q = 1 << 16, 16
    co, su = _csr(_lists(u, [700, 5000, 3, 30000, 0, 513], seed=8))
    plan = _plan(co, su, u, q, cuda)
    assert len(plan.segments) == 4
    _against_twin(plan, su)


@pytest.mark.gpu
def test_stream_past_2_32_bits(cuda):
    """Copies of a block of lists (short, one a warp decodes, one cut into
    segments) whose bits are a whole number of words, tiled past 2^32
    stream bits."""
    u, q = U_MAX, 8
    co, su = _csr(_lists(u, [0, 7, 31, 45, 300, 20000, 1, 2], seed=9))
    words, offsets = _stream(co, su, u, q)
    bits = int(offsets[-1])
    k = 64 // math.gcd(bits, 64)
    co_k, su_k = _csr([su[co[x]:co[x + 1]] for x in range(len(co) - 1)] * k)
    words, offsets = _stream(co_k, su_k, u, q)
    block_words = int(offsets[-1]) // 64
    reps = (1 << 32) // (block_words * 64) + 2
    tiled = np.zeros(block_words * reps + 1, dtype=np.uint64)
    tiled[:-1] = np.tile(words[:block_words], reps)
    nodes = len(co_k) - 1
    starts = (np.arange(reps, dtype=np.int64)[:, None] * (block_words * 64)
              + offsets[:-1][None, :]).reshape(-1)
    all_offsets = np.append(starts, reps * block_words * 64)
    assert all_offsets[-1] > 1 << 32
    plan = EFDevicePlan(tiled, all_offsets, u, q, device=cuda)
    del tiled
    assert plan.n == reps * nodes and plan.m == reps * len(su_k)
    _build.reset_launches()
    _, got = plan.decode()
    assert _build.LAUNCHES["ef_decode"] == 1
    want = torch.from_numpy(su_k.astype(np.int32)).to(cuda).repeat(reps)
    assert torch.equal(got, want)
    _, plain = plan.decode_plain()
    assert torch.equal(got, plain)


@pytest.mark.gpu
def test_no_sync_inside_the_decode(cuda):
    """A profiler trace of the kernel route has no cudaStreamSynchronize
    inside ``wg.ef.decode``; the plain twin's (its chunk readbacks) has."""
    co, su = _csr(_lists(5000, [3, 40, 0, 900] * 500, seed=11))
    plan = _plan(co, su, 5000, 8, cuda)
    plan.decode()
    torch.cuda.synchronize()

    def syncs_inside(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = prof.events()
        roots = [e for e in evs if e.name == "wg.ef.decode"]
        assert len(roots) == 1
        r = roots[0].time_range
        return [e for e in evs if e.name == "cudaStreamSynchronize"
                and r.start <= e.time_range.start < r.end]

    assert syncs_inside(plan.decode) == []
    assert syncs_inside(plan.decode_plain) != []
