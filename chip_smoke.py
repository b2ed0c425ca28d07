#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``webgraph_tpu_torch``) on one GPU.

Drives the port's main path -- a cold BVGraph decode planned from the
stream and its offsets alone, into a device-resident CSR, its files
written and read back, its transforms encoded on the device, the command
line and the sliced decode run on it, its shards encoded and decoded by
rank processes and over listed devices, then the analytics over it
(HyperBall to convergence, BFS, connected and strongly connected
components, geometric centrality, statistics) -- at uk-2002
scale (18.5M nodes, ~355M arcs of a synthetic web graph), holding the
main path's hand-written CUDA kernels (B1 in its two builds, the split
lists' merge, B2, HyperBall's merge and estimate and the EF decode)
against their plain PyTorch versions on the card; and the
probe path -- every probe of the JAX package's ``experiments/`` ported to
a CUDA kernel in ``webgraph_tpu_torch/experiments/`` -- at the probes'
own shapes.

Phases, each printing one line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds the kernels (with ptxas's registers, stack and
   spills of the main-path kernels), g++ the port's host library;
3. kernels: the decode kernel (B1) against ``decode_lanes_plain`` under
   four stream formats and one garbled stream, the compaction kernel (B2)
   against ``compact_plain`` on random run tables with invalid runs and on
   runs of 1-7 arcs at every source alignment;
4. probes: with launch counts reset just before and read just after,
   every case of every probe module (``cases`` of ``probe``, ``probe2``
   ... ``probe17``: 23 probe sites, every variant) launches its kernel at
   the probe's step count, times it with CUDA events, and holds it equal
   to its plain version (at a smaller step count where the plain version
   at the full count would take too long; the line says which);
5. slice: the synthetic graph is generated and encoded (cached in
   ``.bench_synth_<N>.npz``; on the host, in a thread beside the kernels
   phase, whose times the line marks so), then plan -> resolve_halos ->
   decode_to_csr
   -> ``CSRGraph.from_decoded`` -> device_round with launch counts reset
   just before and read just after; then timings; B1's steps per arc and
   its slowest lane launched alone; a ``torch.profiler`` window over one
   ``decode_to_csr``; B2's library yardstick (``torch.index_select`` over
   a prebuilt index) and a device-to-device ``copy_`` of the same m int32
   (``copy_ms``); B1 and B2 against their plain versions at the shapes
   the slice gave them; HyperBall's merge (``merge_rows``, one launch of
   ``csrc/hyperball.cu``) held whole against ``merge_rows_plain``: the
   main path's round, then at log2m 6 a dense round and a sparse list (one
   node in ten and the longest list) with int32 and int64 ids, each timed
   beside its plain twin, and the library path the round ran before the
   kernel (a gather and ``scatter_reduce_`` over a prebuilt source index)
   timed and held equal; HyperBall's estimate (``estimate_rows``, one
   launch of ``csrc/hyperball.cu``'s ``hyperball_estimate``) of that dense
   round's changed rows and of every row, held bit for bit to
   ``estimate_rows_plain``, timed beside its bound, its twin and one
   ``estimate_counts_device`` call; and the CSR bit-exact against the
   native sequential decoder;
6. hubs: a 1,000,000-node synthetic whose nodes 0, 250,000, 500,000 and
   750,000 hold seeded-random lists of 131,072 to 786,432 successors,
   stored single-stream in ``.hubs_smoke_*/`` under the checkout (removed
   at the end), planned cold (each hub list split across preset lanes)
   and decoded to a CSR held equal to the graph; then the slowest lane and
   each hub's lanes launched alone, the whole B1 pass and the pass without
   the hubs' lanes timed by CUDA events: the share of B1's pass the hubs'
   lanes take (``hub_share``); then Graph500's scale-24 Kronecker graph
   (``benchmark/configs/graph500-s24.json``, the benchmark's generator, at
   ``GRAPH500_SEED``), encoded on the card, planned cold (thousands of
   lists split) and decoded to a CSR held equal to it with launch counts
   reset just before (one launch of B1's split build, two of the merge,
   one of B2), B1's split build held against ``decode_lanes_plain`` and
   the merge against ``merge_split_plain``, each timed beside its bound;
7. files: the slice's device CSR is written to a BVGraph basename in a
   temporary directory under the checkout (``BVGraph.store``, the native
   encoder), read back to the card with ``load_csr(basename)`` -- the
   cold plan, the resolve passes and ``decode_to_csr``, so B1 and B2, with
   launch counts reset just before and read just after -- and held
   ``torch.equal`` to it; the slice is written as an EFGraph by the device
   writer (``EFGraph.store(backend="cuda")``), decoded on the card
   (``EFGraph.to_device``: the kernel ``ef_decode``, route "cuda") and held
   equal to it; the kernel is held whole against its plain twin
   (``decode_plain``) at the slice, with one launch a decode, and both are
   timed beside the byte bound (``ef_kernel``); and a
   500,000-node synthetic (``OFFLINE_NODES``: the numpy store takes ~100 s
   at the slice) is stored by both the numpy and the device writer, the
   files held equal (``ef_store_compared``); the line
   gives each format's file sizes, bits per link, store and load seconds,
   the decode stages, the EF decode's rate and peak bytes, its split into
   the plan (upload, outdegrees) and decodes of the resident stream, and
   the card;
8. encode: the device encoder (``BVGraph.store(backend="cuda")``,
   ``ops/vencode.py``) and the transforms at the slice's scale.  The
   slice's device CSR is stored and held byte-equal (``.graph``,
   ``.offsets``, ``.properties`` bar the date line) to the single-stream
   native encode (``native.bv_encode(..., threads=1)`` through
   ``BVGraph.store(backend="native", num_threads=1)``, timed as the
   yardstick); its Gray-code renumbering (``gray_code_permutation``, its
   tie groups resolved in bulk on the card, then ``apply_permutation``),
   its transpose and its symmetrization are stored the same way; each of
   the four is read back with ``load_csr`` -- launch counts reset just
   before, B1 and B2 launched -- and held ``torch.equal`` to the graph
   stored.  Then ``transpose_offline`` and ``symmetrize_offline`` of a
   500,000-node synthetic (``OFFLINE_NODES``), in 5 batches or more,
   merged and stored with the device encoder and read back equal to the
   in-memory transforms.
   The line gives each store's seconds and rate, its split (setup, arc
   arrays and masks, cost matrix, its copy to the host, ``select_refs``,
   pack, concatenation, offsets, file writes), its peak device bytes above
   what is resident and its bits per link; the chunk size; the cost
   matrix's copy rate; one chunk's pack under ``torch.profiler``; the tie
   groups; and the card.  Everything it made is freed before the next
   phase; then labels: two label streams stored and loaded with the slice,
   and the labelled transforms and SCC; then list labels
   (``FixedWidthIntListLabel(A,20)``, about one entry an arc): stored with
   the slice on the card, the files checked bit by bit, read back with
   ``to_device`` (the threaded native list decode, one upload), filter
   and SCC with a list predicate; at 500,000 nodes the offline
   transpose twice, the offline symmetrize and the union with a
   concatenation merge (checked pair by pair), ``iter_labelled`` against
   the bulk merge, the store byte-equal to the native backend's on the
   host; at 100,000 nodes ``compose_labelled`` under a list semiring;
9. cli: the command line (``webgraph_tpu_torch/cli``) as a user runs it,
   on the slice stored once as a BVGraph basename in ``.cli_smoke_*/``
   under the checkout (removed at the end).  ``python -m
   webgraph_tpu_torch speedtest <basename> --repeat 3`` in a process of
   its own (its exit code and printed rate); ``cli.main`` for ``bfs
   --start 0``, ``scc``, ``stats`` and ``hyperball --log2m 6`` in this
   process, launch counts reset around each (B1 and B2 must be launched),
   each output held equal to the same analytic on the slice's in-memory
   CSR and timed from the call to its return (``hyperball`` launches
   ``hyperball_merge`` once a round or less, at least once); ``decode_big_slices`` in
   slices of 2^27 arcs, launch counts reset before each slice, every slice
   equal to the one-plan CSR, its host halo decode and plans timed apart;
   then the text formats at ``OFFLINE_NODES``: ``ascii --to-ascii`` and
   back, ``scattered`` of an arc list whose ids go through a seeded
   64-bit bijection in shuffled order (the arcs mapped back through
   ``.ids`` equal the source's, ``.ids`` in first-appearance order, the
   native parse rate), ``transform symmetrize`` then ``cc``, equal to the
   in-memory symmetrization's components;
10. parallel: multi-host and multi-device (``webgraph_tpu_torch/parallel``)
   at the slice's scale, in ``.parallel_smoke_*/`` under the checkout
   (removed at the end).  ``store_multihost(graph, 4, backend="cuda")`` of
   the device CSR, its ``.graph``/``.offsets`` held byte-equal (sha256) to
   the 4-thread native encode and its ``.properties`` equal bar the date
   line, read back through ``load_csr`` (B1 and B2) equal; two rank
   processes (spawn, gloo, ``file://``) sharing the card, each encoding its
   shard on the card, rank 0 merging after a barrier (held to
   ``native.bv_encode(threads=2)``, run beside them), each planning and
   decoding its shard (``plan_shard_decode``, ``decode_to_csr``: B1 and B2
   launched) and holding it to a digest of the slice's; the sharded kernel
   decode of the slice's resolved plan over the card listed once and 4
   times (B1 launched once a share, the compacted result ``torch.equal``
   to the unsharded decode); ``decode_sharded`` over the card listed twice,
   equal to the native decode.  The line gives the shard bounds, each
   timing, the ranks' process start and CUDA init, peak bytes and the
   card;
11. analytics: on the slice's device CSR (the plan freed), each step timed
   alone (host clock + synchronise, peak device bytes) and then checked
   against something independent of the code under test: stats against
   numpy bincounts of the native decode's CSR; the transpose's offsets and
   2,000 sampled predecessor lists; HyperBall at log2m 6 with the
   transpose, to convergence, every round's registers of 2,000 sampled
   nodes against a host merge of the previous round's rows (round 2 under
   the profiler); BFS from node 0 held to a distance certificate; CC of
   the symmetrized graph against scipy's weak components; SCC and its
   buckets against scipy's strong components; harmonic centrality of 32
   seeded sources on the packed path, 4 of them against sums over
   certified BFS distances; and the dense, systolic/local and external
   HyperBall modes on the 20,000-node check graph, register- and
   NF-equal.  Every HyperBall round launches ``hyperball_merge`` once (a
   sparse round with no node listed none), which the line records per
   round; the other analytics launch no hand-written kernel (torch ops
   only): the line reads the counts, reset just before;
12. big: a graph past 2^31 arcs (2^27 nodes, about 2.28G arcs, a stream
   past 2^32 bits), generated on the card and encoded on every host
   thread in node ranges of 2^24, joined by ``merge_shards``, decoded by
   ``decode_big_slices`` in slices of 2^27 arcs -- launch counts reset
   before each slice, B1 and B2 launched in every one, each slice equal
   to the generator on the kernel route -- then the whole basename through
   ``load_csr``, equal to the generator or raising before any launch.

Then one JSON line of the kernels (the seven main-path kernels and the 23
probe sites, each with its launches, times, bound and library time; the
merge's at log2m 6 and bound by each row read once; the estimate's times
at a dense round's changed rows of the slice, its launches those of the
analytics phase, whose HyperBall run launches it; the EF decode's at the
slice, from the files phase; B1's split build and the split lists' merge
at Graph500's graph, from the hubs phase), and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without a CUDA device it fails before doing anything.

Usage: ``python3 chip_smoke.py``; it needs one CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from webgraph_tpu_torch import native, require_cuda  # noqa: E402
from webgraph_tpu_torch.settings import BVGraphSettings  # noqa: E402
from webgraph_tpu_torch.settings import CompressionFlags as C  # noqa: E402
from webgraph_tpu_torch.utils.synth import synthesize_webgraph  # noqa: E402
from webgraph_tpu_torch import algo as A  # noqa: E402
from webgraph_tpu_torch import labelling as LB  # noqa: E402
from webgraph_tpu_torch import transform as TR  # noqa: E402
from webgraph_tpu_torch.algo import centrality as CE  # noqa: E402
from webgraph_tpu_torch.algo import hyperball as HB  # noqa: E402
from webgraph_tpu_torch.codecs.bvgraph import BVGraph  # noqa: E402
from webgraph_tpu_torch.codecs.efgraph import EFGraph  # noqa: E402
from webgraph_tpu_torch.core.graph import CSRGraph, expand_ranges  # noqa
from webgraph_tpu_torch.core.graph import load_csr  # noqa: E402
from webgraph_tpu_torch.labelling.graph import filter_labelled  # noqa
from webgraph_tpu_torch.utils.stats import compute_stats  # noqa: E402
from webgraph_tpu_torch.experiments import common as PC  # noqa: E402
from webgraph_tpu_torch.ops import _build, kcompact, kdecode, kplan  # noqa
from webgraph_tpu_torch.ops import vencode  # noqa: E402
from webgraph_tpu_torch.ops.csr import decode_to_csr  # noqa: E402
from webgraph_tpu_torch.ops.efdecode import EFDevicePlan  # noqa: E402
from webgraph_tpu_torch.ops.resolve import resolve_halos  # noqa: E402

KERNELS = {
    "bv_decode_lanes": dict(source="webgraph_tpu_torch/csrc/bv_decode.cu",
                            replaces="webgraph_tpu/ops/kdecode.py:1114"),
    # B1 built with its preset lanes, which plans with split lists launch
    "bv_decode_lanes_split": dict(
        source="webgraph_tpu_torch/csrc/bv_decode_split.cu",
        replaces="webgraph_tpu/ops/kdecode.py:1114 (its preset lanes)"),
    "split_merge": dict(source="webgraph_tpu_torch/csrc/bv_decode.cu",
                        replaces="none (webgraph_tpu/ops/kdecode.py:2212, "
                        "finalize_hub, is an XLA program)"),
    "compact_runs": dict(source="webgraph_tpu_torch/csrc/compact.cu",
                         replaces="webgraph_tpu/ops/kcompact.py:125"),
    "hyperball_merge": dict(source="webgraph_tpu_torch/csrc/hyperball.cu",
                            replaces="none (webgraph_tpu/algo/hyperball.py:"
                            "296, device_round, is an XLA program)"),
    "hyperball_estimate": dict(
        source="webgraph_tpu_torch/csrc/hyperball.cu",
        replaces="none (webgraph_tpu/algo/hyperball.py:84, "
        "estimate_counts, is numpy)"),
    "ef_decode": dict(source="webgraph_tpu_torch/csrc/ef_decode.cu",
                      replaces="none (webgraph_tpu/ops/efdecode.py:102, "
                      "_ef_decode_device, is an XLA program)"),
}
# the kernels every decode to a CSR launches (B1, B2)
DECODE_KERNELS = ("bv_decode_lanes", "compact_runs")
# the kernels the slice's main path launches (the EF decode runs in files)
SLICE_KERNELS = (*DECODE_KERNELS, "hyperball_merge")
# the H100 SXM's published peaks (NVIDIA H100 datasheet): device memory
# rate, and float32 outside the tensor cores, the rate at which the probes'
# integer steps are counted
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the probe modules, in the order the probes phase runs them
PROBE_MODULES = ("probe", "probe2", "probe3", "probe4", "probe16", "probe5",
                 "probe6", "probe7", "probe8", "probe9", "probe10", "probe11",
                 "probe12", "probe13", "probe14", "probe15", "probe17")
_CS = "webgraph_tpu_torch/csrc/"
PROBE_SITES = _build.PROBE_SITES   # site: (kernel source, replaced site)
SLICE_NODES = 18_500_000   # uk-2002: 18.52M nodes (BASELINE.md)
CHECK_NODES = 20_000
CHECK_SETTINGS = {
    "default": BVGraphSettings(),
    "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
    "delta_w4_int2": BVGraphSettings(outdegree_coding=C.DELTA, window_size=4,
                                     min_interval_length=2),
    "gamma_res": BVGraphSettings(residual_coding=C.GAMMA),
}
LOG2M = 4
# the analytics phase: HyperBall at the JAX class's default log2m
# (webgraph_tpu/algo/hyperball.py:368); nodes whose lists or registers are
# checked on the host; centrality sources, and how many are held to a BFS
HB_LOG2M = 6
SAMPLE = 2000
CENTRALITY_SOURCES = 32
CENTRALITY_CHECKED = 4
# the encode phase's offline transforms and the cli phase's text formats: a
# smaller graph cut into this many batches or more; the files phase's
# comparison of the EF numpy store (on the host, ~100 s at the slice) with
# the device store runs at OFFLINE_NODES too, so that the whole script
# stays inside its time limit
OFFLINE_NODES = 500_000
OFFLINE_BATCHES = 5
# the labels phase: the geometric distribution of the gamma-coded labels
# (P(v) = p (1 - p)**v, mean 4), the fixed labels its filter keeps, the
# subgraph the labelled compose joins, and the nodes checked on the host
LABEL_GEOMETRIC_P = 0.2
LABEL_KEEP_BELOW = 500
COMPOSE_NODES = 100_000
COMPOSE_SAMPLE = 300
# the labels phase's list labels: FixedWidthIntListLabel("A", 20), as
# anchor-text word ids; each arc's length geometric(p = 0.5) - 1 (mean 1,
# half the lists empty), its entries a seeded hash of (source, target, j)
# mod 2^20; the list predicate keeps the arcs whose list holds an entry
# below 2^10; iter_labelled is checked on 1,000 nodes in 4 windows
LIST_WIDTH = 20
LIST_GEOMETRIC_P = 0.5
LIST_SEED = 29
LIST_KEEP_BELOW = 1 << 10
LIST_ITER_NODES = 1000
LIST_ITER_WINDOWS = 4
# the hash of the list entries and of the big phase's graph: splitmix64's
# finaliser on int64, the multipliers as signed int64
K_X = -7046029254386353131      # 0x9E3779B97F4A7C15
K_J = 7150378442421005337       # 0x633B3F4F1E1D6C19
K_1 = -4658895280553007687      # 0xBF58476D1CE4E5B9
K_2 = -7723592293110705685      # 0x94D049BB133111EB
M62 = (1 << 62) - 1


# host-clock seconds from one line to the next: each phase's wall time,
# given in the total line
_WALL = {"last": time.perf_counter(), "lines": {}}


def emit(tag: str, obj) -> None:
    now = time.perf_counter()
    _WALL["lines"][tag] = now - _WALL["last"]
    _WALL["last"] = now
    print(f"{tag} {json.dumps(obj)}", flush=True)


def cuda_ms(fn, reps: int = 1, warmup: int = 0) -> float:
    """Device time of ``fn`` (CUDA events around ``reps`` calls after
    ``warmup`` untimed ones), in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, ops: float = 0.0) -> tuple:
    """(least ms the card could take, what sets it): bytes over the memory
    rate against operations over the peak rate, the larger."""
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = ops / PEAK_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int64 copies of 2^26 elements at a time."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 26
    return max((int((a[i:i + step].to(torch.int64)
                     - b[i:i + step].to(torch.int64)).abs().max())
                for i in range(0, a.numel(), step)), default=0)


class Errors:
    """Largest kernel-vs-plain difference seen per kernel (must stay 0:
    every value is an integer, so the tolerance is exact equality)."""

    def __init__(self):
        self.err = {k: 0 for k in (*KERNELS, *PROBE_SITES)}

    def check(self, name: str, what: str, a, b) -> None:
        e = max_abs_diff(a, b)
        self.err[name] = max(self.err[name], e)
        if e:
            raise AssertionError(f"{name} != plain on {what}: max abs {e}")


def phase_device() -> tuple:
    """(the device, the card's name and power limit as nvidia-smi gives
    them)."""
    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    emit("device", dict(name=torch.cuda.get_device_name(0),
                        count=torch.cuda.device_count(),
                        torch=torch.__version__, cuda=torch.version.cuda))
    print(smi[0], flush=True)
    return dev, smi[0]


def phase_build() -> dict:
    """Build both libraries; returns ptxas's report of the main-path
    kernels (registers, stack frame, spills)."""
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib_path()
    gxx_s = time.perf_counter() - t0
    ptxas = {k: v for k, v in _build.PTXAS.items()
             if any(name in k for name in KERNELS)}
    emit("build", dict(nvcc_s=nvcc_s, gxx_s=gxx_s, dir=_build.BUILD_DIR,
                       ptxas=ptxas))
    return ptxas


def _decode_vs_plain(plan, errors: Errors, what: str,
                     name: str = "bv_decode_lanes", order=None):
    """B1 (the build ``name``) on the card against its plain version, same
    store image, the kernel's threads taking the lanes in ``order``.  A
    decode's output depends on the halo rows and the stream only, never on
    what the chunk rows held before, so both start from one image.
    Returns (kernel ms, plain ms, diag)."""
    store_p = plan.store.clone()
    out = {}

    def kernel():
        out["k"] = kdecode.decode_lanes(plan.words, plan.meta, plan.store,
                                        plan.spec, order)

    def plain():
        out["p"] = kdecode.decode_lanes_plain(plan.words, plan.meta, store_p,
                                              plan.spec)

    ms = cuda_ms(kernel, warmup=1)
    plain_ms = cuda_ms(plain)
    errors.check(name, f"{what} store", plan.store, store_p)
    errors.check(name, f"{what} diag", out["k"], out["p"])
    return ms, plain_ms, out["k"]


def _compact_vs_plain(dev, errors: Errors, what: str, arcs, gap,
                      valid) -> dict:
    """B2 on the card against its plain version on one run table: runs of
    ``arcs`` arcs, each after ``gap`` store words; valid positions only."""
    R = len(arcs)
    arc_start = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(arcs, out=arc_start[1:])
    seg = arcs + gap
    src0 = np.cumsum(seg) - arcs
    m = int(arc_start[-1])
    store = torch.randint(-(1 << 31), 1 << 31, (int(seg.sum()),),
                          dtype=torch.int32, device=dev)
    cp = kcompact.plan_compact(arc_start, src0, valid, m, device=dev)
    got = kcompact.compact(cp, store)
    ms = cuda_ms(lambda: kcompact.compact(cp, store), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: kcompact.compact_plain(cp, store))
    exp = kcompact.compact_plain(cp, store)
    vmask = torch.from_numpy(np.repeat(valid, arcs)).to(dev)
    errors.check("compact_runs", what, got[vmask], exp[vmask])
    pairs = len(set(zip((arc_start[:-1] % 4).tolist(), (src0 % 4).tolist())))
    return dict(setting=what, runs=R, arcs=m, invalid=int((~valid).sum()),
                alignment_pairs=pairs, ms=ms, plain_ms=plain_ms)


def phase_kernels(dev, errors: Errors) -> None:
    """B1 on a small synthetic under every check setting (and a garbled
    stream) and B2 on random run tables, each against its plain version.
    ``main`` runs it beside the slice's synthetic encode on the host, so
    each row names that load (``timed_beside``)."""
    co, su = synthesize_webgraph(CHECK_NODES, seed=3)
    n = CHECK_NODES
    rows = []
    for name, s in CHECK_SETTINGS.items():
        graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=8)
        offsets = native.decode_offset_stream(offs, n, s.offset_coding)
        outd = np.diff(co)
        for garbled in ((False, True) if name == "default" else (False,)):
            data = graph.copy()
            if garbled:
                data[len(data) // 2:] = 0xFF
            plan = kplan.plan_kernel_decode(offsets, outd, s, data,
                                            device=dev, halo_csr=(co, su))
            tag = name + ("_garbled" if garbled else "")
            ms, plain_ms, diag = _decode_vs_plain(plan, errors, tag)
            errs = kdecode.check_diag(plan, diag)
            if garbled:
                if not errs.any():
                    raise AssertionError("garbled stream raised no flag")
            else:
                if errs.any():
                    raise AssertionError(f"{tag}: lanes flagged on a clean "
                                         f"stream: {np.unique(errs)}")
                _, succ, filled = decode_to_csr(plan)
                if filled or not np.array_equal(succ.cpu().numpy(), su):
                    raise AssertionError(f"{tag}: CSR differs from the graph")
            rows.append(dict(setting=tag, lanes=plan.lanes, arcs=plan.m,
                             flagged=int((errs != 0).sum()), ms=ms,
                             plain_ms=plain_ms))

    # B2 on random run tables with empty and invalid runs, and on runs of
    # 1-7 arcs at every source alignment (the 16-byte path meets a run
    # boundary in nearly every vector)
    rng = np.random.default_rng(7)
    R = 1 << 16
    arcs = rng.integers(0, 600, size=R)
    arcs[rng.random(R) < 0.1] = 0
    rows.append(_compact_vs_plain(dev, errors, "compact_random", arcs,
                                  rng.integers(0, 64, size=R),
                                  rng.random(R) >= 0.3))
    short = rng.integers(1, 8, size=R)
    rows.append(_compact_vs_plain(dev, errors, "compact_short_runs", short,
                                  rng.integers(0, 4, size=R),
                                  np.ones(R, bool)))
    beside = "the slice's synthetic made and encoded on every host core"
    emit("kernels", [dict(r, timed_beside=beside) for r in rows])


def phase_probes(dev, errors: Errors) -> dict:
    """The probe path: every case of every probe module, launch counts
    reset just before and read just after.  Returns per site its launches,
    summed kernel and plain ms and the number of cases."""
    mods = [importlib.import_module(f"webgraph_tpu_torch.experiments.{m}")
            for m in PROBE_MODULES]
    rng = np.random.default_rng(0)
    cases = [c for m in mods for c in m.cases(dev, rng)]
    _build.reset_launches()
    rows = PC.run_cases(cases)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in PROBE_SITES}
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the probe path never launched {k}")
    lines = []
    for r in rows:
        lines.append(dict(site=r.site, name=r.name.strip(), ms=r.ms,
                          floor_ms=r.floor_ms, plain_ms=r.plain_ms,
                          steps=r.steps,
                          checked_steps=r.checked_steps,
                          ns_per_step=r.ns_per_step, lanes=r.lanes,
                          tiles=r.tiles, max_abs_err=r.max_abs_err))
        errors.err[r.site] = max(errors.err[r.site], r.max_abs_err)
    emit("probes", lines)
    bad = [r.name for r in rows if not r.ok]
    if bad:
        raise AssertionError(f"probe kernels differ from their plain "
                             f"versions: {bad}")
    per_site = {k: dict(launches=v, ms=0.0, plain_ms=0.0, cases=0,
                        bound_ms=0.0, bytes=0, ops=0)
                for k, v in launches.items()}
    for c, r in zip(cases, rows):
        d = per_site[r.site]
        d["ms"] += r.ms
        d["plain_ms"] += r.plain_ms
        d["cases"] += 1
        # inputs read once, an output of the same size written once; at
        # least one operation a lane a step
        nb = 2 * sum(a.numel() * a.element_size() for a in c.args
                     if isinstance(a, torch.Tensor))
        ops = max(c.steps or 1, 1) * c.lanes
        d["bytes"] += nb
        d["ops"] += ops
        d["bound_ms"] += bound(nb, ops)[0]
    for d in per_site.values():
        d["bound_by"] = bound(d["bytes"], d["ops"])[1]
    return per_site


def synth_input(n_nodes: int):
    """The encoded synthetic graph, cached in .bench_synth_<N>.npz (the
    format the root ``bench_synth.py`` writes)."""
    settings = BVGraphSettings()
    cache = os.path.join(ROOT, f".bench_synth_{n_nodes}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        z = np.load(cache)
        data, offsets = z["data"], z["offsets"]
        n, m = int(z["n"]), int(z["m"])
        src = "cache"
    else:
        co, su = synthesize_webgraph(n_nodes)
        n, m = n_nodes, int(co[-1])
        graph, gbits, offs, _ob, _st = native.bv_encode(
            co, su, settings, threads=os.cpu_count() or 1)
        del co, su
        offsets = native.decode_offset_stream(offs, n,
                                              settings.offset_coding)
        data = graph
        np.savez(cache, data=data, offsets=offsets, n=n, m=m, gbits=gbits)
        src = "generated"
    return data, offsets, n, m, settings, src, time.perf_counter() - t0


def merge_bytes(arcs: int, k: int, rows: int, row: int, id_bytes: int,
                off_bytes: int) -> dict:
    """Bytes of a HyperBall merge of k listed nodes over ``arcs`` arcs that
    touches ``rows`` distinct register rows of ``row`` bytes, counted two
    ways: every gathered row read from device memory, or each row once
    (with the rows out, the changed flags, the ids and the offsets)."""
    fixed = k * (row + 1) + off_bytes + arcs * id_bytes
    return dict(gathered=fixed + (arcs + k) * row, once=fixed + rows * row)


def _merge_vs_plain(g, regs, errors: Errors, what: str, nodes=None,
                    succ=None) -> dict:
    """``merge_rows`` held whole against ``merge_rows_plain`` on one input
    (every row and every changed flag), both timed by CUDA events, with
    the bytes that bound the kernel (``merge_bytes``)."""
    off, dev = g.offsets, regs.device
    succ = g.succ if succ is None else succ
    got, got_ch = HB.merge_rows(off, succ, regs, nodes)
    exp, exp_ch = HB.merge_rows_plain(off, succ, regs, nodes)
    errors.check("hyperball_merge", f"{what} rows", got, exp)
    errors.check("hyperball_merge", f"{what} changed", got_ch, exp_ch)
    changed = int(got_ch.sum())
    del got, got_ch, exp, exp_ch
    ms = min(cuda_ms(lambda: HB.merge_rows(off, succ, regs, nodes), reps=5,
                     warmup=1) for _ in range(3))
    plain_ms = cuda_ms(lambda: HB.merge_rows_plain(off, succ, regs, nodes),
                       warmup=1)
    n, row = regs.shape
    if nodes is None:
        k, arcs, rows, off_bytes = n, succ.numel(), n, (n + 1) * 8
        longest = int((off[1:] - off[:-1]).max())
    else:
        lo = off[nodes]
        cnt = off[nodes + 1] - lo
        k, arcs, longest = nodes.numel(), int(cnt.sum()), int(cnt.max())
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        seen[succ[expand_ranges(lo, cnt, dev)].to(torch.int64)] = True
        seen[nodes] = True
        rows, off_bytes = int(seen.sum()), k * 24
        del lo, cnt, seen
    nb = merge_bytes(arcs, k, rows, row, succ.element_size(), off_bytes)
    return dict(nodes=k, arcs=arcs, longest_list=longest, rows=rows,
                log2m=row.bit_length() - 1, id_bytes=succ.element_size(),
                changed=changed, ms=ms, plain_ms=plain_ms, bytes=nb,
                bound_ms={a: bound(b)[0] for a, b in nb.items()})


def _slice_merge(g, regs0, regs1, errors: Errors) -> dict:
    """HyperBall's merge at the slice's shape: the main path's round
    (``regs1``, log2m ``LOG2M``) and dense and sparse merges at log2m
    ``HB_LOG2M``, the sparse list one node in ten and the longest list,
    with int32 and int64 ids, each held whole against the plain twin; the
    library path (the gather and ``scatter_reduce_`` the round ran before
    the kernel, over a source index built once) timed and held equal."""
    dev = regs0.device
    n = regs0.shape[0]
    want, _ = HB.merge_rows_plain(g.offsets, g.succ, regs0)
    errors.check("hyperball_merge", "the main path's round", regs1, want)
    del want
    regs = HB.hyperloglog_init_device(n, HB_LOG2M, 1, dev)
    out = dict(dense=_merge_vs_plain(g, regs, errors, "dense"))
    gen = torch.Generator(device=dev).manual_seed(3)
    pick = torch.rand(n, device=dev, generator=gen) < 0.1
    pick[torch.argmax(g.offsets[1:] - g.offsets[:-1])] = True
    nodes = torch.nonzero(pick).squeeze(1)
    del pick
    out["sparse"] = _merge_vs_plain(g, regs, errors, "sparse", nodes)
    succ64 = g.succ.to(torch.int64)
    out["sparse_int64_ids"] = _merge_vs_plain(g, regs, errors,
                                              "sparse, int64 ids", nodes,
                                              succ64)
    del succ64, nodes
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        g.offsets[1:] - g.offsets[:-1], output_size=g.num_arcs)

    def library():
        return HB._scatter_max_rows(regs.clone(), src, regs, g.succ)

    if not torch.equal(library(), HB.merge_rows(g.offsets, g.succ, regs)[0]):
        raise AssertionError("the library path differs from hyperball_merge")
    out["library_ms"] = min(cuda_ms(library) for _ in range(2))
    del src
    new, ch = HB.merge_rows(g.offsets, g.succ, regs)
    del regs
    torch.cuda.empty_cache()
    out["estimate"] = _slice_estimate(new, torch.nonzero(ch).squeeze(1),
                                      errors)
    del new, ch
    torch.cuda.empty_cache()
    return out


def _slice_estimate(regs, nodes, errors: Errors) -> dict:
    """HyperBall's count estimate (``estimate_rows``, one launch of
    ``hyperball_estimate``) of a round's changed rows and of every row,
    held whole against ``estimate_rows_plain``: every count bit for bit
    (the float64 patterns' difference as int64).  Timed on the changed rows
    by CUDA events beside its bound (the row, its id and its count read or
    written once), the plain twin (host clock) and one
    ``estimate_counts_device`` call over the gathered rows (the library
    path of the rounds before the kernel)."""
    before = _build.LAUNCHES["hyperball_estimate"]   # the checks' own
    for what, nd in (("a round's changed rows", nodes), ("every row", None)):
        got = HB.estimate_rows(regs, nd)
        exp = HB.estimate_rows_plain(regs, nd)
        errors.check("hyperball_estimate", what, got.view(torch.int64),
                     exp.view(torch.int64))
    del got, exp
    launches = _build.LAUNCHES["hyperball_estimate"] - before
    if launches != 2:
        raise AssertionError(f"two estimates launched {launches} kernels")
    ms = min(cuda_ms(lambda: HB.estimate_rows(regs, nodes), reps=5,
                     warmup=1) for _ in range(3))
    HB.estimate_rows_plain(regs, nodes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    HB.estimate_rows_plain(regs, nodes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    library_ms = min(cuda_ms(lambda: HB.estimate_counts_device(regs[nodes]))
                     for _ in range(2))
    k, row = nodes.numel(), regs.shape[1]
    nbytes = k * (row + 16)
    return dict(rows=k, log2m=row.bit_length() - 1, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, bound=bound(nbytes))


def phase_slice(dev, errors: Errors, n_nodes: int) -> tuple:
    """The main path at ``n_nodes``.  Returns (the device CSR graph and the
    native decode's host CSR, for the analytics; the slice's numbers)."""
    data, offsets, n, m, settings, src, input_s = synth_input(n_nodes)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, launch counts reset just before ----
    _build.reset_launches()
    t0 = time.perf_counter()
    outd = native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    plan = kplan.plan_kernel_decode(offsets, outd, settings, data,
                                    device=dev)
    if plan is None or not plan.cold:
        raise AssertionError("no cold plan for the default settings")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    passes = resolve_halos(plan)
    torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    co, succ, filled = decode_to_csr(plan)
    torch.cuda.synchronize()
    first_csr_s = time.perf_counter() - t0
    g = CSRGraph.from_decoded(co, succ)
    regs0 = torch.from_numpy(HB.hyperloglog_init(n, LOG2M, seed=1)).to(dev)
    regs1 = HB.device_round(g.offsets, g.succ, regs0)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    peak_main = torch.cuda.max_memory_allocated()
    for k in SLICE_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"the main path never launched {k}")
    if _build.LAUNCHES["hyperball_merge"] != 1:
        raise AssertionError("the HyperBall round did not launch its merge")

    # ---- timings (steady state: a resolved plan) ----
    decode_ms = min(cuda_ms(lambda: kdecode.decode_chunked(plan))
                    for _ in range(3))
    csr_times = []
    for _ in range(3):
        again = None
        t0 = time.perf_counter()
        _, again, _ = decode_to_csr(plan)
        torch.cuda.synchronize()
        csr_times.append(time.perf_counter() - t0)
    csr_s = min(csr_times)
    del again, succ
    hb_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = HB.device_round(g.offsets, g.succ, regs0)
        torch.cuda.synchronize()
        hb_times.append(time.perf_counter() - t0)
        del r
    hb_s = min(hb_times)
    compact_ms = min(cuda_ms(lambda: kcompact.compact(plan.compact_plan,
                                                      plan.store))
                     for _ in range(3))
    lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs

    # ---- B1 on this slice: steps per arc, the slowest lane alone ----
    diag0 = kdecode.decode_chunked(plan)
    lane_steps = diag0[:, kdecode.DIAG_STEPS].to(torch.int64)
    slow = int(torch.argmax(lane_steps))
    one = plan.meta[slow:slow + 1]
    alone_ms = min(cuda_ms(lambda: kdecode.decode_lanes(
        plan.words, one, plan.store, plan.spec)) for _ in range(3))
    b1 = dict(steps_per_arc=int(lane_steps.sum()) / m,
              slowest_lane=slow, slowest_lane_steps=int(lane_steps[slow]),
              slowest_lane_arcs=int(lane_arcs[slow]),
              slowest_lane_alone_ms=alone_ms)
    decode_to_csr(plan)   # one call unprofiled, then one under the profiler
    profile = profile_window(lambda: decode_to_csr(plan))
    b1_bytes = (plan.words.numel() * 4 + plan.meta.numel() * 8
                + 4 * (int(plan.halo_arcs.sum()) + m)
                + 4 * kdecode.DIAG_ROWS * plan.lanes)
    cp = plan.compact_plan
    b2_bytes = 8 * m + sum(t.numel() * t.element_size() for t in (
        cp.arc_start, cp.src0, cp.valid, cp.tile_run0))
    # one library call for B2's function: a gather over a source index
    # built once, outside the timing
    src_idx = expand_ranges(cp.src0, cp.arc_start[1:] - cp.arc_start[:-1], dev)
    library_ms = min(cuda_ms(lambda: torch.index_select(plan.store, 0,
                                                         src_idx))
                     for _ in range(3))
    csr_k = kcompact.compact(cp, plan.store)
    if not torch.equal(torch.index_select(plan.store, 0, src_idx), csr_k):
        raise AssertionError("index_select differs from compact_runs")
    del src_idx
    # the card's rate for B2's bytes: a device-to-device copy of m int32
    # (a reading for context, not B2's library call)
    dst = torch.empty_like(csr_k)
    copy_ms = min(cuda_ms(lambda: dst.copy_(csr_k)) for _ in range(3))
    del dst, csr_k

    # ---- B1 and B2 against their plain versions, slice shapes ----
    _, decode_plain_ms, diag = _decode_vs_plain(plan, errors, "slice")
    got = kcompact.compact(plan.compact_plan, plan.store)
    t0 = time.perf_counter()
    exp = kcompact.compact_plain(plan.compact_plan, plan.store)
    torch.cuda.synchronize()
    compact_plain_ms = (time.perf_counter() - t0) * 1e3
    errors.check("compact_runs", "slice", got, exp)
    del got, exp
    merge = _slice_merge(g, regs0, regs1, errors)

    # ---- correctness against the native sequential decoder ----
    t0 = time.perf_counter()
    hco, hsu = native.bv_decode_all(data, n, m, settings)
    host_s = time.perf_counter() - t0
    if filled or kdecode.check_diag(plan, diag).any():
        raise AssertionError("lanes flagged on a clean stream")
    if not np.array_equal(co, hco):
        raise AssertionError("CSR offsets differ from the native decode")
    succ_h = g.succ.cpu().numpy()
    if not np.array_equal(succ_h, hsu):
        bad = np.flatnonzero(succ_h != hsu)
        raise AssertionError(f"CSR differs from the native decode at "
                             f"{len(bad)} arcs, first {bad[:5]}")
    # the HyperBall round against a host merge on sampled nodes
    r0 = regs0.cpu().numpy()
    r1 = regs1.cpu().numpy()
    if r1.shape != r0.shape or (r1 < r0).any():
        raise AssertionError("HyperBall round lowered a register")
    rng = np.random.default_rng(0)
    for x in rng.integers(0, n, size=2000):
        want = r0[x].copy()
        ys = hsu[hco[x]:hco[x + 1]]
        if len(ys):
            want = np.maximum(want, r0[ys].max(axis=0))
        if not np.array_equal(r1[x], want):
            raise AssertionError(f"HyperBall registers of node {x} differ")
    est = HB.estimate_counts(r1[:100000])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite HyperBall estimates")
    del regs0, regs1, r0, r1, succ_h

    return dict(graph=g, hco=hco, hsu=hsu), dict(
        input=src, nodes=n, arcs=m, input_s=input_s,
        lanes=plan.lanes, longest_lane_arcs=int(lane_arcs.max()),
        halo_arcs=int(plan.halo_arcs.sum()), store_elems=int(
            plan.store_off[-1]),
        plan_s=plan_s, resolve_s=resolve_s, resolve_passes=passes,
        first_decode_to_csr_s=first_csr_s,
        decode_ms=decode_ms, decode_Medges_per_s=m / decode_ms / 1e3,
        decode_to_csr_s=csr_s, decode_to_csr_Medges_per_s=m / csr_s / 1e6,
        compact_ms=compact_ms, copy_ms=copy_ms, b2_bytes=b2_bytes,
        hyperball_round_s=hb_s, log2m=LOG2M,
        fallback_arc_frac=filled / max(m, 1),
        host_decode_s=host_s, host_decode_Medges_per_s=m / host_s / 1e6,
        peak_main_path_bytes=peak_main,
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, decode_plain_ms=decode_plain_ms,
        compact_plain_ms=compact_plain_ms, b1=b1, profile=profile,
        hyperball_merge=merge,
        bounds={"bv_decode_lanes": bound(b1_bytes),
                "compact_runs": bound(b2_bytes),
                "hyperball_merge": bound(merge["dense"]["bytes"]["once"]),
                "hyperball_estimate": merge["estimate"]["bound"]},
        library_ms={"bv_decode_lanes": None, "compact_runs": library_ms,
                    "hyperball_merge": merge["library_ms"],
                    "hyperball_estimate": merge["estimate"]["library_ms"]},
        bit_exact=True)


# ---- the hubs phase: B1's lanes on a graph with hub nodes ---------------

# a synthetic whose nodes HUB_IDS get sorted, distinct, seeded-random lists
# of HUB_DEGREES successors
HUB_NODES = 1_000_000
HUB_IDS = (0, 250_000, 500_000, 750_000)
HUB_DEGREES = (131_072, 262_144, 524_288, 786_432)
HUB_SEED = 13
# then Graph500's scale-24 Kronecker graph (the benchmark's generator and
# configuration), made on the card from this seed: thousands of split lists
GRAPH500_CONFIG = os.path.join(ROOT, "benchmark", "configs",
                               "graph500-s24.json")
GRAPH500_SEED = 1


def hub_graph(n: int, ids, degrees, seed: int) -> tuple:
    """``synthesize_webgraph(n)`` with the lists of nodes ``ids`` (ascending)
    replaced by sorted, distinct, seeded-random lists of ``degrees``
    successors: (offsets, successors), int64."""
    co, su = synthesize_webgraph(n)
    rng = np.random.default_rng(seed)
    deg = np.diff(co)
    parts, prev = [], 0
    for x, d in zip(ids, degrees):
        parts += [su[co[prev]:co[x]],
                  np.sort(rng.choice(n, size=d, replace=False))]
        deg[x] = d
        prev = x + 1
    parts.append(su[co[prev]:])
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=out[1:])
    return out, np.concatenate(parts).astype(np.int64)


def _store_single_stream(co, su, base: str) -> None:
    """Store (co, su) as a BVGraph basename in one stream (one thread), so
    that its lanes depend on the graph alone and not on the host's
    threads."""
    n = len(co) - 1
    if int(su.max(initial=-1)) >= n or (np.diff(su) <= 0)[
            np.diff(np.repeat(np.arange(n), np.diff(co))) == 0].any():
        raise AssertionError("a stored list is not ascending below n")
    BVGraph.store(CSRGraph(co, su, device="cpu"), base, num_threads=1)


def _hub_lanes(dev, basename: str, co, su) -> dict:
    """The hub graph planned cold (each hub split across preset lanes,
    ``kplan.SPLIT_ARCS``) and decoded, held equal to (co, su); the slowest
    lane of the lane table (by B1's steps) and each hub's lanes (its head
    lane and its preset lanes) launched alone, the whole B1 pass (with the
    split lists' merge) and the pass without the hubs' lanes timed by CUDA
    events.  ``hub_share``: the part of the whole pass the hubs' lanes add,
    1 - rest / whole."""
    bv = BVGraph.load(basename)
    data = np.asarray(bv.data)
    outd = native.decode_outdegrees(data, bv.offsets,
                                    bv.settings.outdegree_coding)
    plan = kplan.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                    device=dev)
    sp = plan.split
    if sp is None or sorted(sp.nodes.tolist()) != sorted(HUB_IDS):
        raise AssertionError("the plan does not split the hub lists")
    resolve_halos(plan)
    csr_off, succ, filled = decode_to_csr(plan)
    if (filled or not np.array_equal(csr_off, co)
            or not np.array_equal(succ.cpu().numpy(), su)):
        raise AssertionError("the hub graph's decode differs from its CSR")
    del succ
    L = plan.lanes
    lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs
    steps = kdecode.decode_chunked(plan)[:, kdecode.DIAG_STEPS].cpu().numpy()
    whole_ms = min(cuda_ms(lambda: kdecode.decode_chunked(plan))
                   for _ in range(3))

    def alone(rows):
        meta = plan.meta[torch.from_numpy(np.asarray(rows)).to(dev)]
        return cuda_ms(lambda: kdecode.decode_lanes(plan.words, meta,
                                                    plan.store, plan.spec),
                       warmup=1)
    slow = int(np.argmax(steps))
    lanes = []
    hub_rows = []
    for x, d in zip(HUB_IDS, HUB_DEGREES):
        head = int(sp.heads[sp.nodes == x][0])
        pre = L + np.flatnonzero(sp.seg_head == head)
        rows = [head, *pre.tolist()]
        hub_rows += rows
        lanes.append(dict(node=x, degree=d, lane=head,
                          preset_lanes=len(pre),
                          residuals=int(sp.res[sp.nodes == x][0]),
                          head_steps=int(steps[head]),
                          longest_preset_steps=int(steps[pre].max()),
                          lanes_alone_ms=alone(rows)))
    # every other lane, in the plan's order (costliest first)
    keep = np.ones(plan.meta.shape[0], dtype=bool)
    keep[hub_rows] = False
    order = plan.order.cpu().numpy()
    new = np.cumsum(keep) - 1
    rest_order = torch.from_numpy(
        new[order[keep[order]]].astype(np.int32)).to(dev)
    rest_meta = plan.meta[torch.from_numpy(keep).to(dev)]
    rest_ms = min(cuda_ms(lambda: kdecode.decode_lanes(
        plan.words, rest_meta, plan.store, plan.spec, rest_order),
        warmup=1) for _ in range(3))
    slowest_ms = alone([slow])
    merge_ms = cuda_ms(lambda: kdecode.merge_split(sp, plan.store))
    out = dict(lanes=L, preset_lanes=sp.segments, merged_lists=sp.merged,
               longest_lane_arcs=int(lane_arcs.max()),
               slowest_lane=slow, slowest_lane_is_preset=slow >= L,
               slowest_lane_steps=int(steps[slow]),
               slowest_lane_alone_ms=slowest_ms,
               slowest_lane_share=slowest_ms / whole_ms,
               whole_ms=whole_ms, merge_ms=merge_ms, rest_ms=rest_ms,
               hubs=lanes,
               hub_share=1 - rest_ms / whole_ms)
    del plan, rest_meta, rest_order
    torch.cuda.empty_cache()
    return out


def _graph500_split(dev, errors: Errors) -> dict:
    """Graph500's Kronecker graph (``GRAPH500_CONFIG`` at
    ``GRAPH500_SEED``), encoded on the card into one stream, planned cold
    (thousands of lists split) and resolved.  One ``decode_to_csr`` with
    the launch counts reset just before, held equal to the graph; then B1's
    split build against ``decode_lanes_plain`` (store and diagnostics) and
    the merge against ``merge_split_plain`` (the store after B1), each timed
    by CUDA events beside its byte bound: B1's as the slice's, the merge's
    16 B a merged row (read, written to the buffer, read back, written)."""
    from benchmark.gen import kronecker
    with open(GRAPH500_CONFIG) as f:
        cfg = json.load(f)
    s = BVGraphSettings(**cfg["bvgraph"])
    t0 = time.perf_counter()
    off, succ = kronecker.generate(cfg["params"], GRAPH500_SEED, dev)
    stream, bits, starts, _ = vencode.encode_csr_chunked(off, succ, s)
    offsets = np.empty(off.numel(), dtype=np.int64)
    offsets[:-1] = starts.cpu().numpy()
    offsets[-1] = bits
    data = np.frombuffer(stream, dtype=np.uint8)
    del starts, stream
    outd = native.decode_outdegrees(data, offsets, s.outdegree_coding)
    plan = kplan.plan_kernel_decode(offsets, outd, s, data, device=dev)
    sp = plan.split
    if sp is None or not sp.merged:
        raise AssertionError("Graph500's plan splits no list to merge")
    resolve_halos(plan)
    made_s = time.perf_counter() - t0
    _build.reset_launches()
    co, got, filled = decode_to_csr(plan)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(bv_decode_lanes_split=1, split_merge=2, compact_runs=1)
    if launches != want:
        raise AssertionError(f"a Graph500 decode launched {launches}")
    if (filled or not np.array_equal(co, off.cpu().numpy())
            or not torch.equal(got, succ)):
        raise AssertionError("Graph500's decode differs from its CSR")
    m = succ.numel()
    del got, succ, off
    ms, plain_ms, diag = _decode_vs_plain(
        plan, errors, "graph500", name="bv_decode_lanes_split",
        order=plan.order)
    if kdecode.check_diag(plan, diag).any():
        raise AssertionError("Graph500's lanes flagged on a clean stream")
    steps = diag[:, kdecode.DIAG_STEPS].cpu().numpy()
    b1_bytes = (plan.words.numel() * 4 + plan.meta.numel() * 8
                + 4 * (int(plan.halo_arcs.sum()) + m)
                + 4 * kdecode.DIAG_ROWS * plan.meta.shape[0])
    store_p = plan.store.clone()
    kdecode.merge_split(sp, plan.store)
    t0 = time.perf_counter()
    kdecode.merge_split_plain(store_p, sp.merge_row0, sp.merge_res,
                              sp.merge_base)
    torch.cuda.synchronize()
    merge_plain_ms = (time.perf_counter() - t0) * 1e3
    errors.check("split_merge", "graph500 store", plan.store, store_p)
    del store_p
    # on merged rows the merge does the same searches and moves
    merge_ms = min(cuda_ms(lambda: kdecode.merge_split(sp, plan.store),
                           reps=5, warmup=1) for _ in range(3))
    L = plan.lanes
    heads = sp.heads
    out = dict(seed=GRAPH500_SEED, nodes=len(outd), arcs=m, made_s=made_s,
               lanes=L, split_lists=len(sp.nodes), preset_lanes=sp.segments,
               merged_lists=sp.merged, merged_rows=sp.merge_rows,
               launches=launches, max_lane_steps=int(steps.max()),
               max_head_steps=int(steps[heads].max()),
               max_preset_steps=int(steps[L:].max()),
               b1=dict(ms=ms, plain_ms=plain_ms, bound=bound(b1_bytes)),
               merge=dict(ms=merge_ms, plain_ms=merge_plain_ms,
                          bound=bound(16 * sp.merge_rows)))
    del plan, diag
    torch.cuda.empty_cache()
    return out


def phase_hubs(dev, card: str, errors: Errors) -> dict:
    """The graph with hub nodes stored, decoded and its lanes timed (its
    directory is removed at the end); then Graph500's split lists held
    against the plain twins (``_graph500_split``)."""
    out = dict(card=card, nodes=HUB_NODES)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".hubs_smoke_", dir=ROOT)
    try:
        hub = os.path.join(tmp, "hubs")
        t0 = time.perf_counter()
        co, su = hub_graph(HUB_NODES, HUB_IDS, HUB_DEGREES, HUB_SEED)
        _store_single_stream(co, su, hub)
        out.update(arcs=int(co[-1]), store_s=time.perf_counter() - t0,
                   lanes=_hub_lanes(dev, hub, co, su))
        del co, su
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["graph500"] = _graph500_split(dev, errors)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _sizes(base: str) -> dict:
    return {ext[1:]: os.path.getsize(base + ext)
            for ext in (".graph", ".offsets", ".properties")}


def _ef_vs_plain(plan, errors: Errors) -> dict:
    """The EF decode kernel held whole against its plain twin (offsets and
    successors) on ``plan``, one launch a decode, both timed by CUDA events,
    with its byte bound: the stream read once, 4 bytes a successor and 8 a
    node's offset written once (the benchmark's ``ef_decode_bytes``)."""
    _build.reset_launches()
    off, got = plan.decode()
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["ef_decode"]
    if launches != 1:
        raise AssertionError(f"a decode launched ef_decode {launches} times")
    off_p, exp = plan.decode_plain()
    errors.check("ef_decode", "the slice's offsets", off, off_p)
    errors.check("ef_decode", "the slice's successors", got, exp)
    del off, got, off_p, exp
    ms = min(cuda_ms(plan.decode, reps=5, warmup=1) for _ in range(3))
    plain_ms = cuda_ms(plan.decode_plain)
    nbytes = plan.nwords * 8 + 4 * plan.m + 8 * plan.n
    return dict(nodes=plan.n, arcs=plan.m, launches=launches, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, bound=bound(nbytes))


def phase_files(dev, card: str, graph, hco, hsu, errors: Errors) -> dict:
    """The file layer at the slice's scale: BVGraph and EFGraph basenames
    written, read back to the card through the port's entries, and held
    equal to the slice's CSR; the EF decode kernel held against its plain
    twin.  The directory is removed at the end."""
    n, m = graph.num_nodes, graph.num_arcs
    if int(hsu.max(initial=-1)) >= n:
        raise AssertionError("a successor at or above n: no EF upper bound")
    tmp = tempfile.mkdtemp(prefix=".files_smoke_", dir=ROOT)
    try:
        bv, ef = os.path.join(tmp, "bv"), os.path.join(tmp, "ef")
        t0 = time.perf_counter()
        BVGraph.store(graph, bv)
        bv_store_s = time.perf_counter() - t0

        # BVGraph: the files to the card, launch counts reset just before
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        g = load_csr(bv)
        torch.cuda.synchronize()
        bv_total_s = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] for k in KERNELS}
        rep = g.report
        if rep["route"] != "kernel":
            raise AssertionError(f"load_csr took the {rep['route']} route")
        for k in DECODE_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"load_csr never launched {k}")
        if not (g.device == dev and torch.equal(g.offsets, graph.offsets)
                and torch.equal(g.succ, graph.succ)):
            raise AssertionError("load_csr differs from the slice's CSR")
        del g

        # EFGraph of the slice: stored by the device writer from the CSR on
        # the card, decoded on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        EFGraph.store(graph, ef, backend="cuda")
        ef_store_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        efg = EFGraph.load(ef)
        ef_load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        g = efg.to_device()
        torch.cuda.synchronize()
        ef_peak = torch.cuda.max_memory_allocated() - resident
        ef_s = g.report["ef_decode_s"]
        if g.report["route"] != "cuda":
            raise AssertionError(f"EFGraph.to_device took the "
                                 f"{g.report['route']} route")
        if not (g.device == dev and torch.equal(g.offsets, graph.offsets)
                and torch.equal(g.succ, graph.succ)):
            raise AssertionError("EFGraph.to_device differs from the "
                                 "slice's CSR")
        del g
        # where ef_decode_s goes: the plan (upload, outdegrees, arc count),
        # then decodes of the resident stream, one under the profiler
        t0 = time.perf_counter()
        plan = EFDevicePlan(efg.words, efg.offsets, efg.upper_bound,
                            efg.log2_quantum, device=dev)
        torch.cuda.synchronize()
        ef_plan_s = time.perf_counter() - t0
        ef_steady_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            plan.decode()
            torch.cuda.synchronize()
            ef_steady_s.append(time.perf_counter() - t0)
        ef_kernel = _ef_vs_plain(plan, errors)
        del plan, efg
        sizes = {"BVGraph": _sizes(bv), "EFGraph": _sizes(ef)}

        # the device writer against the numpy one at OFFLINE_NODES (the
        # numpy store takes ~100 s at the slice): the three files equal,
        # the properties bar their date line
        eco, esu = synthesize_webgraph(OFFLINE_NODES, seed=1)
        ef_np, ef_cu = os.path.join(tmp, "ef_np"), os.path.join(tmp, "ef_cu")
        t0 = time.perf_counter()
        EFGraph.store(CSRGraph(eco, esu, device="cpu"), ef_np)
        ef_np_store_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        EFGraph.store(CSRGraph(eco, esu, device=dev), ef_cu, backend="cuda")
        ef_cu_store_s = time.perf_counter() - t0
        del eco, esu
        for ext in (".graph", ".offsets"):
            with open(ef_np + ext, "rb") as fa, open(ef_cu + ext, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"the EF device store's {ext} "
                                         "differs from the numpy store's")
        if _props_lines(ef_np + ".properties") != _props_lines(
                ef_cu + ".properties"):
            raise AssertionError("the EF device store's .properties differs "
                                 "from the numpy store's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(
        card=card, nodes=n, arcs=m, sizes=sizes,
        bits_per_link={"BVGraph": sizes["BVGraph"]["graph"] * 8 / m,
                       "EFGraph": sizes["EFGraph"]["graph"] * 8 / m},
        store_s={"BVGraph": bv_store_s, "EFGraph": ef_store_s},
        ef_store_compared=dict(nodes=OFFLINE_NODES, numpy_s=ef_np_store_s,
                               cuda_s=ef_cu_store_s, files_equal=True),
        load_s={"BVGraph": rep["load_s"], "EFGraph": ef_load_s},
        route=rep["route"], plan_s=rep["plan_s"],
        resolve_s=rep["resolve_s"], resolve_passes=rep["resolve_passes"],
        decode_to_csr_s=rep["decode_to_csr_s"],
        fallback_arcs=rep["fallback_arcs"], load_csr_s=bv_total_s,
        launches=launches, ef_decode_s=ef_s,
        ef_decode_Medges_per_s=m / ef_s / 1e6,
        ef_decode_peak_bytes=ef_peak, ef_resident_bytes=resident,
        ef_plan_s=ef_plan_s, ef_resident_decode_s=min(ef_steady_s),
        ef_kernel=ef_kernel, equal_to_slice=True)


def _props_lines(path: str) -> list:
    """A .properties file's lines bar the date comment (its second line)."""
    with open(path, encoding="iso-8859-1") as f:
        lines = f.read().split("\n")
    return [lines[0]] + lines[2:]


def _same_csr(g, want, what: str) -> None:
    if not (g.device == want.device and torch.equal(g.offsets, want.offsets)
            and torch.equal(g.succ, want.succ)):
        raise AssertionError(f"{what}: load_csr differs from the graph "
                             f"stored")


def _device_store(graph, base: str) -> dict:
    """``BVGraph.store(graph, base, backend="cuda")`` on the card: its
    seconds (host clock, ending in a synchronise), its stage split, and its
    peak device bytes above what was resident."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    rep = {}
    t0 = time.perf_counter()
    BVGraph.store(graph, base, backend="cuda", report=rep)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(encode_s=secs,
                encode_Medges_per_s=graph.num_arcs / secs / 1e6,
                peak_above_resident=torch.cuda.max_memory_allocated()
                - resident, resident_bytes=resident,
                bits_per_link=os.path.getsize(base + ".graph") * 8
                / max(graph.num_arcs, 1), split=rep)


def _read_back(base: str, want, what: str) -> dict:
    """``load_csr(base)`` with launch counts reset just before; it must
    equal ``want`` and launch B1 and B2."""
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    g = load_csr(base)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    if g.report["route"] != "kernel":
        raise AssertionError(f"{what}: load_csr took the "
                             f"{g.report['route']} route")
    for k in DECODE_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{what}: load_csr never launched {k}")
    _same_csr(g, want, what)
    return dict(load_csr_s=secs, launches=launches)


def phase_encode(dev, card: str, graph, hco, hsu) -> dict:
    """The device encoder and the transforms at the slice's scale: the
    slice's CSR, its Gray-code renumbering, its transpose and its
    symmetrization, each stored with ``backend="cuda"`` and read back
    through ``load_csr`` equal; the first held byte-equal to the
    single-stream native encode; then the offline transforms at
    ``OFFLINE_NODES``, stored and read back equal to the in-memory ones.
    The directory and every graph made here are freed at the end."""
    s = BVGraphSettings()
    out = dict(card=card, nodes=graph.num_nodes, arcs=graph.num_arcs,
               chunk_arcs=vencode.DEFAULT_CHUNK_ARCS)
    tmp = tempfile.mkdtemp(prefix=".encode_smoke_", dir=ROOT)
    try:
        # 1. the slice, and the single-stream native encode beside it
        base = os.path.join(tmp, "slice")
        out["slice"] = _device_store(graph, base)
        nat = os.path.join(tmp, "native1")
        t0 = time.perf_counter()
        BVGraph.store(CSRGraph(hco, hsu, device="cpu"), nat,
                      backend="native", num_threads=1)
        out["native_1thread_store_s"] = time.perf_counter() - t0
        for ext in (".graph", ".offsets"):
            with open(base + ext, "rb") as a, open(nat + ext, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"the device encode's {ext} differs"
                                         f" from native.bv_encode(threads=1)")
        if _props_lines(base + ".properties") != _props_lines(
                nat + ".properties"):
            raise AssertionError("the device encode's properties differ")
        out["byte_identical_to_native_1thread"] = True
        # what the labels phase's stores are held to
        out["slice_digest"] = {ext: _sha256(base + ext)
                               for ext in (".graph", ".offsets")}
        out["slice"].update(_read_back(base, graph, "slice"))
        cm_bytes = graph.num_nodes * (s.window_size + 1) * 8
        out["cost_matrix_bytes"] = cm_bytes
        out["cost_copy_GB_per_s"] = (
            cm_bytes / out["slice"]["split"]["cost_copy_s"] / 1e9)
        # one chunk's pack under the profiler
        out["pack_profile"] = _pack_profile(graph, s)

        # 2. the Gray-code renumbering
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ties = {}
        perm = TR.gray_code_permutation(graph, stats=ties)
        torch.cuda.synchronize()
        perm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gp = TR.apply_permutation(graph, perm)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        del perm
        base = os.path.join(tmp, "gray")
        out["gray"] = dict(permutation="gray_code_permutation",
                           permutation_s=perm_s, apply_s=apply_s, **ties,
                           **_device_store(gp, base))
        out["gray"].update(_read_back(base, gp, "gray"))
        del gp

        # 3. transpose and symmetrize
        for name, fn in (("transpose", TR.transpose),
                         ("symmetrize", TR.symmetrize)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gt = fn(graph)
            torch.cuda.synchronize()
            base = os.path.join(tmp, name)
            out[name] = dict(transform_s=time.perf_counter() - t0,
                             arcs=gt.num_arcs, **_device_store(gt, base))
            out[name].update(_read_back(base, gt, name))
            del gt
        torch.cuda.empty_cache()

        # 4. offline transforms at OFFLINE_NODES, at least 4 batches each
        co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
        small = CSRGraph(co, su, device=dev)
        del co, su
        out["offline"] = {}
        for name, off, mem, pairs in (
                ("transpose", TR.transpose_offline, TR.transpose, 1),
                ("symmetrize", TR.symmetrize_offline, TR.symmetrize, 2)):
            batch = -(-pairs * small.num_arcs // OFFLINE_BATCHES)
            t0 = time.perf_counter()
            bg = off(small, batch_size=batch, temp_dir=tmp)
            off_s = time.perf_counter() - t0
            base = os.path.join(tmp, "offline_" + name)
            t0 = time.perf_counter()
            BVGraph.store(bg, base, backend="cuda")
            store_s = time.perf_counter() - t0
            nb = len(bg.batches)
            bg.cleanup()
            if nb < 4:
                raise AssertionError(f"offline {name}: {nb} batches")
            want = mem(small)
            read = _read_back(base, want, "offline " + name)
            out["offline"][name] = dict(
                nodes=small.num_nodes, arcs=want.num_arcs, batches=nb,
                batch_size=batch, batch_s=off_s, merge_and_store_s=store_s,
                **read)
            del want
        del small
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _timed(fn) -> tuple:
    """(``fn()``, its seconds on the host clock ending in a synchronise,
    the peak device bytes above what was resident when it started)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - resident)


def _beside(fn):
    """Start ``fn()`` in a thread beside the caller's work (a native call or
    a numpy operation releases the interpreter's lock); returns ``wait()``,
    which joins it and gives (its result, its seconds on the host clock),
    or raises what it raised."""
    import threading
    box = {}

    def run() -> None:
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised by wait()
            box["err"] = e
        box["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait() -> tuple:
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"], box["s"]

    return wait


def _in_chunks(fn, m: int, step: int = 1 << 24) -> None:
    """``fn(a, b)`` over the chunks [a, b) of [0, m), on every host core
    (numpy's array operations release the interpreter's lock)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(lambda a: fn(a, min(a + step, m)), range(0, m, step)))


def fixed_fields_numpy(data: np.ndarray, m: int, w: int) -> np.ndarray:
    """The m ``w``-bit (w <= 16) MSB-first fields at bits 0, w, 2w, ...
    of a byte stream, in numpy on the host (independent of the port's
    codec): a 24-bit window from each field's first byte."""
    d = np.concatenate([data, np.zeros(4, np.uint8)])
    out = np.empty(m, dtype=np.int64)

    def chunk(a: int, b: int) -> None:
        p = np.arange(a, b, dtype=np.int64) * w
        at = p >> 3
        win = ((d[at].astype(np.int64) << 16) | (d[at + 1].astype(np.int64)
                                                  << 8) | d[at + 2])
        out[a:b] = (win >> (24 - (p & 7) - w)) & ((1 << w) - 1)

    _in_chunks(chunk, m)
    return out


def gamma_bits_numpy(v: np.ndarray) -> np.ndarray:
    """Length of each value's gamma code, 2 floor(log2(v + 1)) + 1 (exact
    for v + 1 below 2**50)."""
    out = np.empty(len(v), dtype=np.int64)

    def chunk(a: int, b: int) -> None:
        out[a:b] = 2 * np.floor(np.log2(v[a:b].astype(np.float64) + 1)
                                ).astype(np.int64) + 1

    _in_chunks(chunk, len(v))
    return out


def _arc_keys(g) -> torch.Tensor:
    """``(src << 32) | tgt`` of every arc, sorted (a CSR's order)."""
    return (arc_sources(g) << 32) | g.succ.to(torch.int64)


def _label_at(keys: torch.Tensor, values: torch.Tensor,
              want: torch.Tensor) -> tuple:
    """(found, label) of the arcs with keys ``want`` in a graph with
    sorted ``keys`` and labels ``values``."""
    pos = torch.searchsorted(keys, want).clamp(max=max(keys.numel() - 1, 0))
    found = keys[pos] == want
    return found, torch.where(found, values[pos], 0)


def _store_and_load_labels(name: str, graph, proto, vals, tmp: str,
                           digest: dict, hco) -> dict:
    """One label type through ``store_labelled(backend="cuda")``, the
    independent host decodes, and ``to_device``."""
    n, m = graph.num_nodes, graph.num_arcs
    base = os.path.join(tmp, name)
    lbase = base + "-labels"
    rep = {}
    _, store_s, store_peak = _timed(lambda: BVGraph.store_labelled(
        LB.ArcLabelledGraph(graph, vals, proto), base, lbase,
        backend="cuda", report=rep))
    for ext in (".graph", ".offsets"):
        if _sha256(base + ext) != digest[ext]:
            raise AssertionError(f"labels {name}: the labelled store's {ext} "
                                 f"differs from the encode phase's")
    # the files decoded on the host, independently of the device pack
    t0 = time.perf_counter()
    data = np.fromfile(lbase + ".labels", dtype=np.uint8)
    lo = native.decode_offset_stream(
        np.fromfile(lbase + ".labeloffsets", dtype=np.uint8), n, C.GAMMA)
    want = vals.cpu().numpy()
    if isinstance(proto, LB.FixedWidthIntLabel):
        got = fixed_fields_numpy(data, m, proto.width)
        bits = np.full(m, proto.width, dtype=np.int64)
    else:
        got = np.diff(native.decode_offset_stream(data, m - 1, C.GAMMA),
                      prepend=0)
        bits = gamma_bits_numpy(want)
    ends = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(bits, out=ends[1:])
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"labels {name}: the host decode differs at "
                             f"{len(bad)} arcs, first {bad[:5]}")
    if not np.array_equal(lo, ends[hco]):
        raise AssertionError(f"labels {name}: .labeloffsets differs")
    host_check_s = time.perf_counter() - t0
    del data, got, bits, ends, want
    # back to the card, launch counts reset just before
    _build.reset_launches()
    back, load_s, load_peak = _timed(
        lambda: LB.BitStreamArcLabelledGraph.load(lbase).to_device())
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    if back.report["graph"]["route"] != "kernel":
        raise AssertionError(f"labels {name}: to_device took the "
                             f"{back.report['graph']['route']} route")
    for k in DECODE_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"labels {name}: to_device never launched "
                                 f"{k}")
    _same_csr(back.graph, graph, f"labels {name}")
    if not torch.equal(back.values, vals):
        raise AssertionError(f"labels {name}: to_device's labels differ")
    labels_bytes = os.path.getsize(lbase + ".labels")
    return dict(
        spec=proto.to_spec(), store_s=store_s, graph_encode_s=rep["graph_s"],
        label_pack_s=rep["labels_s"], label_pack_split=rep["labels_split"],
        store_peak_above_resident=store_peak, labels_bytes=labels_bytes,
        labeloffsets_bytes=os.path.getsize(lbase + ".labeloffsets"),
        bits_per_label=int(lo[-1]) / m, host_check_s=host_check_s,
        load_s=load_s, load_peak_above_resident=load_peak,
        graph_decode=back.report["graph"], label_decode_s=back.report[
            "labels_s"], label_decode_split=back.report["labels_split"],
        launches=launches, graph_files_equal_encode=True,
        host_decodes_equal=True, to_device_equal=True)


def phase_labels(dev, card: str, graph, hco, hsu, digest: dict) -> dict:
    """Arc labels at the slice's scale: two label types stored with the
    graph on the card and read back; the labelled combinators and SCC on
    the labelled slice; the labelled offline transforms at
    ``OFFLINE_NODES`` and the labelled compose at ``COMPOSE_NODES``.  The
    directory and every graph made here are freed at the end."""
    n, m = graph.num_nodes, graph.num_arcs
    t_phase = time.perf_counter()
    out = dict(card=card, nodes=n, arcs=m)
    tmp = tempfile.mkdtemp(prefix=".labels_smoke_", dir=ROOT)
    try:
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        src = arc_sources(graph)
        fixed = (src * 7 + graph.succ.to(torch.int64)) % 1000
        del src
        gamma = torch.empty(m, dtype=torch.float64, device=dev).geometric_(
            LABEL_GEOMETRIC_P, generator=gen).to(torch.int64) - 1
        for name, proto, vals in (
                ("fixed10", LB.FixedWidthIntLabel("W", 10), fixed),
                ("gamma", LB.GammaCodedIntLabel("W"), gamma)):
            out[name] = _store_and_load_labels(name, graph, proto, vals, tmp,
                                               digest, hco)
        out["gamma"]["max_value"] = int(gamma.max())
        del gamma
        torch.cuda.empty_cache()

        # the combinators and SCC on the labelled slice
        g = LB.ArcLabelledGraph(graph, fixed, LB.FixedWidthIntLabel("W", 10))
        pred = LB.integer_label_filter(*range(LABEL_KEEP_BELOW))
        mask = fixed < LABEL_KEEP_BELOW
        steps = {}
        kept, s, p = _timed(lambda: filter_labelled(g, pred))
        steps["filter_labelled"] = dict(seconds=s, peak_above_resident=p,
                                        kept_arcs=kept.num_arcs)
        want = TR.filter_arcs(graph, lambda a, b: mask)
        _same_csr(kept.graph, want, "filter_labelled")
        if not torch.equal(kept.values, fixed[mask]):
            raise AssertionError("filter_labelled: the labels kept differ")
        del kept
        info = {}
        (k, comp), s, p = _timed(
            lambda: A.strongly_connected_components_labelled(g, pred,
                                                             stats=info))
        steps["scc_labelled"] = dict(seconds=s, peak_above_resident=p,
                                     components=k, **info)
        kw, compw = A.strongly_connected_components(want)
        if k != kw or not torch.equal(comp, compw):
            raise AssertionError("scc_labelled differs from the SCC of "
                                 "filter_arcs on the same mask")
        del comp, compw, want, mask
        r, s, p = _timed(lambda: LB.relabel(
            g, lambda v, a, b: 2 * v + 1, LB.GammaCodedIntLabel("W")))
        steps["relabel"] = dict(seconds=s, peak_above_resident=p)
        if not torch.equal(r.values, 2 * fixed + 1):
            raise AssertionError("relabel: labels differ from 2 v + 1")
        u, s, p = _timed(lambda: LB.union_labelled(g, r,
                                                   lambda a, b: a + b))
        steps["union_labelled"] = dict(seconds=s, peak_above_resident=p)
        _same_csr(u.graph, graph, "union_labelled")
        if not torch.equal(u.values, 3 * fixed + 1):
            raise AssertionError("union_labelled: labels differ from "
                                 "v + (2 v + 1)")
        del u, r, g, fixed
        torch.cuda.empty_cache()
        out["full_scale"] = steps
        out["offline"] = _labels_offline(dev, gen, tmp)
        out["compose"] = _labels_compose(dev, gen)
        torch.cuda.empty_cache()
        out["lists"] = _labels_lists(dev, graph, tmp, digest, gen)
        torch.cuda.empty_cache()
        out["lists_offline"] = _labels_lists_offline(dev, gen, tmp)
        out["lists_compose"] = _labels_lists_compose(dev, gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _labels_offline(dev, gen, tmp: str) -> dict:
    """The labelled offline transforms at ``OFFLINE_NODES``: transpose
    twice (the identity), symmetrize with a sum merge (pair by pair
    against the forward and reverse labels), each merged in bulk."""
    co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
    small = CSRGraph(co, su, device=dev)
    del co, su
    m = small.num_arcs
    sv = torch.randint(0, 1 << 20, (m,), generator=gen, device=dev)
    sg = LB.ArcLabelledGraph(small, sv, LB.GammaCodedIntLabel("W"))
    batch = -(-m // OFFLINE_BATCHES)
    res = dict(nodes=small.num_nodes, arcs=m, batch_size=batch)
    bt, batch_s, _ = _timed(lambda: TR.transpose_offline_labelled(
        sg, batch_size=batch, temp_dir=tmp))
    once, merge_s, merge_peak = _timed(bt.to_arc_labelled)
    nb = len(bt.batches)
    bt.cleanup()
    if nb < 4:
        raise AssertionError(f"labelled offline transpose: {nb} batches")
    _same_csr(once.graph, TR.transpose(small), "labelled offline transpose")
    bt2 = TR.transpose_offline_labelled(once, batch_size=batch, temp_dir=tmp)
    twice = bt2.to_arc_labelled()
    bt2.cleanup()
    if not twice.equals_labelled(sg):
        raise AssertionError("labelled offline transpose twice is not the "
                             "identity")
    res["transpose"] = dict(batches=nb, batch_s=batch_s, merge_s=merge_s,
                            merge_peak_above_resident=merge_peak)
    del once, twice
    bs, batch_s, _ = _timed(lambda: TR.symmetrize_offline_labelled(
        sg, merge=lambda a, b: a + b, batch_size=2 * batch, temp_dir=tmp))
    sym, merge_s, merge_peak = _timed(bs.to_arc_labelled)
    nb, spilled = len(bs.batches), bs.num_arcs
    bs.cleanup()
    if nb < 4 or spilled != 2 * m:
        raise AssertionError(f"labelled offline symmetrize: {nb} batches, "
                             f"{spilled} pairs spilled")
    _same_csr(sym.graph, TR.symmetrize(small), "labelled offline symmetrize")
    keys = _arc_keys(small)
    x = arc_sources(sym.graph)
    y = sym.graph.succ.to(torch.int64)
    fa, a = _label_at(keys, sv, (x << 32) | y)
    fb, b = _label_at(keys, sv, (y << 32) | x)
    if not (bool((fa | fb).all()) and torch.equal(sym.values, a + b)):
        raise AssertionError("labelled offline symmetrize: a label is not "
                             "the sum of its forward and reverse labels")
    res["symmetrize"] = dict(batches=nb, arcs=sym.num_arcs,
                             pairs_spilled=spilled, batch_s=batch_s,
                             merge_s=merge_s,
                             merge_peak_above_resident=merge_peak,
                             reciprocal_or_loop_arcs=int((fa & fb).sum()))
    return res


def _labels_compose(dev, gen) -> dict:
    """``compose_labelled`` of the first ``COMPOSE_NODES`` nodes of the
    offline synthetic with itself under (min, +); sampled nodes checked
    against a join on the host."""
    co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
    K = COMPOSE_NODES
    sub = TR.filter_arcs(CSRGraph(co, su, device=dev).to_csr(0, K),
                         lambda a, b: b < K)
    del co, su
    lv = torch.randint(0, 1000, (sub.num_arcs,), generator=gen, device=dev)
    g = LB.ArcLabelledGraph(sub, lv, LB.GammaCodedIntLabel("W"))
    sr = LB.LabelSemiring("amin", lambda a, b: a + b, 1 << 30, 0)
    c, secs, peak = _timed(lambda: TR.compose_labelled(g, g, sr))
    co_h, su_h = sub.offsets.cpu().numpy(), sub.succ.cpu().numpy()
    lv_h = lv.cpu().numpy()
    cco, csu = c.graph.offsets.cpu().numpy(), c.graph.succ.cpu().numpy()
    cv = c.values.cpu().numpy()
    rng = np.random.default_rng(9)
    for x in rng.choice(K, COMPOSE_SAMPLE, replace=False):
        best = {}
        for i in range(co_h[x], co_h[x + 1]):
            y = su_h[i]
            for j in range(co_h[y], co_h[y + 1]):
                z, v = int(su_h[j]), int(lv_h[i] + lv_h[j])
                best[z] = min(best.get(z, v), v)
        zs = sorted(best)
        if (csu[cco[x]:cco[x + 1]].tolist() != zs
                or cv[cco[x]:cco[x + 1]].tolist() != [best[z] for z in zs]):
            raise AssertionError(f"compose_labelled: node {x} differs from "
                                 f"the host join")
    return dict(nodes=K, arcs=sub.num_arcs, paths=int(
        sub.outdegrees()[sub.succ.to(torch.int64)].sum()),
        arcs_out=c.num_arcs, seconds=secs, peak_above_resident=peak,
        sampled_nodes=COMPOSE_SAMPLE)


# ---- the labels phase's list labels ------------------------------------


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 values."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def mix64(h: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 values, cut to [0, 2^62)."""
    h = h ^ _srl(h, 30)
    h = h * K_1
    h = h ^ _srl(h, 27)
    h = h * K_2
    h = h ^ _srl(h, 31)
    return h & M62


def _ragged_rows(counts: torch.Tensor, rows: torch.Tensor) -> tuple:
    """(counts of the rows, the positions of their entries) of rows
    ``rows`` (any order, repeats allowed) of a ragged batch with
    ``counts``, in torch ops written here rather than taken from the port
    under test."""
    off = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, out=off[1:])
    c = counts[rows]
    total = int(c.sum())
    starts = torch.cumsum(c, 0) - c
    pos = (torch.repeat_interleave(off[rows] - starts, c, output_size=total)
           + torch.arange(total, device=counts.device))
    return c, pos


def list_labels(src: torch.Tensor, tgt: torch.Tensor, gen) -> tuple:
    """(counts, entries) of the arcs (src, tgt) on their device: lengths
    geometric(p) - 1, entry j of arc (x, y) the hash of (x, y, j) mod
    2^LIST_WIDTH."""
    dev = src.device
    m = src.numel()
    counts = torch.empty(m, dtype=torch.float64, device=dev).geometric_(
        LIST_GEOMETRIC_P, generator=gen).to(torch.int64) - 1
    arc = torch.repeat_interleave(torch.arange(m, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(arc.numel(), device=dev) - first[arc]
    del first
    h = src[arc] * K_X + tgt[arc].to(torch.int64) * K_J + j * K_1
    del arc, j
    return counts, mix64(h + LIST_SEED) & ((1 << LIST_WIDTH) - 1)


def holds_below(t: int):
    """A list predicate: the arc's list holds an entry below ``t``."""
    def pred(values, src, tgt) -> torch.Tensor:
        counts, entries = values
        arc = torch.repeat_interleave(
            torch.arange(counts.numel(), device=counts.device), counts,
            output_size=entries.numel())
        hit = torch.zeros(counts.numel(), dtype=torch.bool,
                          device=counts.device)
        hit[arc[entries < t]] = True
        return hit
    return pred


def _read_fields(stream: torch.Tensor, pos: torch.Tensor,
                 nbits: torch.Tensor) -> torch.Tensor:
    """The ``nbits``-bit (at most 33) MSB-first field at each bit position
    of a byte stream on the card (with >= 5 guard bytes): a 40-bit window
    from each field's first byte."""
    b = pos >> 3
    win = torch.zeros_like(pos)
    for i in range(5):
        win = (win << 8) | stream[b + i].to(torch.int64)
    return (win >> (40 - (pos & 7) - nbits)) & ((1 << nbits) - 1)


def _check_list_stream(lbase: str, graph, counts: torch.Tensor,
                       entries: torch.Tensor) -> dict:
    """Every bit of ``.labels`` and ``.labeloffsets`` against the labels
    stored, independently of the port's codec: each arc's label at its
    bit position (the gamma code of its length -- floor(log2(c + 1))
    zeros, then the binary of c + 1 -- then w bits per entry), each node's
    offset where its first arc's label begins, the stream's length and its
    slack bits zero."""
    dev = counts.device
    n, w = graph.num_nodes, LIST_WIDTH
    data = np.fromfile(lbase + ".labels", dtype=np.uint8)
    lo = native.decode_offset_stream(
        np.fromfile(lbase + ".labeloffsets", dtype=np.uint8), n, C.GAMMA)
    # floor(log2(c + 1)) is frexp's exponent less one (exact; a float log2
    # on the card may land below an integer)
    glen = 2 * torch.frexp((counts + 1).to(torch.float64))[1].to(
        torch.int64) - 1
    at = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(glen + w * counts, 0, out=at[1:])
    total = int(at[-1])
    if not torch.equal(torch.from_numpy(lo).to(dev), at[graph.offsets]):
        raise AssertionError("labels lists: .labeloffsets differs from "
                             "the lists' bit lengths")
    if len(data) != -(-total // 8) or (total % 8 and int(data[-1]) & (
            (1 << (8 - total % 8)) - 1)):
        raise AssertionError("labels lists: the stream's length or slack "
                             "bits are wrong")
    stream = torch.from_numpy(np.concatenate([data, np.zeros(8, np.uint8)])
                              ).to(dev)
    del data
    off = torch.zeros_like(at)
    torch.cumsum(counts, 0, out=off[1:])
    step = 1 << 26
    for a in range(0, counts.numel(), step):
        b = min(a + step, counts.numel())
        if not torch.equal(_read_fields(stream, at[a:b], glen[a:b]),
                           counts[a:b] + 1):
            raise AssertionError(f"labels lists: a length code in arcs "
                                 f"[{a}, {b}) differs")
        e0, e1 = int(off[a]), int(off[b])
        arc = torch.repeat_interleave(torch.arange(a, b, device=dev),
                                      counts[a:b], output_size=e1 - e0)
        bit = (at[arc] + glen[arc]
               + w * (torch.arange(e0, e1, device=dev) - off[arc]))
        if not torch.equal(_read_fields(stream, bit, torch.full_like(bit, w)),
                           entries[e0:e1]):
            raise AssertionError(f"labels lists: an entry of arcs [{a}, "
                                 f"{b}) differs")
    return dict(bits=total, bits_per_arc=total / max(counts.numel(), 1))


def _labels_lists(dev, graph, tmp: str, digest: dict, gen) -> dict:
    """List labels at the slice's scale: stored with the graph on the card,
    the files checked bit by bit, read back with ``to_device``, then the
    filter and the labelled SCC with a list predicate."""
    proto = LB.FixedWidthIntListLabel("A", LIST_WIDTH)
    src = arc_sources(graph)
    vals, gen_s, _ = _timed(lambda: list_labels(src, graph.succ, gen))
    del src
    counts, entries = vals
    out = dict(spec=proto.to_spec(), entries=entries.numel(),
               empty_lists=int((counts == 0).sum()),
               longest_list=int(counts.max()), generate_s=gen_s)
    base = os.path.join(tmp, "lists")
    lbase = base + "-labels"
    rep = {}
    _, out["store_s"], out["store_peak_above_resident"] = _timed(
        lambda: BVGraph.store_labelled(LB.ArcLabelledGraph(graph, vals,
                                                           proto),
                                       base, lbase, backend="cuda",
                                       report=rep))
    out.update(graph_encode_s=rep["graph_s"], label_pack_s=rep["labels_s"],
               label_pack_split=rep["labels_split"],
               labels_bytes=os.path.getsize(lbase + ".labels"),
               labeloffsets_bytes=os.path.getsize(lbase + ".labeloffsets"))
    for ext in (".graph", ".offsets"):
        if _sha256(base + ext) != digest[ext]:
            raise AssertionError(f"labels lists: the labelled store's {ext} "
                                 f"differs from the encode phase's")
    chk, out["stream_check_s"], _ = _timed(
        lambda: _check_list_stream(lbase, graph, counts, entries))
    out.update(chk)
    _build.reset_launches()
    back, out["load_s"], out["load_peak_above_resident"] = _timed(
        lambda: LB.BitStreamArcLabelledGraph.load(lbase).to_device())
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    _decoded(launches, "labels lists: to_device")
    if back.report["graph"]["route"] != "kernel":
        raise AssertionError(f"labels lists: to_device took the "
                             f"{back.report['graph']['route']} route")
    _same_csr(back.graph, graph, "labels lists")
    if not (torch.equal(back.values[0], counts)
            and torch.equal(back.values[1], entries)):
        raise AssertionError("labels lists: to_device's lists differ")
    out.update(launches=launches, graph_decode=back.report["graph"],
               label_decode_s=back.report["labels_s"],
               label_decode_split=back.report["labels_split"],
               stored_and_loaded_equal=True)
    del back
    torch.cuda.empty_cache()

    g = LB.ArcLabelledGraph(graph, vals, proto)
    pred = holds_below(LIST_KEEP_BELOW)
    mask = pred(vals, None, None)
    kept, s, p = _timed(lambda: filter_labelled(g, pred))
    out["filter_labelled"] = dict(seconds=s, peak_above_resident=p,
                                  kept_arcs=kept.num_arcs)
    want = TR.filter_arcs(graph, lambda a, b: mask)
    _same_csr(kept.graph, want, "labels lists: filter_labelled")
    c, pos = _ragged_rows(counts, torch.nonzero(mask).flatten())
    if not (torch.equal(kept.values[0], c)
            and torch.equal(kept.values[1], entries[pos])):
        raise AssertionError("labels lists: filter_labelled's lists differ")
    del kept, c, pos
    info = {}
    (k, comp), s, p = _timed(
        lambda: A.strongly_connected_components_labelled(g, pred,
                                                         stats=info))
    out["scc_labelled"] = dict(seconds=s, peak_above_resident=p,
                               components=k, **info)
    kw, compw = A.strongly_connected_components(want)
    if k != kw or not torch.equal(comp, compw):
        raise AssertionError("labels lists: scc_labelled differs from the "
                             "SCC of filter_arcs on the same mask")
    return out


def _concat_rows(counts: torch.Tensor, a: torch.Tensor, fa: torch.Tensor,
                 b: torch.Tensor, fb: torch.Tensor) -> tuple:
    """Row i: row a[i] (where fa[i]) followed by row b[i] (where fb[i]) of
    a ragged batch with ``counts``: (counts, entry positions)."""
    rows = torch.stack([a, b], 1).flatten()
    ok = torch.stack([fa, fb], 1).flatten()
    c2 = torch.where(ok, counts[rows], 0)
    _, pos = _ragged_rows(torch.cat([counts, counts.new_zeros(1)]),
                          torch.where(ok, rows, counts.numel()))
    return c2.view(-1, 2).sum(1), pos


def _labels_lists_offline(dev, gen, tmp: str) -> dict:
    """List labels at ``OFFLINE_NODES``: the offline transpose twice (the
    identity), the offline symmetrize with the concatenation merge (pair by
    pair against ``label(min, max) ++ label(max, min)``), its
    ``iter_labelled`` on 1,000 nodes against ``to_arc_labelled``, the
    union with a relabelled copy, and the store on the card held
    byte-equal to the native backend's on the host."""
    co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
    small = CSRGraph(co, su, device=dev)
    m = small.num_arcs
    vals = list_labels(arc_sources(small), small.succ, gen)
    counts, entries = vals
    proto = LB.FixedWidthIntListLabel("A", LIST_WIDTH)
    sg = LB.ArcLabelledGraph(small, vals, proto)
    batch = -(-m // OFFLINE_BATCHES)
    res = dict(nodes=small.num_nodes, arcs=m, entries=entries.numel(),
               batch_size=batch)
    bt, batch_s, _ = _timed(lambda: TR.transpose_offline_labelled(
        sg, batch_size=batch, temp_dir=tmp))
    once, merge_s, merge_peak = _timed(bt.to_arc_labelled)
    nb = len(bt.batches)
    bt.cleanup()
    if nb < 4:
        raise AssertionError(f"list offline transpose: {nb} batches")
    _same_csr(once.graph, TR.transpose(small), "list offline transpose")
    bt2 = TR.transpose_offline_labelled(once, batch_size=batch, temp_dir=tmp)
    twice = bt2.to_arc_labelled()
    bt2.cleanup()
    if not twice.equals_labelled(sg):
        raise AssertionError("list offline transpose twice is not the "
                             "identity")
    res["transpose"] = dict(batches=nb, batch_s=batch_s, merge_s=merge_s,
                            merge_peak_above_resident=merge_peak)
    del once, twice

    bs, batch_s, _ = _timed(lambda: TR.symmetrize_offline_labelled(
        sg, merge=LB.concat_lists, batch_size=2 * batch, temp_dir=tmp))
    try:
        sym, merge_s, merge_peak = _timed(bs.to_arc_labelled)
        if len(bs.batches) < 4 or bs.num_arcs != 2 * m:
            raise AssertionError(f"list offline symmetrize: "
                                 f"{len(bs.batches)} batches, "
                                 f"{bs.num_arcs} pairs spilled")
        _same_csr(sym.graph, TR.symmetrize(small),
                  "list offline symmetrize")
        keys = _arc_keys(small)
        x = arc_sources(sym.graph)
        y = sym.graph.succ.to(torch.int64)
        lo_, hi_ = torch.minimum(x, y), torch.maximum(x, y)
        idx = torch.arange(m, device=dev)
        fa, ia = _label_at(keys, idx, (lo_ << 32) | hi_)
        fb, ib = _label_at(keys, idx, (hi_ << 32) | lo_)
        c, pos = _concat_rows(counts, ia, fa, ib, fb)
        if not (bool((fa | fb).all()) and torch.equal(sym.values[0], c)
                and torch.equal(sym.values[1], entries[pos])):
            raise AssertionError("list offline symmetrize: a list is not "
                                 "label(min, max) ++ label(max, min)")
        res["symmetrize"] = dict(
            batches=len(bs.batches), arcs=sym.num_arcs,
            pairs_spilled=bs.num_arcs, batch_s=batch_s, merge_s=merge_s,
            merge_peak_above_resident=merge_peak,
            loops=int((x == y).sum()),
            both_directions=int((fa & fb).sum()))
        del keys, x, y, lo_, hi_, c, pos
        # the host merge node by node, in windows of consecutive nodes
        t0 = time.perf_counter()
        per = LIST_ITER_NODES // LIST_ITER_WINDOWS
        sco, ssu = sym.graph.offsets.cpu().numpy(), sym.graph.succ.cpu()
        scnt = sym.values[0].cpu().numpy()
        sent = sym.values[1].cpu().numpy()
        sloff = np.concatenate([[0], np.cumsum(scnt)])
        rng = np.random.default_rng(31)
        for x0 in rng.choice(small.num_nodes - per, LIST_ITER_WINDOWS,
                             replace=False).tolist():
            it = bs.iter_labelled(x0)
            for _ in range(per):
                x, succ, labs = next(it)
                a, b = sco[x], sco[x + 1]
                if (succ.tolist() != ssu[a:b].tolist()
                        or len(labs) != b - a
                        or any(l.value.tolist()
                               != sent[sloff[k]:sloff[k + 1]].tolist()
                               for k, l in zip(range(a, b), labs))):
                    raise AssertionError(f"list offline symmetrize: "
                                         f"iter_labelled differs from "
                                         f"to_arc_labelled at node {x}")
            it.close()
        res["symmetrize"]["iter_labelled"] = dict(
            nodes=LIST_ITER_NODES, seconds=time.perf_counter() - t0)
        del sym
    finally:
        bs.cleanup()

    # the store on the card, then the native backend's on the host
    base_c = os.path.join(tmp, "lists-cuda")
    base_n = os.path.join(tmp, "lists-native")
    _, cuda_s, _ = _timed(lambda: BVGraph.store_labelled(
        sg, base_c, backend="cuda"))
    host = LB.ArcLabelledGraph(CSRGraph(co, su, device="cpu"),
                               (counts.cpu(), entries.cpu()), proto)
    t0 = time.perf_counter()
    BVGraph.store_labelled(host, base_n, backend="native")
    native_s = time.perf_counter() - t0
    for ext in (".graph", ".offsets", "-labelled.labels",
                "-labelled.labeloffsets"):
        _same_bytes(base_c + ext, base_n + ext, f"list store {ext}")
    res["store_backends"] = dict(cuda_s=cuda_s, native_s=native_s,
                                 byte_identical=True)
    del host

    r = LB.relabel(sg, lambda v, a, b: (v[0], v[1] + 1), proto)
    u, secs, peak = _timed(lambda: LB.union_labelled(sg, r,
                                                     LB.concat_lists))
    _same_csr(u.graph, small, "list union_labelled")
    idx = torch.arange(m, device=dev)
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    c, pos = _concat_rows(counts, idx, ok, idx, ok)
    plus = torch.zeros_like(pos).view(-1)
    _, second = _ragged_rows(torch.stack([counts, counts], 1).flatten(),
                             2 * idx + 1)
    plus[second] = 1
    if not (torch.equal(u.values[0], c)
            and torch.equal(u.values[1], entries[pos] + plus)):
        raise AssertionError("list union_labelled: a list is not l ++ "
                             "(l + 1)")
    res["union_labelled"] = dict(seconds=secs, peak_above_resident=peak,
                                 arcs=u.num_arcs)
    del u, r
    return res


def _labels_lists_compose(dev, gen) -> dict:
    """``compose_labelled`` of the first ``COMPOSE_NODES`` nodes of the
    offline synthetic with itself under the list semiring (concatenation
    for both ``multiply`` and ``add``); sampled nodes checked against a
    fold on the host in the JAX path order (g0's arcs in order, then g1's
    successors in order)."""
    co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
    K = COMPOSE_NODES
    sub = TR.filter_arcs(CSRGraph(co, su, device=dev).to_csr(0, K),
                         lambda a, b: b < K)
    del co, su
    counts, entries = list_labels(arc_sources(sub), sub.succ, gen)
    g = LB.ArcLabelledGraph(sub, (counts, entries),
                            LB.FixedWidthIntListLabel("A", LIST_WIDTH))
    empty = (torch.zeros(0, dtype=torch.int64, device=dev),) * 2
    sr = LB.LabelSemiring(LB.concat_lists, LB.concat_lists, empty, empty)
    c, secs, peak = _timed(lambda: TR.compose_labelled(g, g, sr))
    co_h, su_h = sub.offsets.cpu().numpy(), sub.succ.cpu().numpy()
    cnt_h, ent_h = counts.cpu().numpy(), entries.cpu().numpy()
    loff = np.concatenate([[0], np.cumsum(cnt_h)])
    cco, csu = c.graph.offsets.cpu().numpy(), c.graph.succ.cpu().numpy()
    ccnt, cent = c.values[0].cpu().numpy(), c.values[1].cpu().numpy()
    cloff = np.concatenate([[0], np.cumsum(ccnt)])
    # the paths into each output arc (the runs the merge folds), by a
    # sparse product on the host
    import scipy.sparse as sp
    adj = sp.csr_matrix((np.ones(len(su_h), dtype=np.int64), su_h, co_h),
                        shape=(K, K))
    paths = (adj @ adj).tocsr()
    if paths.nnz != c.num_arcs or int(paths.data.sum()) != int(
            np.diff(co_h)[su_h].sum()):
        raise AssertionError(f"list compose_labelled: {c.num_arcs} arcs "
                             f"out, the path product has {paths.nnz}")
    rng = np.random.default_rng(33)
    for x in rng.choice(K, COMPOSE_SAMPLE, replace=False):
        acc = {}
        for i in range(co_h[x], co_h[x + 1]):
            y = su_h[i]
            for j in range(co_h[y], co_h[y + 1]):
                z = int(su_h[j])
                acc[z] = (acc.get(z, []) + ent_h[loff[i]:loff[i + 1]].tolist()
                          + ent_h[loff[j]:loff[j + 1]].tolist())
        zs = sorted(acc)
        a, b = cco[x], cco[x + 1]
        if (csu[a:b].tolist() != zs
                or [cent[cloff[k]:cloff[k + 1]].tolist()
                    for k in range(a, b)] != [acc[z] for z in zs]):
            raise AssertionError(f"list compose_labelled: node {x} differs "
                                 f"from the host fold")
    return dict(nodes=K, arcs=sub.num_arcs, entries=entries.numel(),
                arcs_out=c.num_arcs, entries_out=c.values[1].numel(),
                seconds=secs, peak_above_resident=peak,
                paths=int(paths.data.sum()),
                longest_run=int(paths.data.max(initial=0)),
                sampled_nodes=COMPOSE_SAMPLE)


# ---- the cli phase: the command line and the sliced decode -------------

# the slice length of the sliced decode (the JAX function's default)
CLI_SLICE_ARCS = 1 << 27
# the text formats' ids: a seeded bijection of [0, 2^63), x -> A x + B
ID_MASK63 = (1 << 63) - 1
ID_MUL = 0x9E3779B97F4A7C15 & ID_MASK63 | 1
ID_ADD = 0x2545F4914F6CDD1D
ID_DIGITS = 19


def _bij(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint64) * np.uint64(ID_MUL) + np.uint64(ID_ADD))
            & np.uint64(ID_MASK63)).astype(np.int64)


def _bij_inverse(y: np.ndarray) -> np.ndarray:
    inv = pow(ID_MUL, -1, 1 << 63)
    return (((y.astype(np.uint64) - np.uint64(ID_ADD)) * np.uint64(inv))
            & np.uint64(ID_MASK63)).astype(np.int64)


def _decimal(v: np.ndarray) -> np.ndarray:
    """Non-negative int64 values as fixed-width ASCII digits, one row
    each (leading zeros are decimal all the same)."""
    out = np.empty((len(v), ID_DIGITS), dtype=np.uint8)
    x = v.copy()
    for k in range(ID_DIGITS - 1, -1, -1):
        out[:, k] = x % 10 + 48
        x //= 10
    return out


def _cli(argv: list) -> tuple:
    """``cli.main(argv)`` on the card with the launch counts reset just
    before and read just after: (printed text, seconds from the call to
    its return, ending in a synchronise, launches)."""
    import contextlib
    import io
    from webgraph_tpu_torch import cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue(), secs, {k: _build.LAUNCHES[k] for k in KERNELS}


def _decoded(launches: dict, what: str) -> None:
    for k in DECODE_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{what} never launched {k}")


def _same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as f, open(b, "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{what}: {os.path.basename(a)} differs")


def phase_cli(dev, card: str, graph, hco, hsu) -> dict:
    """The command line and the sliced decode at the slice's scale, and the
    text formats at ``OFFLINE_NODES``; every output held to the same
    analytic on the slice's in-memory CSR.  The directory is removed at
    the end."""
    from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
    from webgraph_tpu_torch.utils.stats import write_stats
    n, m = graph.num_nodes, graph.num_arcs
    out = dict(card=card, nodes=n, arcs=m)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".cli_smoke_", dir=ROOT)
    try:
        bv = os.path.join(tmp, "bv")
        t0 = time.perf_counter()
        BVGraph.store(graph, bv)
        out["store_s"] = time.perf_counter() - t0

        # 1. the module's entry in a process of its own
        t0 = time.perf_counter()
        sp = subprocess.run([sys.executable, "-m", "webgraph_tpu_torch",
                             "speedtest", bv, "--repeat", "3"], cwd=ROOT,
                            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if sp.returncode != 0:
            raise AssertionError(f"python -m webgraph_tpu_torch speedtest "
                                 f"exited {sp.returncode}: "
                                 f"{sp.stderr[-2000:]}")
        line = sp.stdout.strip().splitlines()[-1]
        hit = re.fullmatch(r"([0-9.]+) ns/link  \(([0-9.]+) M links/s\)",
                           line)
        if hit is None:
            raise AssertionError(f"speedtest printed {line!r}")
        out["speedtest"] = dict(line=line, ns_per_link=float(hit[1]),
                                Medges_per_s=float(hit[2]),
                                process_wall_s=wall)

        # 2. the analytics commands in this process, each on the card
        cmds = {}
        text, secs, la = _cli(["bfs", bv, os.path.join(tmp, "dist"),
                               "--start", "0"])
        _decoded(la, "bfs")
        dist, rounds = A.bfs(graph, [0])
        want = f"reached={int((dist >= 0).sum())} rounds={rounds}\n"
        got = torch.from_numpy(np.fromfile(os.path.join(tmp, "dist"),
                                           dtype=np.int32)).to(dev)
        if text != want or not torch.equal(got, dist.to(torch.int32)):
            raise AssertionError("cli bfs differs from bfs on the slice")
        cmds["bfs"] = dict(seconds=secs, launches=la, printed=text)
        del dist, got

        text, secs, la = _cli(["scc", bv, os.path.join(tmp, "scc")])
        _decoded(la, "scc")
        k, comp = A.strongly_connected_components(graph)
        got = torch.from_numpy(np.fromfile(os.path.join(tmp, "scc"),
                                           dtype=np.int64)).to(dev)
        if not torch.equal(got, comp) or not text.startswith(
                f"components={k} "):
            raise AssertionError("cli scc differs from the SCC of the slice")
        cmds["scc"] = dict(seconds=secs, launches=la, printed=text)
        del comp, got

        text, secs, la = _cli(["stats", bv, os.path.join(tmp, "st")])
        _decoded(la, "stats")
        write_stats(compute_stats(graph), os.path.join(tmp, "want"))
        for ext in (".stats", ".outdegrees", ".indegrees"):
            _same_bytes(os.path.join(tmp, "st" + ext),
                        os.path.join(tmp, "want" + ext), "cli stats")
        cmds["stats"] = dict(seconds=secs, launches=la)

        text, secs, la = _cli(["hyperball", bv, "--log2m", str(HB_LOG2M)])
        _decoded(la, "hyperball")
        nf = A.HyperBall(graph, log2m=HB_LOG2M).run()
        if not 1 <= la["hyperball_merge"] <= len(nf) - 1:
            raise AssertionError(f"cli hyperball launched hyperball_merge "
                                 f"{la['hyperball_merge']} times in "
                                 f"{len(nf) - 1} rounds")
        got = [float(r.split("\t")[1]) for r in text.splitlines()]
        if len(got) != len(nf) or not np.allclose(got, nf, rtol=1e-12,
                                                  atol=0):
            raise AssertionError("cli hyperball's neighbourhood function "
                                 "differs from HyperBall on the slice")
        cmds["hyperball"] = dict(seconds=secs, launches=la,
                                 rounds=len(nf) - 1)
        out["commands"] = cmds
        torch.cuda.empty_cache()

        # 3. the sliced decode, launch counts reset before each slice
        t0 = time.perf_counter()
        bvg = BVGraph.load(bv)
        offsets = bvg.offsets_array()
        outd = native.decode_outdegrees(bvg.data, offsets,
                                        bvg.settings.outdegree_coding)
        prep_s = time.perf_counter() - t0
        rep, per_slice = [], []
        it = decode_big_slices(offsets, outd, bvg.settings, bvg.data,
                               slice_arcs=CLI_SLICE_ARCS, report=rep)
        x = 0
        t0 = time.perf_counter()
        while True:
            _build.reset_launches()
            try:
                lo, hi, co, succ = next(it)
            except StopIteration:
                break
            la = {k: _build.LAUNCHES[k] for k in KERNELS}
            _decoded(la, f"slice [{lo}, {hi})")
            a, b = int(hco[lo]), int(hco[hi])
            if not (lo == x and torch.equal(co, graph.offsets[lo:hi + 1] - a)
                    and torch.equal(succ, graph.succ[a:b])):
                raise AssertionError(f"slice [{lo}, {hi}) differs from the "
                                     f"one-plan CSR")
            per_slice.append(la)
            x = hi
            del co, succ
        sliced_s = time.perf_counter() - t0
        if x != n or len(rep) < 3:
            raise AssertionError(f"{len(rep)} slices reaching node {x}")
        host = sum(r["halo_decode_s"] + r["plan_s"] for r in rep)
        out["sliced"] = dict(
            slice_arcs=CLI_SLICE_ARCS, slices=len(rep), seconds=sliced_s,
            prep_s=prep_s, halo_decode_s=sum(r["halo_decode_s"]
                                             for r in rep),
            plan_s=sum(r["plan_s"] for r in rep),
            decode_s=sum(r["decode_s"] for r in rep),
            host_share=host / sliced_s, launches_per_slice=per_slice,
            report=rep, equal_to_one_plan=True)
        del bvg, offsets, outd
        torch.cuda.empty_cache()

        # 4. the text formats at OFFLINE_NODES
        out["text"] = _cli_text_formats(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _cli_text_formats(dev, tmp: str) -> dict:
    """``ascii`` both ways, ``scattered`` of an arc list with ids through a
    seeded bijection in shuffled order, ``transform symmetrize`` then
    ``cc``: each result held to the source graph in memory."""
    co, su = synthesize_webgraph(OFFLINE_NODES, seed=1)
    small = CSRGraph(co, su, device=dev)
    n, m = small.num_nodes, small.num_arcs
    res = dict(nodes=n, arcs=m)
    src = os.path.join(tmp, "small")
    BVGraph.store(small, src)

    txt = os.path.join(tmp, "small_txt")
    _, secs, la = _cli(["ascii", src, txt, "--to-ascii"])
    res["to_ascii"] = dict(seconds=secs, launches=la,
                           bytes=os.path.getsize(txt + ".graph-txt"))
    back = os.path.join(tmp, "small_back")
    _, secs, la = _cli(["ascii", txt, back])
    res["from_ascii"] = dict(seconds=secs, launches=la)
    _same_csr(load_csr(back), small, "ascii round trip")

    # an arc list: every arc once, ids through the bijection, lines shuffled
    rng = np.random.default_rng(7)
    order = rng.permutation(m)
    s_ids = _bij(np.repeat(np.arange(n, dtype=np.int64), np.diff(co)))[order]
    t_ids = _bij(su)[order]
    rows = np.empty((m, 2 * ID_DIGITS + 2), dtype=np.uint8)
    rows[:, :ID_DIGITS] = _decimal(s_ids)
    rows[:, ID_DIGITS] = ord("\t")
    rows[:, ID_DIGITS + 1:-1] = _decimal(t_ids)
    rows[:, -1] = ord("\n")
    buf = rows.tobytes()
    del rows
    arcs = os.path.join(tmp, "arcs.txt")
    with open(arcs, "wb") as f:
        f.write(buf)
    t0 = time.perf_counter()
    ps, pt, used = native.parse_arcs(buf)
    parse_s = time.perf_counter() - t0
    if used != len(buf) or not (np.array_equal(ps, s_ids)
                                and np.array_equal(pt, t_ids)):
        raise AssertionError("the arc list parses to other ids")
    del ps, pt
    sc = os.path.join(tmp, "sc")
    _, secs, la = _cli(["scattered", arcs, sc])
    res["scattered"] = dict(seconds=secs, launches=la, text_bytes=len(buf),
                            parse_s=parse_s,
                            parse_MB_per_s=len(buf) / parse_s / 1e6)
    del buf
    ids = np.fromfile(sc + ".ids", dtype=">i8").astype(np.int64)
    both = np.empty(2 * m, dtype=np.int64)
    both[0::2], both[1::2] = s_ids, t_ids
    uniq, first = np.unique(both, return_index=True)
    if not np.array_equal(ids, uniq[np.argsort(first, kind="stable")]):
        raise AssertionError("scattered: .ids is not in first-appearance "
                             "order")
    del both, uniq, first, s_ids, t_ids
    perm = torch.from_numpy(_bij_inverse(ids)).to(dev)
    g = load_csr(sc)
    gs, gt = g.arcs()
    key = torch.sort((perm[gs] << 32) | perm[gt]).values
    ws, wt = small.arcs()
    if not torch.equal(key, (ws << 32) | wt):
        raise AssertionError("scattered: the arcs mapped back through .ids "
                             "differ from the source's")
    del g, gs, gt, key, ws, wt, perm

    sym = os.path.join(tmp, "small_sym")
    _, secs, la = _cli(["transform", "symmetrize", src, sym])
    res["symmetrize"] = dict(seconds=secs, launches=la)
    _, secs, la = _cli(["cc", sym, os.path.join(tmp, "cc")])
    res["cc"] = dict(seconds=secs, launches=la)
    comp = torch.from_numpy(np.fromfile(os.path.join(tmp, "cc"),
                                        dtype=np.int64)).to(dev)
    if not torch.equal(comp, A.connected_components(TR.symmetrize(small))):
        raise AssertionError("cli cc differs from CC of the symmetrization")
    return res


# the parallel phase: hosts of the one-process multi-host encode, rank
# processes of the two-process run, and the device lists of the sharded
# kernel decode (one device listed D times)
PARALLEL_HOSTS = 4
PARALLEL_RANKS = 2
PARALLEL_SHARES = (1, 4)
PARALLEL_DECODE_DEVICES = 2
RANK_DEADLINE_S = 600


def _parallel_rank(rank: int, tmp: str, digests: list, t_spawn: float
                   ) -> None:
    """One rank of the parallel phase's two-process run, in a process of
    its own on the card: join the gloo group (``file://`` in ``tmp``),
    encode its shard of ``tmp/{co,su}.npy`` on the card, wait while rank 0
    merges, then plan and decode its shard of the merged basename and hold
    its successors to ``digests[rank]`` (sha256 of the int32 bytes).  Rank
    0 writes every rank's timings to ``tmp/ranks.json``."""
    import torch.distributed as dist
    from webgraph_tpu_torch.parallel import multihost as MH

    start_s = time.time() - t_spawn
    t0 = time.perf_counter()
    dev = require_cuda()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    cuda_init_s = time.perf_counter() - t0
    got = MH.initialize("file://" + os.path.join(tmp, "rendezvous"),
                        PARALLEL_RANKS, rank, backend="gloo")
    if got != (rank, PARALLEL_RANKS):
        raise AssertionError(f"rank {rank}: initialize gave {got}")
    try:
        s = BVGraphSettings()
        co = np.load(os.path.join(tmp, "co.npy"))
        su = np.load(os.path.join(tmp, "su.npy"), mmap_mode="r")
        bounds = MH.shard_bounds(co, PARALLEL_RANKS)
        lo, hi = int(bounds[rank]), int(bounds[rank + 1])
        base = os.path.join(tmp, "ranks")
        t0 = time.perf_counter()
        MH.encode_shard(co, su, s, base, rank, lo, hi, threads=1,
                        backend="cuda", device=dev)
        encode_s = time.perf_counter() - t0
        dist.barrier()
        merge_s = None
        if rank == 0:
            t0 = time.perf_counter()
            MH.merge_shards(base, PARALLEL_RANKS, s)
            merge_s = time.perf_counter() - t0
        dist.barrier()
        bv = BVGraph.load(base)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        plan, plo, phi = MH.plan_shard_decode(bv, bv.data, rank,
                                              PARALLEL_RANKS)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        passes = resolve_halos(plan)
        torch.cuda.synchronize()
        resolve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pco, succ, filled = decode_to_csr(plan)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] for k in KERNELS}
        _decoded(launches, f"rank {rank}'s shard decode")
        if (plo, phi) != (lo, hi) or filled:
            raise AssertionError(f"rank {rank}: shard ({plo}, {phi}) for "
                                 f"({lo}, {hi}), {filled} arcs filled")
        if not np.array_equal(pco, co[lo:hi + 1] - co[lo]):
            raise AssertionError(f"rank {rank}: shard offsets differ")
        digest = hashlib.sha256(succ.cpu().numpy().tobytes()).hexdigest()
        if digest != digests[rank]:
            raise AssertionError(f"rank {rank}: shard successors differ")
        rec = dict(rank=rank, lo=lo, hi=hi, arcs=int(co[hi] - co[lo]),
                   process_start_s=start_s, cuda_init_s=cuda_init_s,
                   encode_s=encode_s, merge_s=merge_s, plan_s=plan_s,
                   resolve_s=resolve_s, resolve_passes=passes,
                   decode_to_csr_s=decode_s, launches=launches,
                   lanes=plan.lanes,
                   peak_bytes=torch.cuda.max_memory_allocated())
        recs = [None] * PARALLEL_RANKS
        dist.all_gather_object(recs, rec)
        if rank == 0:
            with open(os.path.join(tmp, "ranks.json"), "w") as f:
                json.dump(recs, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, card: str, graph, hco, hsu) -> dict:
    """Multi-host and multi-device at the slice's scale
    (``webgraph_tpu_torch/parallel``): the one-process multi-host encode
    on the card held byte-equal to the native encoder's threads; two rank
    processes on the one card encoding, merging and decoding their shards;
    the sharded kernel decode over the card listed 1 and 4 times; the
    sharded whole decode.  The directory is removed at the end."""
    import torch.multiprocessing as mp
    from webgraph_tpu_torch.parallel import multihost as MH
    from webgraph_tpu_torch.parallel import sharded as SH
    s = BVGraphSettings()
    n, m = graph.num_nodes, graph.num_arcs
    out = dict(card=card, nodes=n, arcs=m)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix=".parallel_smoke_", dir=ROOT)
    try:
        # 1. multi-host encode in one process: 4 shards on the card, merged
        base = os.path.join(tmp, "hosts")
        rep = {}
        t0 = time.perf_counter()
        MH.store_multihost(graph, base, PARALLEL_HOSTS, settings=s,
                           backend="cuda", report=rep)
        store_s = time.perf_counter() - t0
        nat = os.path.join(tmp, "native")
        t0 = time.perf_counter()
        BVGraph.store(CSRGraph(hco, hsu, device="cpu"), nat,
                      backend="native", num_threads=PARALLEL_HOSTS)
        native_s = time.perf_counter() - t0
        for ext in (".graph", ".offsets"):
            if _sha256(base + ext) != _sha256(nat + ext):
                raise AssertionError(f"the {PARALLEL_HOSTS}-host encode's "
                                     f"{ext} differs from native.bv_encode("
                                     f"threads={PARALLEL_HOSTS})")
        if _props_lines(base + ".properties") != _props_lines(
                nat + ".properties"):
            raise AssertionError("the multi-host encode's properties differ")
        out["hosts"] = dict(
            hosts=PARALLEL_HOSTS, shard_bounds=rep["bounds"],
            shard_encode_s=rep["shard_s"], merge_s=rep["merge_s"],
            store_s=store_s, native_threads_store_s=native_s,
            graph_bytes=os.path.getsize(base + ".graph"),
            byte_identical_to_native_threads=True,
            **_read_back(base, graph, "multi-host store"))

        # 2. two rank processes sharing the card (gloo, file://)
        torch.cuda.empty_cache()
        np.save(os.path.join(tmp, "co.npy"), hco)
        np.save(os.path.join(tmp, "su.npy"), hsu.astype(np.int32))
        rb = MH.shard_bounds(hco, PARALLEL_RANKS)
        digests = [hashlib.sha256(hsu[hco[lo]:hco[hi]].astype(np.int32)
                                  .tobytes()).hexdigest()
                   for lo, hi in zip(rb[:-1], rb[1:])]
        t_spawn = time.time()
        t0 = time.perf_counter()
        ctx = mp.start_processes(_parallel_rank,
                                 args=(tmp, digests, t_spawn),
                                 nprocs=PARALLEL_RANKS, join=False,
                                 start_method="spawn")
        # meanwhile, on the host: the encode the merge must equal
        t1 = time.perf_counter()
        gb, _gbits, ob, _obits, _st = native.bv_encode(
            hco, hsu, s, threads=PARALLEL_RANKS)
        native2_s = time.perf_counter() - t1
        want = [hashlib.sha256(b.tobytes()).hexdigest() for b in (gb, ob)]
        del gb, ob
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > RANK_DEADLINE_S:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the ranks ran past "
                                     f"{RANK_DEADLINE_S} s")
        ranks_s = time.perf_counter() - t0
        rbase = os.path.join(tmp, "ranks")
        if [_sha256(rbase + ext) for ext in (".graph", ".offsets")] != want:
            raise AssertionError(f"the {PARALLEL_RANKS} ranks' merge differs "
                                 f"from native.bv_encode(threads="
                                 f"{PARALLEL_RANKS})")
        with open(os.path.join(tmp, "ranks.json")) as f:
            ranks = json.load(f)
        out["ranks"] = dict(ranks=PARALLEL_RANKS, backend="gloo",
                            shard_bounds=rb.tolist(), wall_s=ranks_s,
                            native_threads_encode_s=native2_s,
                            merge_byte_identical=True, shards_equal=True,
                            per_rank=ranks)

        # 3. the sharded kernel decode of the slice's resolved plan
        data, offsets, _n, _m, _s, _src, _t = synth_input(n)
        outd = native.decode_outdegrees(data, offsets, s.outdegree_coding)
        plan = kplan.plan_kernel_decode(offsets, outd, s, data, device=dev)
        resolve_halos(plan)
        _co, want_succ, _filled = decode_to_csr(plan)
        if not torch.equal(want_succ, graph.succ):
            raise AssertionError("the unsharded decode differs")
        one_ms = min(cuda_ms(lambda: kdecode.decode_chunked(plan))
                     for _ in range(3))
        shares = {}
        for D in PARALLEL_SHARES:
            mesh = (SH.make_mesh() if D == 1
                    else SH.make_mesh(["cuda:0"] * D))
            torch.cuda.synchronize()
            _build.reset_launches()
            store, diag = SH.decode_sharded_kernel(plan, mesh)
            torch.cuda.synchronize()
            launched = _build.LAUNCHES["bv_decode_lanes"]
            if launched != D:
                raise AssertionError(f"{D} shares launched B1 {launched} "
                                     f"times")
            if bool(kdecode.lanes_flagged(plan, diag).any()):
                raise AssertionError(f"{D} shares flagged lanes")
            got = kcompact.compact(plan.compact_plan, store)
            if not torch.equal(got, want_succ):
                raise AssertionError(f"{D} shares differ from the "
                                     f"unsharded decode")
            del got, store, diag
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                SH.decode_sharded_kernel(plan, mesh)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            shares[D] = dict(devices=[str(d) for d in mesh],
                             b1_launches=launched, call_ms=min(times),
                             equal_to_unsharded=True)
        out["sharded_kernel"] = dict(lanes=plan.lanes,
                                     unsharded_b1_ms=one_ms, shares=shares)
        del plan, want_succ
        torch.cuda.empty_cache()

        # 4. the sharded whole decode, one node range per listed device
        mesh = SH.make_mesh(["cuda:0"] * PARALLEL_DECODE_DEVICES)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        dco, dsu = SH.decode_sharded(data, offsets, s, mesh)
        ds_s = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] for k in KERNELS}
        _decoded(launches, "decode_sharded")
        if not (np.array_equal(dco, hco) and np.array_equal(dsu, hsu)):
            raise AssertionError("decode_sharded differs from the native "
                                 "decode")
        out["decode_sharded"] = dict(devices=[str(d) for d in mesh],
                                     seconds=ds_s, launches=launches,
                                     equal_to_native=True)
        del dco, dsu, data, offsets, outd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(peak_bytes=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return out


def _pack_profile(graph, s) -> dict:
    """``profile_window`` over the pack of the slice's first chunk (its
    nodes' references selected over its own cost matrix)."""
    co = graph.offsets.cpu().numpy()
    hi = int(vencode.chunk_bounds_by_arcs(co, vencode.DEFAULT_CHUNK_ARCS)[1])
    cco, csu = graph.offsets[:hi + 1], graph.succ[:int(co[hi])]
    refs, _ = vencode.select_refs(vencode.cost_matrix(cco, csu, s),
                                  np.diff(co[:hi + 1]), s)
    vencode.pack_chunk(cco, csu, s, refs)
    prof = profile_window(lambda: vencode.pack_chunk(cco, csu, s, refs))
    return dict(nodes=hi, arcs=int(co[hi]), **prof)


class Steps:
    """Per analytics step: seconds on the host clock ending in a
    synchronise, the peak device bytes while it ran, and its summary."""

    def __init__(self):
        self.rows = {}

    def run(self, name: str, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.rows[name] = dict(seconds=time.perf_counter() - t0,
                               peak_bytes=torch.cuda.max_memory_allocated())
        return out

    def note(self, name: str, **summary) -> None:
        self.rows[name].update(summary)


def arc_sources(g) -> torch.Tensor:
    """The source of every arc, int64, built here rather than by the
    graph class under test."""
    return torch.repeat_interleave(
        torch.arange(g.num_nodes, device=g.device),
        g.offsets[1:] - g.offsets[:-1], output_size=g.num_arcs)


def check_bfs(g, src: torch.Tensor, root: int, dist: torch.Tensor) -> None:
    """A certificate of BFS distances from ``root``, in torch ops on the
    device: every arc (u, v) with u reached has v reached and dist[v] <=
    dist[u] + 1 (so dist is at most the distance, and no unreached node has
    a reached predecessor); every reached v but the root has a predecessor
    at dist[v] - 1 (so dist is at least the distance)."""
    tgt = g.succ.to(torch.int64)
    du, dv = dist[src], dist[tgt]
    ru = du >= 0
    if int(dist[root]) != 0:
        raise AssertionError("BFS: the root is not at distance 0")
    if bool((ru & (dv < 0)).any()):
        raise AssertionError("BFS: an unreached node has a reached "
                             "predecessor")
    if bool((ru & (dv > du + 1)).any()):
        raise AssertionError("BFS: an arc would shorten a distance")
    has = torch.zeros(g.num_nodes, dtype=torch.bool, device=g.device)
    has[tgt[ru & (du == dv - 1)]] = True
    has[root] = True
    if bool(((dist >= 0) & ~has).any()):
        raise AssertionError("BFS: a reached node has no predecessor one "
                             "level up")


def phase_analytics(dev, graph, hco, hsu) -> dict:
    """The analytics on the slice's device CSR, each step timed alone and
    then checked against something independent of the code under test:
    the native decode's host CSR (``hco``, ``hsu``), scipy, or a
    certificate computed here."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    g = graph
    n, m = g.num_nodes, g.num_arcs
    steps = Steps()
    rng = np.random.default_rng(5)
    t_start = time.perf_counter()
    _build.reset_launches()

    # 1. Stats against numpy bincounts of the host CSR
    st = steps.run("stats", lambda: compute_stats(g))
    outd = np.diff(hco)
    indeg = np.bincount(hsu, minlength=n)
    src_h = np.repeat(np.arange(n, dtype=np.int64), outd)
    want = dict(nodes=n, arcs=m, loops=int(np.count_nonzero(src_h == hsu)),
                maxoutdegree=int(outd.max()), maxindegree=int(indeg.max()),
                dangling=int((outd == 0).sum()),
                terminal=int((indeg == 0).sum()))
    for k, v in want.items():
        if st[k] != v:
            raise AssertionError(f"stats: {k} {st[k]} != {v}")
    for key, h in (("outdegree_distribution", np.bincount(outd)),
                   ("indegree_distribution", np.bincount(indeg))):
        if not np.array_equal(st[key].cpu().numpy(), h):
            raise AssertionError(f"stats: {key} differs")
    steps.note("stats", **want, avgoutdegree=st["avgoutdegree"])

    # 2. Transpose: offsets from the indegrees, sampled predecessor lists
    gt = steps.run("transpose", lambda: TR.transpose(g))
    want_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(indeg, out=want_off[1:])
    go, gsu = gt.offsets.cpu().numpy(), gt.succ.cpu().numpy()
    if not np.array_equal(go, want_off):
        raise AssertionError("transpose: offsets differ from the indegrees")
    xs = np.sort(rng.choice(n, SAMPLE, replace=False))
    lut = np.zeros(n, dtype=bool)
    lut[xs] = True
    sel = np.flatnonzero(lut[hsu])
    preds = src_h[sel][np.lexsort((src_h[sel], hsu[sel]))]
    got = np.concatenate([gsu[go[x]:go[x + 1]] for x in xs])
    if not np.array_equal(got, preds):
        raise AssertionError("transpose: sampled predecessor lists differ")
    del go, gsu, lut, sel, preds, got
    steps.note("transpose", sampled_nodes=SAMPLE)

    # 3. HyperBall to convergence; every round, sampled registers against
    #    a merge of the previous round's rows on the host
    hb = steps.run("hyperball_init", lambda: A.HyperBall(
        g, log2m=HB_LOG2M, seed=1, gt=gt, do_sum_of_distances=True,
        do_sum_of_inverse_distances=True))
    # the constructor's estimate of every node: one launch since the reset
    if _build.LAUNCHES["hyperball_estimate"] != 1:
        raise AssertionError("HyperBall's init launched hyperball_estimate "
                             f"{_build.LAUNCHES['hyperball_estimate']} times")
    xs = np.sort(rng.choice(n, SAMPLE, replace=False))
    lists = [hsu[hco[x]:hco[x + 1]] for x in xs]
    need = np.unique(np.concatenate([xs] + lists))
    need_t, xs_t = (torch.from_numpy(a).to(dev) for a in (need, xs))
    at_x = np.searchsorted(need, xs)
    at_succ = [np.searchsorted(need, ys) for ys in lists]
    round_s, round_profile, merges, estimates = [], None, [], []
    torch.cuda.reset_peak_memory_stats()
    while True:
        prev = hb.regs[need_t].cpu().numpy()
        torch.cuda.synchronize()
        before = _build.LAUNCHES["hyperball_merge"]
        est_before = _build.LAUNCHES["hyperball_estimate"]
        t0 = time.perf_counter()
        if hb.iteration == 1:   # round 2, dense, under the profiler
            round_profile = profile_window(hb.iterate)
        else:
            hb.iterate()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        # one merge launch a round, bar a sparse round with no node listed
        merges.append(_build.LAUNCHES["hyperball_merge"] - before)
        if merges[-1] != 1 and (merges[-1] > 1 or hb.arcs_touched[-1]
                                or hb.mode_history[-1] == "dense"):
            raise AssertionError(f"HyperBall round {hb.iteration} launched "
                                 f"hyperball_merge {merges[-1]} times")
        # one estimate launch a round with a changed counter
        estimates.append(_build.LAUNCHES["hyperball_estimate"] - est_before)
        if estimates[-1] != int(hb.modified > 0):
            raise AssertionError(f"HyperBall round {hb.iteration} launched "
                                 f"hyperball_estimate {estimates[-1]} times")
        cur = hb.regs[xs_t].cpu().numpy()
        for i, x in enumerate(xs):
            w = prev[at_x[i]]
            if len(at_succ[i]):
                w = np.maximum(w, prev[at_succ[i]].max(axis=0))
            if not np.array_equal(cur[i], w):
                raise AssertionError(f"HyperBall round {hb.iteration}: "
                                     f"registers of node {x} differ")
        if hb.modified == 0:
            break
    nf = hb.neighbourhood_function
    sums = (hb.sum_of_distances, hb.sum_of_inverse_distances)
    if not (np.isfinite(nf).all()
            and all(bool(torch.isfinite(s).all() & (s >= 0).all())
                    for s in sums)):
        raise AssertionError("HyperBall: non-finite or negative results")
    steps.rows["hyperball"] = dict(
        seconds=sum(round_s), peak_bytes=torch.cuda.max_memory_allocated(),
        log2m=HB_LOG2M, rounds=hb.iteration, round_s=round_s,
        mode_history=hb.mode_history, arcs_touched=hb.arcs_touched,
        merge_launches=merges, estimate_launches=estimates, nf=nf, effective_diameter=A.effective_diameter(nf, 0.9),
        sampled_nodes=SAMPLE, round2_profile=round_profile)
    del hb, sums, prev, cur

    # 4. BFS from node 0, held to a certificate
    src = arc_sources(g)
    dist, rounds = steps.run("bfs", lambda: A.bfs(g, [0]))
    check_bfs(g, src, 0, dist)
    steps.note("bfs", rounds=rounds, reached=int((dist >= 0).sum()),
               max_dist=int(dist.max()))
    del dist

    # 5. CC of the symmetrized graph: constant across arcs, scipy's count,
    #    ids in first-appearance order
    gs = steps.run("symmetrize", lambda: TR.symmetrize(g))
    steps.note("symmetrize", arcs=gs.num_arcs)
    comp = steps.run("cc", lambda: A.connected_components(gs))
    del gs
    k = int(comp.max()) + 1
    if bool((comp[src] != comp[g.succ.to(torch.int64)]).any()):
        raise AssertionError("CC: a label changes across an arc")
    first = torch.full((k,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, comp, torch.arange(n, device=dev), "amin")
    if int(first[0]) != 0 or not bool((first[1:] > first[:-1]).all()):
        raise AssertionError("CC: ids not in first-appearance order")
    mat = csr_matrix((np.ones(m), hsu, hco), shape=(n, n))
    kw, _ = connected_components(mat, directed=True, connection="weak")
    if kw != k:
        raise AssertionError(f"CC: {k} components, scipy {kw}")
    steps.note("cc", components=k, largest=int(torch.bincount(comp).max()))
    del comp, first

    # 6. SCC and buckets against scipy's strong components
    info = {}
    k, scc = steps.run("scc", lambda: A.strongly_connected_components(
        g, stats=info))
    buckets = steps.run("scc_buckets", lambda: A.scc_buckets(g, scc))
    ks, lab = connected_components(mat, directed=True, connection="strong")
    del mat
    scc_h = scc.cpu().numpy()
    if ks != k or np.unique(scc_h * ks + lab).size != k:
        raise AssertionError(f"SCC: {k} components, scipy {ks}, or another "
                             f"partition")
    ls, lt = lab[src_h], lab[hsu]
    leaves = np.zeros(ks, dtype=bool)
    leaves[ls[ls != lt]] = True
    looped = np.zeros(ks, dtype=bool)
    looped[lab[src_h[src_h == hsu]]] = True
    want_b = ~leaves & ((np.bincount(lab, minlength=ks) > 1) | looped)
    to_s = np.empty(k, dtype=np.int64)
    to_s[scc_h] = lab
    if not np.array_equal(buckets.cpu().numpy(), want_b[to_s]):
        raise AssertionError("SCC: buckets differ from scipy's components")
    steps.note("scc", components=k, largest=int(np.bincount(scc_h).max()),
               **info)
    steps.note("scc_buckets", buckets=int(buckets.sum()))
    del scc, buckets, scc_h, ls, lt, lab, src_h

    # 7. Harmonic centrality of seeded sources on the packed path; some
    #    against sums of 1/d over certificate-checked BFS distances
    sources = np.sort(rng.choice(n, CENTRALITY_SOURCES, replace=False))
    if CENTRALITY_SOURCES * n <= CE.DENSE_LIMIT:
        raise AssertionError("centrality would not take the packed path")
    hc = steps.run("centrality", lambda: A.harmonic_centrality(
        g, sources=torch.from_numpy(sources).to(dev),
        batch=CENTRALITY_SOURCES)).cpu().numpy()
    for i in range(CENTRALITY_CHECKED):
        d, _ = A.bfs(g, [int(sources[i])])
        check_bfs(g, src, int(sources[i]), d)
        cnt = torch.bincount(d[d > 0]).cpu().numpy()
        want_h = 0.0
        for level in range(1, len(cnt)):
            want_h += (1.0 / level) * cnt[level]
        if not np.isclose(hc[i], want_h, rtol=1e-12, atol=0):
            raise AssertionError(f"centrality of {sources[i]}: {hc[i]} != "
                                 f"{want_h}")
    # where the packed path's time goes: its arc setup and one level
    level_profile = profile_window(lambda: A.harmonic_centrality(
        g, sources=torch.from_numpy(sources).to(dev),
        batch=CENTRALITY_SOURCES, max_dist=1))
    steps.note("centrality", sources=CENTRALITY_SOURCES, packed=True,
               checked=CENTRALITY_CHECKED, values=hc.tolist(),
               one_level_profile=level_profile)
    del src, d

    # 8. The HyperBall modes on the 20,000-node check graph: the same
    #    registers and the same neighbourhood function
    co, su = synthesize_webgraph(CHECK_NODES, seed=3)
    sg = CSRGraph(co, su, device=dev)
    sgt = TR.transpose(sg)
    runs = {}
    t0 = time.perf_counter()
    for name, opts in (("dense", {}), ("systolic_local", dict(gt=sgt)),
                     ("external", dict(gt=sgt, external_chunk=1 << 16))):
        runs[name] = A.HyperBall(sg, log2m=HB_LOG2M, seed=2, **opts)
        runs[name].run()
    torch.cuda.synchronize()
    regs = {k: np.asarray(h.regs.cpu() if isinstance(h.regs, torch.Tensor)
                          else h.regs) for k, h in runs.items()}
    for k, h in runs.items():
        if not np.array_equal(regs[k], regs["dense"]):
            raise AssertionError(f"HyperBall {k}: registers differ")
        if h.neighbourhood_function != runs["dense"].neighbourhood_function:
            raise AssertionError(f"HyperBall {k}: the NF differs")
    steps.rows["modes_small"] = dict(
        seconds=time.perf_counter() - t0, nodes=CHECK_NODES, arcs=sg.num_arcs,
        modes={k: h.mode_history for k, h in runs.items()})

    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    r = steps.rows
    return dict(
        nodes=n, arcs=m, seconds=time.perf_counter() - t_start,
        hyperball_run_s=r["hyperball_init"]["seconds"]
        + r["hyperball"]["seconds"],
        rounds=r["hyperball"]["rounds"],
        s_per_round=r["hyperball"]["seconds"] / r["hyperball"]["rounds"],
        bfs_s=r["bfs"]["seconds"], cc_s=r["cc"]["seconds"],
        scc_s=r["scc"]["seconds"], centrality_s=r["centrality"]["seconds"],
        peak_bytes=max(v.get("peak_bytes", 0) for v in r.values()),
        launches=launches, steps=r)


# ---- the big phase: the sliced decode past 2^31 arcs -------------------

# n = 2^27 nodes, each with 12 local successors (x+1 ... x+12 mod n: copy
# blocks and intervals) and 5 from a seeded hash of (x, j) mod n
# (residuals): about 2.28G arcs (past 2^31) under 2^31 nodes, a stream past
# 2^32 bits.  Made on the card and encoded on the host in node ranges of
# 2^24 (one native encode on every host thread each), joined by
# merge_shards; decoded in slices of 2^27 arcs.  The generator is the torch
# copy of tests/torch_big_graph.WebLikeGraph.
BIG_NODES = 1 << 27
BIG_RANGE = 1 << 24
BIG_SLICE_ARCS = 1 << 27
BIG_SEED = 11
BIG_LOCAL = 12
BIG_RANDOM = 5
# the limits the run must pass: arcs past 2^31 (nodes under it), a stream
# past 2^32 bits
BIG_ARCS_PAST = 1 << 31
BIG_BITS_PAST = 1 << 32


def web_like_slice(n: int, seed: int, lo: int, hi: int, device) -> tuple:
    """(csr_off int64[hi - lo + 1], succ int64) of nodes [lo, hi) of the
    big phase's graph, on ``device``: each list the local and the hashed
    successors, sorted and deduplicated."""
    x = torch.arange(lo, hi, dtype=torch.int64, device=device)[:, None]
    local = (x + torch.arange(1, BIG_LOCAL + 1, device=device)) % n
    rnd = mix64(x * K_X + torch.arange(BIG_RANDOM, device=device) * K_J
                + seed) % n
    row = torch.sort(torch.cat([local, rnd], 1), 1).values
    del x, local, rnd
    keep = torch.ones_like(row, dtype=torch.bool)
    keep[:, 1:] = row[:, 1:] != row[:, :-1]
    co = torch.zeros(hi - lo + 1, dtype=torch.int64, device=device)
    torch.cumsum(keep.sum(1), 0, out=co[1:])
    return co, row[keep]


def _big_equal(co, succ, lo: int, hi: int, dev) -> bool:
    eco, esu = web_like_slice(BIG_NODES, BIG_SEED, lo, hi, dev)
    return torch.equal(co, eco) and torch.equal(succ, esu.to(torch.int32))


def phase_big(dev, card: str) -> dict:
    """The sliced decode past 2^31 arcs: the big graph generated and
    encoded range by range into a basename in ``.big_smoke_*/`` under the
    checkout (removed at the end), then ``decode_big_slices`` on the card
    -- launch counts reset before each slice, B1 and B2 launched in every
    slice, each slice ``torch.equal`` to the generator, on the kernel
    route with no arc decoded on the host -- and ``load_csr`` of the whole
    basename, which must give the same CSR or raise before any launch."""
    from webgraph_tpu_torch.ops.bigdecode import decode_big_slices
    from webgraph_tpu_torch.parallel.multihost import (encode_shard,
                                                       merge_shards)
    s = BVGraphSettings()
    n = BIG_NODES
    threads = os.cpu_count() or 1
    out = dict(card=card, nodes=n, range_nodes=BIG_RANGE,
               slice_arcs=BIG_SLICE_ARCS, encode_threads=threads)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".big_smoke_", dir=ROOT)
    try:
        base = os.path.join(tmp, "big")
        gen_s = enc_s = 0.0
        m = 0
        starts = list(range(0, n, BIG_RANGE))
        for k, lo in enumerate(starts):
            hi = min(lo + BIG_RANGE, n)
            t0 = time.perf_counter()
            co, su = web_like_slice(n, BIG_SEED, lo, hi, dev)
            co_h, su_h = co.cpu().numpy(), su.cpu().numpy()
            del co, su
            gen_s += time.perf_counter() - t0
            m += int(co_h[-1])
            t0 = time.perf_counter()
            encode_shard(co_h, su_h, s, base, k, lo, hi, threads=threads,
                         node_base=lo)
            enc_s += time.perf_counter() - t0
            del co_h, su_h
        t0 = time.perf_counter()
        merge_shards(base, len(starts), s)
        merge_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        bvg = BVGraph.load(base)
        offsets = bvg.offsets_array()
        outd = native.decode_outdegrees(bvg.data, offsets,
                                        s.outdegree_coding)
        prep_s = time.perf_counter() - t0
        bits = int(offsets[-1])
        if not (n < BIG_ARCS_PAST < m and bits > BIG_BITS_PAST
                and bvg.num_arcs == m and int(outd.sum()) == m):
            raise AssertionError(f"big: {n} nodes, {m} arcs, {bits} bits")
        out.update(arcs=m, bits=bits, bits_per_link=bits / m,
                   graph_bytes=os.path.getsize(base + ".graph"),
                   generate_s=gen_s, encode_s=enc_s, merge_s=merge_s,
                   prep_s=prep_s)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        rep, per_slice = [], []
        it = decode_big_slices(offsets, outd, s, bvg.data,
                               slice_arcs=BIG_SLICE_ARCS, report=rep)
        x, check_s = 0, 0.0
        t0 = time.perf_counter()
        while True:
            _build.reset_launches()
            try:
                lo, hi, co, succ = next(it)
            except StopIteration:
                break
            la = {k: _build.LAUNCHES[k] for k in KERNELS}
            _decoded(la, f"big slice [{lo}, {hi})")
            t1 = time.perf_counter()
            if lo != x or not _big_equal(co, succ, lo, hi, dev):
                raise AssertionError(f"big slice [{lo}, {hi}) differs from "
                                     f"the generator")
            torch.cuda.synchronize()
            check_s += time.perf_counter() - t1
            per_slice.append(la)
            x = hi
            del co, succ
        sliced_s = time.perf_counter() - t0
        bad = [r for r in rep if r["route"] != "kernel" or r["fallback_arcs"]]
        if x != n or bad:
            raise AssertionError(f"big: slices reach node {x}; off the "
                                 f"kernel route or filled on the host: "
                                 f"{bad[:3]}")
        out["sliced"] = dict(
            slices=len(rep), seconds=sliced_s, check_s=check_s,
            halo_decode_s=[r["halo_decode_s"] for r in rep],
            plan_s=[r["plan_s"] for r in rep],
            decode_s=[r["decode_s"] for r in rep],
            arcs=[r["arcs"] for r in rep], launches_per_slice=per_slice,
            peak_above_resident=torch.cuda.max_memory_allocated()
            - resident, fallback_arcs=0, equal_to_generator=True)
        del it, rep, outd, offsets, bvg
        torch.cuda.empty_cache()

        # the whole basename through one cold plan
        _build.reset_launches()
        try:
            csr, load_s, load_peak = _timed(lambda: load_csr(base))
        except Exception as e:  # recorded; a launch before it is a fault
            la = {k: _build.LAUNCHES[k] for k in KERNELS}
            if any(la.values()):
                raise AssertionError(f"big: load_csr raised after "
                                     f"launching {la}: {e!r}")
            out["load_csr"] = dict(raised=f"{type(e).__name__}: {e}",
                                   launches=la)
        else:
            la = {k: _build.LAUNCHES[k] for k in KERNELS}
            t0 = time.perf_counter()
            ok = csr.num_nodes == n and csr.num_arcs == m
            for lo in starts:
                hi = min(lo + BIG_RANGE, n)
                a, b = int(csr.offsets[lo]), int(csr.offsets[hi])
                ok = ok and _big_equal(csr.offsets[lo:hi + 1] - a,
                                       csr.succ[a:b], lo, hi, dev)
            if not ok:
                raise AssertionError("big: load_csr gave a CSR that "
                                     "differs from the generator")
            out["load_csr"] = dict(seconds=load_s,
                                   peak_above_resident=load_peak,
                                   launches=la, report=csr.report,
                                   check_s=time.perf_counter() - t0,
                                   equal_to_generator=True)
            del csr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def profile_window(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: wall time, the device's busy
    time (kernels and copies) and its share, and the device time of the
    largest kernels and of the operators that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0:
            continue
        # a device activity (kernel, copy, set), or the operator that
        # launched it: the two lists split the same device time two ways
        rows = kernels if e.device_type == DeviceType.CUDA else ops
        rows.append((e.key[:60], us / 1e3, e.count))
    for rows in (kernels, ops):
        rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / wall_ms),
                top=[dict(name=k, device_ms=v, count=c)
                     for k, v, c in kernels[:8]],
                ops=[dict(name=k, device_ms=v, count=c)
                     for k, v, c in ops[:10]])


def main() -> int:
    t_start = time.perf_counter()
    dev, card = phase_device()
    ptxas = phase_build()
    # the slice's synthetic is made and encoded on the host (into its
    # cache) in a thread beside the kernels phase, whose rows say so
    slice_input = _beside(lambda: synth_input(SLICE_NODES))
    errors = Errors()
    phase_kernels(dev, errors)
    made, _ = slice_input()
    input_src, input_made_s = made[5], made[6]
    del made
    t0 = time.perf_counter()
    probes = phase_probes(dev, errors)
    probes_s = time.perf_counter() - t0
    ctx, res = phase_slice(dev, errors, SLICE_NODES)
    res.update(input_made=input_src, input_made_s=input_made_s)
    emit("slice", res)
    torch.cuda.empty_cache()
    hubs = phase_hubs(dev, card, errors)
    emit("hubs", hubs)
    files = phase_files(dev, card, **ctx, errors=errors)
    emit("files", files)
    t0 = time.perf_counter()
    enc = phase_encode(dev, card, **ctx)
    enc.update(seconds=time.perf_counter() - t0,
               files_native_8thread_store_s=files["store_s"]["BVGraph"])
    emit("encode", enc)
    emit("labels", phase_labels(dev, card, **ctx,
                                digest=enc["slice_digest"]))
    emit("cli", phase_cli(dev, card, **ctx))
    emit("parallel", phase_parallel(dev, card, **ctx))
    analytics = phase_analytics(dev, **ctx)
    emit("analytics", analytics)
    del ctx
    torch.cuda.empty_cache()
    emit("big", phase_big(dev, card))
    ef = files["ef_kernel"]
    g500 = hubs["graph500"]
    for k, part in (("bv_decode_lanes_split", "b1"),
                    ("split_merge", "merge")):
        res["launches"][k] = g500["launches"][k]
        res["bounds"][k] = g500[part]["bound"]
        res["library_ms"][k] = None
    times = {"bv_decode_lanes": (res["decode_ms"], res["decode_plain_ms"]),
             "bv_decode_lanes_split": (g500["b1"]["ms"],
                                       g500["b1"]["plain_ms"]),
             "split_merge": (g500["merge"]["ms"], g500["merge"]["plain_ms"]),
             "compact_runs": (res["compact_ms"], res["compact_plain_ms"]),
             "hyperball_merge": (res["hyperball_merge"]["dense"]["ms"],
                                 res["hyperball_merge"]["dense"]["plain_ms"]),
             "hyperball_estimate": (
                 res["hyperball_merge"]["estimate"]["ms"],
                 res["hyperball_merge"]["estimate"]["plain_ms"]),
             "ef_decode": (ef["ms"], ef["plain_ms"])}
    # the estimate's launches: the analytics phase's, reset at its start
    res["launches"]["hyperball_estimate"] = (
        analytics["launches"]["hyperball_estimate"])
    if res["launches"]["hyperball_estimate"] <= 0:
        raise AssertionError("the main path never launched "
                             "hyperball_estimate")
    res["launches"]["ef_decode"] = ef["launches"]
    res["bounds"]["ef_decode"] = ef["bound"]
    res["library_ms"]["ef_decode"] = None
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=res["launches"][k],
                    max_abs_err=errors.err[k], ms=times[k][0],
                    plain_ms=times[k][1], bound_ms=res["bounds"][k][0],
                    bound_by=res["bounds"][k][1],
                    library_ms=res["library_ms"][k])
               for k, v in KERNELS.items()]
    # a probe site's ms, plain_ms and bound_ms: the sums over its cases;
    # no single library call computes a probe's chain of steps
    kernels += [dict(name=k, route="cuda", source=_CS + src, replaces=rep,
                     launches=probes[k]["launches"],
                     max_abs_err=errors.err[k], ms=probes[k]["ms"],
                     plain_ms=probes[k]["plain_ms"],
                     bound_ms=probes[k]["bound_ms"],
                     bound_by=probes[k]["bound_by"], library_ms=None)
                for k, (src, rep) in PROBE_SITES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", dict(seconds=time.perf_counter() - t_start,
                       probes_s=probes_s, ptxas=ptxas,
                       line_wall_s=dict(_WALL["lines"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
