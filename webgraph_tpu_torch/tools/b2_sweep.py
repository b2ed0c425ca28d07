"""Time variants of the compaction kernel (B2) on one synthetic graph.

Each variant is a CUDA source and a set of ``-D`` macros of
``csrc/compact.cu``: ``WG_B2_TILE`` (output positions a tile),
``WG_B2_THREADS``, ``WG_B2_K`` (vectors a thread reads before it stores),
``WG_B2_CAP`` (runs of a tile in shared memory at a time), ``WG_B2_LOAD``
(1: aligned 16-byte reads and a shift, 0: 4-byte reads), ``WG_B2_TMA`` (1:
bulk copies into a two-stage ring), ``WG_B2_PERSIST`` (blocks per SM of a
persistent grid, 0: one block a tile) and ``WG_B2_MINB`` (blocks per SM
that ptxas must fit in the registers, 0: not given).  The earlier design,
a binary search in device memory for every position, is
``tools/b2_global_search.cu``.  Every variant is built with nvcc (all at
once), run on the slice's resolved plan (planned anew for its tile), held
exactly against the output of the kernel the port launches (itself held
against ``compact_plain``), and timed with CUDA events in turns: the
variants in order, then in reverse (A B B A), ``--turns`` times in all.
In the same turns: ``torch.index_select`` over a prebuilt source index
(the library yardstick) and a device-to-device ``copy_`` of the m int32
(the card's rate for the same bytes).  ptxas's registers, stack and
spills stand beside each variant.

Usage (one CUDA device)::

    python -m webgraph_tpu_torch.tools.b2_sweep [--nodes N] [--turns 4] \\
        [--reps 10] [--variant 'WG_B2_K=8,WG_B2_TILE=8192'] ...

One JSON line per variant and yardstick, then one line comparing each
variant with the earlier design turn by turn, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from .. import native, require_cuda
from ..core.graph import expand_ranges
from ..ops import _build, kcompact, kplan
from ..ops.csr import decode_to_csr
from ..settings import BVGraphSettings
from ..utils.synth import synthesize_webgraph

_PKG = os.path.dirname(_build.BUILD_DIR)
CSRC = os.path.join(_PKG, "csrc", "compact.cu")
EARLIER_SRC = os.path.join(_PKG, "tools", "b2_global_search.cu")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA datasheet)
# beside the shipped macros (LOAD 0, TILE 8192, K 4, THREADS 256): the
# 16-byte reads at the first design's tile and at the shipped one, the
# launch shape, register caps, and the staged (TMA) ring
DEFAULT_VARIANTS = (
    "WG_B2_LOAD=1,WG_B2_TILE=4096", "WG_B2_LOAD=1", "WG_B2_TILE=4096",
    "WG_B2_TILE=16384", "WG_B2_K=2", "WG_B2_K=8", "WG_B2_THREADS=128",
    "WG_B2_THREADS=512", "WG_B2_PERSIST=4", "WG_B2_MINB=8",
    "WG_B2_K=2,WG_B2_MINB=8",
    "WG_B2_TMA=1,WG_B2_TILE=4096,WG_B2_PERSIST=4",
    "WG_B2_TMA=1,WG_B2_CAP=64,WG_B2_PERSIST=3")


def shipped_tile() -> int:
    with open(CSRC) as f:
        return int(re.search(r"#define WG_B2_TILE (\d+)", f.read()).group(1))


def launcher(lib, cp, store, out):
    def launch():
        _build.check(lib.wg_compact_runs(
            store.data_ptr(), store.numel(), out.data_ptr(), cp.m,
            cp.arc_start.data_ptr(), cp.src0.data_ptr(), cp.valid.data_ptr(),
            cp.tile_run0.data_ptr(), cp.n_tiles, cp.tile,
            _build.stream_ptr(store)), "b2 variant")
    return launch


def event_ms(fn, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=18_500_000)
    ap.add_argument("--variant", action="append",
                    help="comma-separated macros of csrc/compact.cu")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    dev = require_cuda()
    tile0 = shipped_tile()
    rows = [("global_search", EARLIER_SRC, "", 4096),
            ("port", CSRC, "", tile0)]
    for defs in args.variant or DEFAULT_VARIANTS:
        m = re.search(r"WG_B2_TILE=(\d+)", defs)
        rows.append((defs, CSRC, defs, int(m.group(1)) if m else tile0))
    builds = [_build.start_variant(src, defs, "b2sweep")
              for _, src, defs, _ in rows]

    t0 = time.perf_counter()
    s = BVGraphSettings()
    co, su = synthesize_webgraph(args.nodes)
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s,
                                                  threads=os.cpu_count() or 1)
    offsets = native.decode_offset_stream(offs, args.nodes, s.offset_coding)
    outd = native.decode_outdegrees(graph, offsets, s.outdegree_coding)
    plan = kplan.plan_kernel_decode(offsets, outd, s, graph, device=dev)
    _, succ, filled = decode_to_csr(plan)   # resolves, decodes, compacts
    torch.cuda.synchronize()
    if filled or not np.array_equal(succ.cpu().numpy(), su):
        raise AssertionError("the slice's CSR differs from the graph")
    del co, su, graph
    cp = plan.compact_plan
    store = plan.store
    ref = kcompact.compact(cp, store)
    if not torch.equal(ref, kcompact.compact_plain(cp, store)):
        raise AssertionError("the port's kernel differs from compact_plain")
    m = cp.m
    b2_bytes = 8 * m + sum(t.numel() * t.element_size() for t in (
        cp.arc_start, cp.src0, cp.valid, cp.tile_run0))
    bound_ms = b2_bytes / PEAK_BYTES_PER_S * 1e3
    print(json.dumps(dict(nodes=args.nodes, arcs=m, runs=cp.src0.numel(),
                          store_elems=store.numel(), b2_bytes=b2_bytes,
                          bound_ms=bound_ms,
                          setup_s=time.perf_counter() - t0)), flush=True)

    host = [t.cpu().numpy() for t in (cp.arc_start, cp.src0, cp.valid)]
    plans = {tile0: cp}
    out = torch.empty(m, dtype=torch.int32, device=dev)
    entries = []   # (name, launch, row)
    for (name, src, defs, tile), (proc, path) in zip(rows, builds):
        try:
            lib, ptxas = _build.load_variant(
                proc, path, f"{os.path.basename(src)} {defs}")
        except RuntimeError as e:   # report it, time the others
            print(json.dumps(dict(variant=name, build_error=str(e)[-3000:])),
                  flush=True)
            continue
        if tile not in plans:
            plans[tile] = kcompact.plan_compact(*host[:2], host[2], m,
                                                device=dev, tile=tile)
        launch = launcher(lib, plans[tile], store, out)
        out.fill_(-1)
        launch()
        torch.cuda.synchronize()
        same = bool(torch.equal(out, ref))
        entries.append((name, launch, dict(
            variant=name, src=os.path.relpath(src, os.path.dirname(_PKG)),
            defs=defs, tile=tile, same_as_port=same, ptxas=ptxas)))
    src_idx = expand_ranges(cp.src0, cp.arc_start[1:] - cp.arc_start[:-1], dev)
    if not torch.equal(torch.index_select(store, 0, src_idx), ref):
        raise AssertionError("index_select differs from the port's kernel")
    entries.append(("index_select", lambda: torch.index_select(
        store, 0, src_idx, out=out), dict(variant="index_select",
                                          what="library yardstick")))
    entries.append(("copy_", lambda: out.copy_(ref), dict(
        variant="copy_", what="device-to-device copy of m int32")))

    times = {name: [] for name, _, _ in entries}
    for _, launch, _ in entries:   # warm-up
        launch()
    torch.cuda.synchronize()
    for turn in range(args.turns):
        order = entries if turn % 2 == 0 else entries[::-1]
        for name, launch, _ in order:
            times[name].append(event_ms(launch, args.reps))
    for name, _, row in entries:
        t = times[name]
        row.update(ms_turns=t, ms_min=min(t), ms_median=float(np.median(t)),
                   bound_share=bound_ms / min(t),
                   GB_per_s=b2_bytes / min(t) / 1e6)
        print(json.dumps(row), flush=True)
    earlier = times.get("global_search")
    if earlier:
        print(json.dumps({"faster_than_global_search_every_turn": {
            name: all(a < b for a, b in zip(times[name], earlier))
            for name, _, _ in entries if name != "global_search"}}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
