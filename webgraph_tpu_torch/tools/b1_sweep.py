"""Time variants of the decode kernel (B1) on one synthetic graph.

Each variant is a CUDA source (``csrc/bv_decode.cu`` by default) and a set
of ``-D`` macros (``WG_B1_THREADS``: threads a block).  Every variant is
built with nvcc, run on the same resolved plan, held exactly against the
kernel the port launches (store and diagnostics), and timed with CUDA
events, its threads taking the lanes in the plan's order (costliest
first) and in lane order; ptxas's registers, stack and spills are printed
beside.

Usage (one CUDA device)::

    python -m webgraph_tpu_torch.tools.b1_sweep [--nodes N] \
        [--variant 'WG_B1_THREADS=128'] ... \
        [--src other.cu]

One JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import native, require_cuda
from ..ops import _build, kdecode, kplan
from ..settings import BVGraphSettings
from ..utils.synth import synthesize_webgraph

DEFAULT_VARIANTS = ("WG_B1_THREADS=128", "WG_B1_THREADS=64",
                    "WG_B1_THREADS=256")


def build_variant(src: str, defs: str):
    """nvcc ``src`` with the macros ``defs`` into the build dir; returns
    (library, ptxas report of its kernel)."""
    lib, rep = _build.load_variant(*_build.start_variant(src, defs, "b1sweep"),
                                   f"{src} {defs}")
    return lib, next(iter(rep.values()), {})


def time_variant(lib, plan, ref_diag, ref_store, ordered: bool,
                 reps: int) -> dict:
    """Run one built variant on the plan (threads taking the lanes in the
    plan's order, or in lane order): whether it equals the port's kernel,
    and its CUDA-event times."""
    sp = plan.spec
    diag = torch.empty_like(ref_diag)
    store = plan.store

    def launch():
        _build.check(lib.wg_bv_decode_lanes(
            plan.words.data_ptr(), plan.words.shape[0],
            plan.meta.data_ptr(), plan.meta.shape[1], plan.lanes,
            store.data_ptr(), diag.data_ptr(),
            plan.order.data_ptr() if ordered else None, sp.window_size,
            sp.min_interval_length, sp.zeta_k, sp.outdegree_coding,
            sp.reference_coding, sp.block_count_coding, sp.block_coding,
            sp.residual_coding, _build.stream_ptr(plan.meta)), "b1 variant")

    store.copy_(ref_store)
    launch()
    torch.cuda.synchronize()
    same = bool(torch.equal(diag, ref_diag) and torch.equal(store, ref_store))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return dict(same_as_port=same, ms_min=min(times),
                ms_median=float(np.median(times)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=18_500_000)
    ap.add_argument("--variant", action="append")
    ap.add_argument("--src", action="append")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = require_cuda()
    s = BVGraphSettings()
    t0 = time.perf_counter()
    co, su = synthesize_webgraph(args.nodes)
    graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s,
                                                  threads=os.cpu_count() or 1)
    offsets = native.decode_offset_stream(offs, args.nodes, s.offset_coding)
    plan = kplan.plan_kernel_decode(offsets, np.diff(co), s, graph,
                                    device=dev, halo_csr=(co, su))
    del co, su
    print(json.dumps(dict(nodes=args.nodes, arcs=plan.m, lanes=plan.lanes,
                          setup_s=time.perf_counter() - t0)), flush=True)
    ref_diag = kdecode.decode_chunked(plan)
    ref_store = plan.store.clone()
    srcs = args.src or [os.path.join(os.path.dirname(_build.BUILD_DIR),
                                     "csrc", "bv_decode.cu")]
    for src in srcs:
        for defs in args.variant or DEFAULT_VARIANTS:
            lib, ptxas = build_variant(src, defs)
            for ordered in (True, False):
                row = time_variant(lib, plan, ref_diag, ref_store, ordered,
                                   args.reps)
                print(json.dumps(dict(src=os.path.basename(src), defs=defs,
                                      ordered=ordered, **row, ptxas=ptxas)),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
