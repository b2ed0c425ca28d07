"""Time B1 on a Graph500 Kronecker graph under several list-split settings.

The benchmark's ``graph500-s24`` graph (``benchmark/gen/kronecker.py``
with ``benchmark/configs/graph500-s24.json``'s parameters) is generated on
the card from ``--seed`` and encoded into one BVGraph stream under the
configuration's settings.  Then, for each
setting of ``kplan``'s ``split_arcs``, ``seg_arcs`` and ``seg_bits`` (and
once without any split), a cold plan is made and resolved, and timed by
CUDA events in this one process: B1 alone (``decode_lanes``), the merge of
the split lists (``merge_split``), and both (``decode_chunked``); a
``decode_to_csr`` call by the host clock.  Every setting's CSR is held
equal to the unsplit plan's.  ``--profiled`` times B1 once more inside
``torch.profiler`` (CPU and CUDA activities, as the benchmark's traced
runs record).  Each row gives the lanes' steps: the longest lane's, and
the longest split list's head lane's (its header, copies and intervals).

Usage (one CUDA device, from the checkout's root; a script beside the
package, since it reads the benchmark's generator)::

    python3 split_sweep.py [--scale 24] \\
        [--seed 1] [--split 8192,...] [--seg 4096,...] [--bits 4800,...] \\
        [--profiled]

One JSON line per setting, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from webgraph_tpu_torch import native, require_cuda
from webgraph_tpu_torch.ops import kdecode, kplan, vencode
from webgraph_tpu_torch.ops.csr import decode_to_csr, plan_csr_index
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.settings import BVGraphSettings

ROOT = os.path.dirname(os.path.abspath(__file__))


def events_ms(fn, reps: int) -> float:
    """The least CUDA-event time of ``fn`` over ``reps`` calls, in ms."""
    best = float("inf")
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return best


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--split", type=_ints, default=[4096, 8192, 16384,
                                                    65536])
    ap.add_argument("--seg", type=_ints, default=[4096, 16384, 65536])
    ap.add_argument("--bits", type=_ints, default=[kplan.SEG_BITS])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profiled", action="store_true")
    args = ap.parse_args()
    from benchmark.gen import kronecker
    dev = require_cuda()
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "graph500-s24.json")) as f:
        cfg = json.load(f)
    s = BVGraphSettings(**cfg["bvgraph"])
    t0 = time.perf_counter()
    off, succ = kronecker.generate(dict(cfg["params"], scale=args.scale),
                                   args.seed, dev)
    stream, bits, starts, _ = vencode.encode_csr_chunked(off, succ, s)
    offsets = np.empty(off.numel(), dtype=np.int64)
    offsets[:-1] = starts.cpu().numpy()
    offsets[-1] = bits
    data = np.frombuffer(stream, dtype=np.uint8)
    del starts, stream, succ, off
    torch.cuda.empty_cache()
    outd = native.decode_outdegrees(data, offsets, s.outdegree_coding)
    print(json.dumps(dict(scale=args.scale, arcs=int(outd.sum()),
                          longest_list=int(outd.max()),
                          stream_bytes=int(data.nbytes),
                          setup_s=time.perf_counter() - t0)), flush=True)
    settings = [(None, 0, 0)] + [(sp, sg, bt) for sp in args.split
                                 for sg in args.seg for bt in args.bits]
    want = None
    for split_arcs, seg_arcs, seg_bits in settings:
        t0 = time.perf_counter()
        kw = (dict(split_arcs=int(outd.max())) if split_arcs is None else
              dict(split_arcs=split_arcs, seg_arcs=seg_arcs,
                   seg_bits=seg_bits))
        plan = kplan.plan_kernel_decode(offsets, outd, s, data, device=dev,
                                        **kw)
        plan_s = time.perf_counter() - t0
        resolve_halos(plan)
        plan_csr_index(plan)
        _co, got, filled = decode_to_csr(plan)
        if want is None:
            want = got
        same = bool(torch.equal(got, want)) and filled == 0
        del got
        sp = plan.split
        b1 = events_ms(lambda: kdecode.decode_lanes(
            plan.words, plan.meta, plan.store, plan.spec, plan.order),
            args.reps)
        merge = (events_ms(lambda: kdecode.merge_split(sp, plan.store),
                           args.reps) if sp is not None else 0.0)
        both = events_ms(lambda: kdecode.decode_chunked(plan), args.reps)
        profiled = None
        if args.profiled:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                profiled = events_ms(lambda: kdecode.decode_lanes(
                    plan.words, plan.meta, plan.store, plan.spec,
                    plan.order), args.reps)
        calls = []
        for _ in range(args.reps):
            t1 = time.perf_counter()
            decode_to_csr(plan)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t1) * 1e3)
        steps = kdecode.decode_chunked(plan)[:, kdecode.DIAG_STEPS]
        row = dict(split_arcs=split_arcs, seg_arcs=seg_arcs,
                   seg_bits=seg_bits, same_csr=same, plan_s=plan_s,
                   lanes=plan.lanes,
                   preset_lanes=0 if sp is None else sp.segments,
                   split_lists=0 if sp is None else len(sp.nodes),
                   merged_lists=0 if sp is None else sp.merged,
                   merged_rows=0 if sp is None else sp.merge_rows,
                   split_arcs_decoded=0 if sp is None else sp.arcs,
                   max_lane_steps=int(steps.max()),
                   max_head_steps=0 if sp is None else int(
                       steps[sp.heads].max()), b1_ms=b1,
                   b1_profiled_ms=profiled,
                   merge_ms=merge, b1_and_merge_ms=both,
                   call_ms=min(calls))
        print(json.dumps(row), flush=True)
        del plan, steps
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
