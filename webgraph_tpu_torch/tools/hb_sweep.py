"""Time HyperBall's merge kernel and its variants at uk-2002's shape.

The graph is ``synthesize_webgraph`` at 18,520,486 nodes and a mean
outdegree of 13.45 (the benchmark's ``uk2002`` shape, ~297M arcs), on the
card, with registers from ``hyperloglog_init_device`` at ``--log2m``.  Each
variant is a set of ``-D`` macros of ``csrc/hyperball.cu``:
``WG_HB_NODE_THREADS`` (the least threads a node), ``WG_HB_U`` (successors
a thread loads before it folds) and ``WG_HB_THREADS`` (threads a block).
Every variant is built with nvcc (all at once), held exactly against the
kernel the port launches, and timed with CUDA events over a dense round in
turns: the variants in order, then in reverse (A B B A), ``--turns`` times
in all.  The shipped kernel's own row -- against its plain twin, its
bounds and the library path -- is ``chip_smoke.py``'s (``kernels`` line).

Usage (one CUDA device)::

    python -m webgraph_tpu_torch.tools.hb_sweep [--nodes N] [--turns 4] \\
        [--reps 5] [--log2m 6] [--variant 'WG_HB_U=8'] ...

One JSON line for the shape and one per variant, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import require_cuda
from ..algo import hyperball as HB
from ..core.graph import CSRGraph
from ..ops import _build
from ..utils.synth import synthesize_webgraph

_PKG = os.path.dirname(_build.BUILD_DIR)
CSRC = os.path.join(_PKG, "csrc", "hyperball.cu")
UK2002_NODES, UK2002_MEAN_OUTDEGREE = 18_520_486, 13.45
DEFAULT_VARIANTS = (
    "WG_HB_NODE_THREADS=4", "WG_HB_NODE_THREADS=16", "WG_HB_NODE_THREADS=32",
    "WG_HB_U=2", "WG_HB_U=8", "WG_HB_THREADS=128", "WG_HB_THREADS=512",
    "WG_HB_NODE_THREADS=4,WG_HB_U=8", "WG_HB_NODE_THREADS=16,WG_HB_U=2")


def launcher(lib, off, succ, regs, out, changed):
    """A dense round of ``lib``'s ``wg_hyperball_merge`` into out, changed."""

    def launch():
        _build.check(lib.wg_hyperball_merge(
            off.data_ptr(), succ.data_ptr(), int(succ.dtype == torch.int64),
            regs.data_ptr(), regs.shape[1], None, out.shape[0],
            out.data_ptr(), changed.data_ptr(), _build.stream_ptr(regs)),
            "merge variant")
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
    ap.add_argument("--nodes", type=int, default=UK2002_NODES)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--log2m", type=int, default=6)
    ap.add_argument("--variant", action="append",
                    help="comma-separated macros of csrc/hyperball.cu")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = require_cuda()
    variants = args.variant if args.variant is not None else DEFAULT_VARIANTS
    builds = [(defs, _build.start_variant(CSRC, defs, "hbsweep"))
              for defs in variants]

    t0 = time.perf_counter()
    n = args.nodes
    co, su = synthesize_webgraph(n, mean_outdegree=UK2002_MEAN_OUTDEGREE,
                                 seed=args.seed)
    g = CSRGraph(co, su, device=dev)
    del co, su
    m = g.num_arcs
    off, succ = g.offsets, g.succ
    regs = HB.hyperloglog_init_device(n, args.log2m, args.seed, dev)
    ref, ref_ch = HB.merge_rows(off, succ, regs)
    torch.cuda.synchronize()
    print(json.dumps(dict(nodes=n, arcs=m, log2m=args.log2m,
                          max_outdegree=int((off[1:] - off[:-1]).max()),
                          changed=int(ref_ch.sum()),
                          setup_s=time.perf_counter() - t0)), flush=True)

    out = torch.empty_like(ref)
    changed = torch.empty_like(ref_ch)
    entries = [("port", launcher(_build.lib(), off, succ, regs, out,
                                 changed), dict(variant="port", defs=""))]
    for defs, (proc, path) in builds:
        try:
            lib, ptxas = _build.load_variant(proc, path, f"hyperball.cu "
                                             f"{defs}")
        except RuntimeError as e:   # report it, time the others
            print(json.dumps(dict(variant=defs, build_error=str(e)[-3000:])),
                  flush=True)
            continue
        launch = launcher(lib, off, succ, regs, out, changed)
        out.zero_()
        launch()
        torch.cuda.synchronize()
        same = bool(torch.equal(out, ref) and torch.equal(changed, ref_ch))
        entries.append((defs, launch, dict(variant=defs, defs=defs,
                                           same_as_port=same, ptxas=ptxas)))
    entries[0][2]["ptxas"] = {k: v for k, v in _build.PTXAS.items()
                              if "hyperball" in k}
    times = {name: [] for name, _, _ in entries}
    for _, launch, _ in entries:   # warm-up
        launch()
    torch.cuda.synchronize()
    for turn in range(args.turns):
        order = entries if turn % 2 == 0 else entries[::-1]
        for name, launch, _ in order:
            times[name].append(event_ms(launch, args.reps))
    for name, _, info in entries:
        t = times[name]
        info.update(ms_turns=t, ms_min=min(t), ms_median=float(np.median(t)))
        print(json.dumps(info), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
