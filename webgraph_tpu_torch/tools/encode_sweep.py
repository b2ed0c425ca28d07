"""Time the device encoder at several chunk sizes on the card.

Builds the uk-2002-scale synthetic web graph (``synthesize_webgraph``,
18,500,000 nodes by default) as a device ``CSRGraph`` and runs
``vencode.encode_csr_chunked`` over it once per chunk size (the first size
twice: its first run warms the allocator and is not reported), each with
its stage split, its seconds on the host clock ending in a synchronise and
its peak device bytes above what is resident.  Every chunk size must give
the same stream (its SHA-256 is compared).  Prints one JSON line per run
and the card's name and power limit.

Usage (on a machine with a CUDA device):
    python -m webgraph_tpu_torch.tools.encode_sweep [--nodes N]
        [--chunks 8,16,32,64,128]   (millions of arcs, 2**20 each)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import torch

from ..core.graph import CSRGraph
from ..device import require_cuda
from ..ops import vencode
from ..settings import BVGraphSettings
from ..utils.synth import synthesize_webgraph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=18_500_000)
    ap.add_argument("--chunks", default="8,16,32,64,128")
    args = ap.parse_args(argv)
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    co, su = synthesize_webgraph(args.nodes)
    g = CSRGraph(co, su, device=dev)
    del co, su
    s = BVGraphSettings()
    sizes = [int(c) << 20 for c in args.chunks.split(",")]
    digest = None
    for i, chunk in enumerate([sizes[0]] + sizes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        split = {}
        t0 = time.perf_counter()
        gb, bits, starts, _ = vencode.encode_csr_chunked(
            g.offsets, g.succ, s, chunk_arcs=chunk, split=split)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        h = hashlib.sha256(gb).hexdigest()
        if digest is not None and h != digest:
            raise AssertionError(f"chunk {chunk}: another stream")
        digest = h
        del gb, starts
        if i == 0:
            continue
        print(json.dumps(dict(card=card, nodes=g.num_nodes, arcs=g.num_arcs,
                              chunk_arcs=chunk, encode_s=secs,
                              encode_Medges_per_s=g.num_arcs / secs / 1e6,
                              peak_above_resident=peak, graph_bits=bits,
                              split=split)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
