"""Traffic op ``load``: a basename on disk to a CSR on the card.

Set-up stores the generated graph as a BVGraph basename with the port's
device encoder (``BVGraph.store(..., backend="cuda")``, single-stream) in a
temporary directory under ``TMPDIR``, removed at the end, and warms the path
with one load.  Each operation of the window is one ``load_csr(basename)``
ending in a synchronise: the files read, the cold plan, the halo passes and
the decode.  The CSR is dropped unless the check keeps it.  The files stay
in the host's page cache from the store on, as they do for a user who
works on one graph.

The cell's decode is B1 and B2 on the card.  ``load_csr`` takes the native
sequential decoder on the host instead when the planner gives no device
plan (``report["route"]`` "host"), and fills a lane the kernel flags on the
host (``report["fallback_arcs"]``).  Every load's route and count are kept,
and a load that took either is not correct, even though its answer is
exact (``host_route``, ``fallback_arcs``, limit 0).
"""

from __future__ import annotations

import os
import tempfile

from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph, load_csr
from webgraph_tpu_torch.settings import BVGraphSettings

from ..reference import csr as ref_csr
from ..harness import sync, timed
from ..trace import span


class Op:
    def __init__(self, env):
        self.env = env
        self.tmp = None
        self.base = None
        self.counters = {"reports": []}

    def setup(self) -> None:
        env = self.env
        if env.control:
            return
        settings = BVGraphSettings(**env.config["bvgraph"])
        self.tmp = tempfile.TemporaryDirectory(prefix="wgbench-")
        self.base = os.path.join(self.tmp.name, env.config["name"])
        with timed(env, "store"):
            BVGraph.store(CSRGraph(env.offsets, env.succ, device=env.device),
                          self.base, settings=settings, backend="cuda",
                          device=env.device)
        env.park()
        with timed(env, "warm"):
            g = load_csr(self.base, device=env.device)
            del g

    def step(self):
        env = self.env
        if env.control:
            out = ref_csr.control(env.ref_offsets(), env.ref_succ())
        else:
            with span("load_csr"):
                g = load_csr(self.base, device=env.device)
            self.counters["reports"].append(dict(g.report))
            out = (g.offsets, g.succ)
        sync(env.device)
        return out

    def end_to_end(self, window_s: float, done: int) -> dict:
        return {"load_Medges_per_s": self.env.m * done / window_s / 1e6}

    def release(self) -> None:
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None

    def check(self, kept: list) -> tuple:
        env = self.env
        worst, wrong = ref_csr.check(env.ref_offsets(), env.ref_succ(), kept)
        reps = self.counters["reports"]
        host = [i for i, r in enumerate(reps) if r.get("route") != "kernel"]
        filled = [r.get("fallback_arcs", 0) for r in reps]
        worst["host_route"] = len(host)
        worst["fallback_arcs"] = max(filled, default=0)
        wrong |= set(host) | {i for i, a in enumerate(filled) if a}
        return worst, len(wrong)
