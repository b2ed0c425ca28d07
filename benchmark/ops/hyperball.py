"""Traffic op ``hyperball``: one neighbourhood-function run to its end.

Set-up wraps the generated graph as the program's ``CSRGraph`` on the card,
takes its transpose (which turns on systolic and local rounds) and warms
the path with one round.  Each operation of the window is one run,
``HyperBall(g, log2m, seed, gt)`` iterated until no counter changes; the
harness times every round on the host clock, ending in a synchronise, with
the mode the program reports for it.  No codec code runs in the window.
"""

from __future__ import annotations

import time

import torch

from webgraph_tpu_torch.algo.hyperball import HyperBall
from webgraph_tpu_torch.core.graph import CSRGraph

from ..reference import hyperball as ref_hb
from ..harness import sync, timed
from ..trace import span


class Op:
    def __init__(self, env):
        self.env = env
        self.log2m = int(env.traffic["log2m"])
        self.g = self.gt = None
        self.counters = {"rounds": [], "nfs": []}

    def setup(self) -> None:
        env = self.env
        if env.control:
            return
        with timed(env, "transpose"):
            self.g = CSRGraph(env.offsets, env.succ, device=env.device)
            self.gt = self.g.transpose()
        with timed(env, "warm"):
            HyperBall(self.g, self.log2m, env.seed, gt=self.gt).iterate()

    def step(self):
        env = self.env
        if env.control:
            nf, regs = ref_hb.run(env.offsets, env.succ, self.log2m,
                                  env.seed, dtype=torch.float32)
        else:
            with span("HyperBall"):
                hb = HyperBall(self.g, self.log2m, env.seed, gt=self.gt)
            while True:
                t0 = time.perf_counter()
                with span("iterate"):
                    modified = hb.iterate()
                sync(env.device)
                self.counters["rounds"].append(
                    (hb.mode_history[-1], time.perf_counter() - t0))
                if modified == 0:
                    break
            nf, regs = list(hb.neighbourhood_function), hb.regs
        self.counters["nfs"].append(nf)
        return regs

    def end_to_end(self, window_s: float, done: int) -> dict:
        return {"hyperball_run_s": window_s / done}

    def release(self) -> None:
        self.g = self.gt = None

    def check(self, kept: list) -> tuple:
        env = self.env
        ref_nf, ref_regs = ref_hb.run(env.offsets, env.succ, self.log2m,
                                      env.seed)
        limit = env.traffic["limits"]["nf_rel_gap"]
        worst = {"rounds_mismatch": 0, "regs_mismatch": 0, "nf_rel_gap": 0.0}
        failed = 0
        for nf in self.counters["nfs"]:
            rounds_bad = int(len(nf) != len(ref_nf))
            gap = max(abs(a - b) / max(abs(b), 1.0)
                      for a, b in zip(nf, ref_nf))
            worst["rounds_mismatch"] += rounds_bad
            worst["nf_rel_gap"] = max(worst["nf_rel_gap"], gap)
            failed += bool(rounds_bad or gap > limit)
        regs_failed = 0
        for _, regs in kept:
            bad = (int((regs != ref_regs).sum()) if regs.shape ==
                   ref_regs.shape else ref_regs.numel())
            worst["regs_mismatch"] = max(worst["regs_mismatch"], bad)
            regs_failed += bool(bad)
        return worst, max(failed, regs_failed)
