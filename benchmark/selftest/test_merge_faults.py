"""A HyperBall run whose merge drops arcs comes out not correct, with the
fault planted at ``merge_rows``, the one function every round merges
through (on the card it launches ``csrc/hyperball.cu``; here on the CPU
it runs its plain twin)."""

import torch

import webgraph_tpu_torch.algo.hyperball as HB
from benchmark.selftest._small import run_small


def test_hyperball_merge_drops_half_of_each_list(monkeypatch):
    real = HB.merge_rows

    def half(off, succ, regs, nodes=None):
        # every list cut to its first half: a CSR of the kept arcs
        cnt = off[1:] - off[:-1]
        keep = cnt // 2
        kept_off = torch.zeros_like(off)
        torch.cumsum(keep, 0, out=kept_off[1:])
        pos = torch.arange(int(keep.sum()), device=off.device)
        at = torch.repeat_interleave(off[:-1] - kept_off[:-1], keep,
                                     output_size=pos.numel())
        return real(kept_off, succ[pos + at].contiguous(), regs, nodes)

    monkeypatch.setattr(HB, "merge_rows", half)
    r = run_small("uk2002.hyperball")
    assert r["correct"] is False
    assert r["checks"]["regs_mismatch"]["value"] > 0
