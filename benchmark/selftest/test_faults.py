"""A run with its timed path broken underneath comes out not correct: once
for each fault the cell can have, and where the answer stays exact but the
work leaves the card for the host.  On one chip there is no exchange
between chips to leave out."""

import pytest
import torch

import webgraph_tpu_torch.algo.hyperball as HB
import webgraph_tpu_torch.codecs.bvgraph as bvgraph
import webgraph_tpu_torch.ops.csr as csr
from benchmark.harness import load_module
from benchmark.selftest._small import run_small


def _alter_one(t):
    t = t.clone()
    t[t.numel() // 2] += 1
    return t


def _half(t):
    t = t.clone()
    t[t.numel() // 2:] = 0
    return t


@pytest.mark.parametrize("workload", ["uk2002.decode", "graph500-s24.decode"])
@pytest.mark.parametrize("fault", [_alter_one, _half])
def test_decode_faults(monkeypatch, workload, fault):
    mod = load_module("ops", "decode")
    real = mod.decode_to_csr

    def broken(plan):
        off, succ, filled = real(plan)
        return off, fault(succ), filled

    monkeypatch.setattr(mod, "decode_to_csr", broken)
    assert run_small(workload)["correct"] is False


@pytest.mark.parametrize("fault", [_alter_one, _half])
def test_load_faults(monkeypatch, fault):
    mod = load_module("ops", "load")
    real = mod.load_csr

    def broken(base, device=None):
        g = real(base, device=device)
        g.succ = fault(g.succ)
        return g

    monkeypatch.setattr(mod, "load_csr", broken)
    assert run_small("uk2002.load")["correct"] is False


def _flag_longest_lane(monkeypatch):
    """B1 flags its longest lane, so ``decode_to_csr`` decodes that lane on
    the host: the answer stays exact, the cell's kernel path does not."""
    real = csr.lanes_flagged

    def flagged(plan, diag):
        f = real(plan, diag).clone()
        f[int(torch.argmax(plan.expect[:, 0]))] = True
        return f

    monkeypatch.setattr(csr, "lanes_flagged", flagged)


@pytest.mark.parametrize("workload", ["uk2002.decode", "graph500-s24.decode",
                                      "uk2002.load"])
def test_host_fill(monkeypatch, workload):
    _flag_longest_lane(monkeypatch)
    r = run_small(workload)
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] == 0
    assert r["checks"]["fallback_arcs"]["value"] > 0


def test_host_route(monkeypatch):
    """The planner gives no device plan, so ``load_csr`` decodes the whole
    graph with the native decoder on the host."""
    monkeypatch.setattr(bvgraph, "plan_kernel_decode", lambda *a, **k: None)
    r = run_small("uk2002.load")
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] == 0
    assert r["checks"]["host_route"]["value"] == r["attempted"]


def test_hyperball_state_unchanged(monkeypatch):
    def iterate(self):
        self.iteration += 1
        self.mode_history.append("dense")
        self.arcs_touched.append(0)
        self.modified = 0
        self.neighbourhood_function.append(float(self._counts.sum()))
        return 0

    monkeypatch.setattr(HB.HyperBall, "iterate", iterate)
    assert run_small("uk2002.hyperball")["correct"] is False


def test_hyperball_half_the_arcs(monkeypatch):
    real = HB._scatter_max_rows

    def half(out, dst, table, rows):
        k = dst.numel() // 2
        return real(out, dst[:k], table, rows[:k])

    monkeypatch.setattr(HB, "_scatter_max_rows", half)
    assert run_small("uk2002.hyperball")["correct"] is False


def test_hyperball_answer_altered(monkeypatch):
    real = HB.estimate_counts_device

    def altered(regs):
        return real(regs) * (1 + 1e-6)

    monkeypatch.setattr(HB, "estimate_counts_device", altered)
    assert run_small("uk2002.hyperball")["correct"] is False


def test_hyperball_registers_altered(monkeypatch):
    real = HB.HyperBall.iterate

    def iterate(self):
        r = real(self)
        if r == 0:
            self.regs[0, 0] += 1
        return r

    monkeypatch.setattr(HB.HyperBall, "iterate", iterate)
    assert run_small("uk2002.hyperball")["correct"] is False
