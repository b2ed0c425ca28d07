"""A run of the EF decode cell with its path broken underneath comes out
not correct: a successor altered or half of the successors zeroed under
``EFDevicePlan.decode`` (the timed path), or one bit flipped in a sampled
node's stored entry (the device store); and the control of the check."""

import os

import pytest

import webgraph_tpu_torch.ops.efdecode as efdecode
from benchmark.harness import load_module
from benchmark.selftest._small import run_small
from benchmark.selftest.test_faults import _alter_one, _half

CELL = "uk2002-ef.ef_decode"


@pytest.mark.parametrize("fault", [_alter_one, _half])
def test_decode_faults(monkeypatch, fault):
    real = efdecode.EFDevicePlan.decode

    def broken(self, *a, **k):
        off, succ = real(self, *a, **k)
        return off, fault(succ)

    monkeypatch.setattr(efdecode.EFDevicePlan, "decode", broken)
    r = run_small(CELL)
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] > 0


def test_stored_bit_flipped(monkeypatch):
    """The longest list's entry (always among the sampled nodes) has one
    bit of its upper bits flipped in the ``.graph`` file the store wrote."""
    mod = load_module("ops", "ef_decode")
    real = mod.EFGraph.store

    def store(graph, base, **kw):
        props = real(graph, base, **kw)
        ef = mod.EFGraph.load(base)
        x = int((graph.offsets[1:] - graph.offsets[:-1]).argmax())
        bit = int(ef.offsets[x + 1]) - 3       # among the upper bits
        with open(base + ".graph", "r+b") as f:
            f.seek(bit // 8)
            b = f.read(1)[0] ^ (1 << (bit % 8))
            f.seek(bit // 8)
            f.write(bytes([b]))
        assert os.path.getsize(base + ".graph") == len(ef.words) * 8
        return props

    monkeypatch.setattr(mod.EFGraph, "store", store)
    r = run_small(CELL)
    assert r["correct"] is False
    assert r["checks"]["stream_mismatch"]["value"] > 0


def test_control_is_not_correct():
    r = run_small(CELL, control=True)
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] > 0
