"""A run of the gap-coded decode cell whose stored stream breaks the format
comes out not correct: one bit flipped in the longest list's entry (always
among the sampled nodes) in what the device encoder returns, or one node's
start shifted by a bit in the plan's offsets at a node that no lane starts
at (B1 reads no other start, so the decode stays right and only the stream
check sees it); and the control of the check."""

import numpy as np

import webgraph_tpu_torch.ops.kplan as kplan
import webgraph_tpu_torch.ops.vencode as vencode
from benchmark.selftest._small import run_small

CELL = "uk2002-gd.decode_stream"


def test_stored_bit_flipped(monkeypatch):
    real = vencode.encode_csr_chunked

    def broken(co, succ, settings, *a, **k):
        stream, bits, starts, stats = real(co, succ, settings, *a, **k)
        x = int((co[1:] - co[:-1]).argmax())
        end = int(starts[x + 1]) if x + 1 < starts.numel() else bits
        b = bytearray(stream)
        b[(end - 1) // 8] ^= 0x80 >> ((end - 1) % 8)   # its last bit
        return bytes(b), bits, starts, stats

    monkeypatch.setattr(vencode, "encode_csr_chunked", broken)
    r = run_small(CELL)
    assert r["correct"] is False
    assert r["checks"]["stream_mismatch"]["value"] > 0


def test_node_start_shifted(monkeypatch):
    real = kplan.plan_kernel_decode

    def broken(*a, **k):
        plan = real(*a, **k)
        inner = np.setdiff1d(np.arange(plan.n), plan.chunk_starts)
        plan.offsets[inner[len(inner) // 2]] += 1
        return plan

    monkeypatch.setattr(kplan, "plan_kernel_decode", broken)
    r = run_small(CELL)
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] == 0
    assert r["checks"]["stream_bits_gap"]["value"] == 2


def test_control_is_not_correct():
    r = run_small(CELL, control=True)
    assert r["correct"] is False
    assert r["checks"]["succ_mismatch"]["value"] > 0
    assert r["checks"]["stream_bits_gap"]["value"] == 0
    assert r["checks"]["stream_mismatch"]["value"] == 0
