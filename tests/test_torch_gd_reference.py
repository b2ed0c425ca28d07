"""The port's BVGraph stream under the gap-coded setting (γ outdegrees, δ
residuals, window 0, no intervals) against the plain reference of that
format (``benchmark/reference/bvgraph_gd.py``).

- the reference's stream is byte-equal to ``native.bv_encode(...,
  threads=1)`` and to the device encoder ``vencode.encode_csr_chunked``
  run on the CPU, over seeds and sizes, with empty lists, a self-loop
  (first residual 0), a list at node 0 and the largest gaps an int32 id
  allows;
- the reference's closed form ``entry_bits`` is the encoder's node starts;
- the reference decoder reads the port's stream back to the CSR;
- the port's ``decode_to_csr`` (the plain twin of B1 and B2) decodes the
  reference's stream to the CSR, with no resolve pass and no host fill.

Nothing here imports jax; every comparison is exact.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from benchmark.reference import bvgraph_gd as R
from .torch_edge_cases import simple
from webgraph_tpu_torch import native
from webgraph_tpu_torch.ops import kplan, vencode
from webgraph_tpu_torch.ops.csr import decode_to_csr
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.settings import BVGraphSettings, CompressionFlags
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

CPU = torch.device("cpu")
SETTINGS = BVGraphSettings(window_size=0, min_interval_length=0,
                           residual_coding=CompressionFlags.DELTA)
TOP = 2**31 - 1        # the largest int32 id

# (nodes, seed, wide): ``wide`` puts the largest gaps an int32 id allows
# at node 0 (first residual int2nat(TOP)) and the last node (gap TOP - 1)
CASES = [(1, 0, False), (1, 1, True), (2, 0, False), (2, 1, True),
         (1000, 0, False), (1000, 1, False), (1000, 2, True),
         (20000, 3, False)]
IDS = [f"n{n}-s{s}" + ("-wide" if w else "") for n, s, w in CASES]


@lru_cache(maxsize=None)
def _graph(n, seed, wide):
    """A crawl-like CSR with empty lists, a self-loop and node 0's list."""
    rng = np.random.default_rng(seed)
    if n < 1000:
        lists = [np.sort(rng.choice(n, size=int(rng.integers(0, n + 1)),
                                    replace=False)) for _ in range(n)]
    else:
        co, su = simple(*synthesize_webgraph(n, mean_outdegree=8,
                                             seed=seed))
        lists = [su[co[x]:co[x + 1]] for x in range(n)]
        for x in rng.choice(np.arange(1, n - 1), size=n // 20,
                            replace=False):
            lists[x] = lists[x][:0]                  # empty lists
        x = n // 2
        lists[x] = np.unique(np.concatenate([[x], lists[x][lists[x] > x]]))
        lists[0] = np.array([0, 1, n - 1])           # self-loop at node 0
    if wide:
        lists[0] = np.array([TOP])
        lists[-1] = np.array([0, TOP])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=co[1:])
    su = (np.concatenate(lists) if co[-1] else np.zeros(0)).astype(np.int64)
    return co, su


@lru_cache(maxsize=None)
def _streams(n, seed, wide):
    """The reference's stream (bytes, bits) and node starts, and the
    native encoder's stream, bit count and node starts."""
    co, su = _graph(n, seed, wide)
    bits, starts = [], []
    for x in range(n):
        starts.append(len(bits))
        bits += R.encode_list(x, su[co[x]:co[x + 1]].tolist())
    ref = np.packbits(np.array(bits, dtype=np.uint8)).tobytes()
    graph, gbits, offs, _ob, _st = native.bv_encode(co, su, SETTINGS,
                                                    threads=1)
    offsets = native.decode_offset_stream(offs, n, SETTINGS.offset_coding)
    return (ref, len(bits), np.array(starts + [len(bits)], dtype=np.int64),
            bytes(graph), gbits, offsets)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_stream_is_the_encoders(case):
    co, su = _graph(*case)
    ref, ref_bits, ref_starts, graph, gbits, offsets = _streams(*case)
    assert (ref, ref_bits) == (graph, gbits)
    np.testing.assert_array_equal(ref_starts, offsets)
    stream, vbits, vstarts, _ = vencode.encode_csr_chunked(
        torch.from_numpy(co), torch.from_numpy(su), SETTINGS, device=CPU,
        chunk_arcs=max(int(co[-1]) // 3, 1))
    assert (bytes(stream), vbits) == (ref, ref_bits)
    np.testing.assert_array_equal(vstarts.numpy(), ref_starts[:-1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_entry_bits_are_the_node_starts(case):
    co, su = _graph(*case)
    offsets = _streams(*case)[5]
    got = R.entry_bits(torch.from_numpy(co), torch.from_numpy(su),
                       chunk_arcs=97)
    np.testing.assert_array_equal(got.numpy(), np.diff(offsets))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_decoder_reads_the_port_stream(case):
    co, su = _graph(*case)
    graph, offsets = _streams(*case)[3], _streams(*case)[5]
    for x in range(len(co) - 1):
        bits = R.stored_bits(graph, offsets[x], offsets[x + 1])
        assert R.decode_entry(bits, x) == su[co[x]:co[x + 1]].tolist(), x


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_decodes_the_reference_stream(case):
    co, su = _graph(*case)
    ref, _bits, starts = _streams(*case)[:3]
    data = np.frombuffer(ref, dtype=np.uint8)
    outd = native.decode_outdegrees(data, starts, SETTINGS.outdegree_coding)
    np.testing.assert_array_equal(outd, np.diff(co))
    plan = kplan.plan_kernel_decode(starts, outd, SETTINGS, data, device=CPU)
    assert plan.cold and plan.resolved
    assert resolve_halos(plan) == 0
    off, succ, filled = decode_to_csr(plan)
    assert filled == 0
    np.testing.assert_array_equal(off, co)
    np.testing.assert_array_equal(succ.numpy(), su)


def test_reference_refuses_malformed_entries():
    bits = R.encode_list(5, [1, 7, 9])
    assert R.decode_entry(bits, 5) == [1, 7, 9]
    with pytest.raises(IndexError):
        R.decode_entry(bits[:-1], 5)
    with pytest.raises(ValueError):
        R.decode_entry(bits + [1], 5)
    with pytest.raises(ValueError):
        R.encode_list(5, [3, 3])
    with pytest.raises(IndexError):
        R.stored_bits(b"\x80", 0, 9)
