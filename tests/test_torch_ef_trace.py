"""The EF path's spans and counters, and the benchmark's readers of them.

- ``EFGraph.store(backend="cuda")`` records ``wg.ef.store`` over its
  stages ``.layout``, ``.lists`` and ``.pointers`` (one each a chunk) and
  ``.write``;
- ``EFDevicePlan`` records ``wg.ef.plan`` > ``.upload``, ``.outdegrees``,
  and each ``decode`` ``wg.ef.decode`` > ``.layout``, ``.ranks``,
  ``.chunks``, ``.select`` (one a chunk with arcs), counting ``ef.arcs``
  and ``ef.chunks``; nothing is counted with no profiler running;
- ``ef_idle_ms`` and ``ef_decode_roofline`` read a known trace right, and
  nothing where the program records no ``wg.ef.decode``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import load_module
from benchmark.layers import _ef
from benchmark.trace import Trace, capture
from webgraph_tpu_torch.codecs.efgraph import EFGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops.efdecode import EFDevicePlan
from webgraph_tpu_torch.utils import trace as T
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def graph():
    off, succ = synthesize_webgraph(400, mean_outdegree=6, seed=3)
    return CSRGraph(off, succ, device=CPU)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [e for e in prof.events() if e.name.startswith("wg.")]
    assert not any(e.is_user_annotation for e in evs)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in evs)
    return out, evs


def _kids(evs, parent):
    return [e.name for e in evs if e.cpu_parent is parent]


def _one(evs, name):
    found = [e for e in evs if e.name == name]
    assert len(found) == 1, name
    return found[0]


@pytest.mark.parametrize("chunk", [None, 500])
def test_store_spans(graph, tmp_path, monkeypatch, chunk):
    if chunk:
        monkeypatch.setattr("webgraph_tpu_torch.codecs.efgraph."
                            "_STORE_CHUNK_ARCS", chunk)
    nchunks = 1 if chunk is None else -(-graph.num_arcs // chunk)
    _, evs = _profiled(lambda: EFGraph.store(
        graph, str(tmp_path / "g"), backend="cuda", device=CPU))
    root = _one(evs, "wg.ef.store")
    kids = _kids(evs, root)
    assert set(kids) == {"wg.ef.store.layout", "wg.ef.store.lists",
                         "wg.ef.store.pointers", "wg.ef.store.write"}
    assert kids.count("wg.ef.store.layout") == 1
    assert kids.count("wg.ef.store.write") == 1
    assert kids.count("wg.ef.store.lists") == kids.count(
        "wg.ef.store.pointers") >= nchunks


def test_numpy_store_records_no_device_span(graph, tmp_path):
    _, evs = _profiled(lambda: EFGraph.store(graph, str(tmp_path / "g")))
    assert not [e for e in evs if e.name.startswith("wg.ef.")]


@pytest.mark.parametrize("chunk_arcs", [1 << 24, 300])
def test_plan_and_decode_spans_and_counters(graph, tmp_path, chunk_arcs):
    base = str(tmp_path / "g")
    EFGraph.store(graph, base, backend="cuda", device=CPU)
    ef = EFGraph.load(base)
    T.reset_counters()

    def run():
        plan = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                            ef.log2_quantum, device=CPU)
        return [plan.decode(chunk_arcs=chunk_arcs) for _ in range(2)]

    outs, evs = _profiled(run)
    for co, su in outs:
        assert torch.equal(co, graph.offsets) and torch.equal(su, graph.succ)
    plan = _one(evs, "wg.ef.plan")
    assert _kids(evs, plan) == ["wg.ef.plan.upload", "wg.ef.plan.outdegrees"]
    decodes = sorted((e for e in evs if e.name == "wg.ef.decode"),
                     key=lambda e: e.time_range.start)
    assert len(decodes) == 2
    nchunks = -(-graph.num_arcs // chunk_arcs)
    for d in decodes:
        kids = _kids(evs, d)
        assert kids[:3] == ["wg.ef.decode.layout", "wg.ef.decode.ranks",
                            "wg.ef.decode.chunks"]
        assert kids[3:] == ["wg.ef.decode.select"] * nchunks
    assert T.counters() == {"ef.arcs": 2 * graph.num_arcs,
                            "ef.chunks": 2 * nchunks}


def test_nothing_counted_without_a_profiler(graph, tmp_path):
    base = str(tmp_path / "g")
    EFGraph.store(graph, base, backend="cuda", device=CPU)
    ef = EFGraph.load(base)
    T.reset_counters()
    EFDevicePlan(ef.words, ef.offsets, ef.upper_bound, ef.log2_quantum,
                 device=CPU).decode()
    assert T.counters() == {}


def _ctx(tr, calls, **counters):
    return SimpleNamespace(trace=tr, calls=calls, counters=counters,
                           env=None, window_s=tr.window_s, kind=H100)


# window 0..1000 us; device busy 100-300, 350-400, 420-480 (the first
# call's last kernels, after its span), 700-800 and 900-950; two decodes,
# spans 50-400 and 650-850
DEV = [("vectorized_elementwise_kernel", 100, 300), ("index_kernel", 350, 400),
       ("index_kernel", 420, 480), ("reduce_kernel", 700, 780),
       ("elementwise", 770, 800), ("gather", 900, 950)]
HOST = [("wg.ef.decode", 50, 400), ("wg.ef.decode.select", 60, 90),
        ("wg.ef.decode", 650, 850), ("aten::empty", 660, 661)]


def test_ef_idle_reader_on_a_known_trace():
    # idle inside the spans: 50 + 50 (first), 50 + 50 (second): 100 us a call
    tr = Trace(DEV, [("bench.ef_decode", 40, 410)], HOST, (0, 1000))
    read = load_module("layers", "ef_idle_ms").read
    assert read(_ctx(tr, 2)) == pytest.approx(0.1)
    bare = Trace(DEV, [], [("aten::empty", 0, 5)], (0, 1000))
    assert read(_ctx(bare, 2)) is None


def test_ef_roofline_reader_on_a_known_trace():
    # a call's device time runs from its span's start to the next's: the
    # first 200 + 50 + 60 = 310 us, the second 100 + 50 = 150: 230 us a call
    tr = Trace(DEV, [], HOST, (0, 1000))
    c = dict(stream_bytes=1_000_000, arcs=2_000_000, nodes=300_000)
    nbytes = 1_000_000 + 4 * 2_000_000 + 8 * 300_000
    assert _ef.ef_decode_bytes(**c) == nbytes
    read = load_module("layers", "ef_decode_roofline").read
    assert read(_ctx(tr, 2, **c)) == pytest.approx(
        100 * nbytes / 3.35e12 / 230e-6)
    assert read(_ctx(tr, 2)) is None             # no stream counted
    bare = Trace(DEV, [], [("wg.decode_to_csr", 50, 400)], (0, 1000))
    assert read(_ctx(bare, 2, **c)) is None     # a program without the span


def test_readers_on_a_traced_cpu_decode(graph, tmp_path):
    """On the CPU the trace has the spans but no device activity: nothing
    to read, not 0."""
    base = str(tmp_path / "g")
    EFGraph.store(graph, base, backend="cuda", device=CPU)
    ef = EFGraph.load(base)
    plan = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                        ef.log2_quantum, device=CPU)
    _, tr = capture(plan.decode, CPU)
    assert [n for n, _, _ in tr.host_ops].count("wg.ef.decode") == 1
    ctx = _ctx(tr, 1, stream_bytes=int(np.asarray(ef.words).nbytes),
               arcs=plan.m, nodes=plan.n)
    for name in ("ef_idle_ms", "ef_decode_roofline",
                 "device_idle_pct.ef_decode"):
        assert load_module("layers", name).read(ctx) is None
