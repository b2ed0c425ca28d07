"""The port's spans and counters (``webgraph_tpu_torch/utils/trace.py``).

- ``load_csr`` records every stage of a load as a ``wg.*`` CPU range of
  ``torch.profiler``, all under one ``wg.load_csr``, none of them a user
  annotation (those the profiler mirrors onto the device's timeline);
- ``decode_to_csr`` records B1, the flag check and B2, and the host fill
  only when a lane is flagged;
- every HyperBall round is one ``wg.hyperball.round.<mode>``, in the order
  of ``mode_history``, and ``hyperball.arcs`` counts ``arcs_touched``;
- ``b1.lane_steps`` adds each ``decode_to_csr`` call's longest lane;
- with no profiler running nothing is counted and ``report`` keeps its keys;
- the benchmark's readers of these spans and counters read them.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import webgraph_tpu_torch.codecs.bvgraph as bvgraph
import webgraph_tpu_torch.ops.csr as csr
from benchmark.harness import load_module
from benchmark.trace import WINDOW, Trace, capture
from webgraph_tpu_torch import native
from webgraph_tpu_torch.algo.hyperball import HyperBall
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph, load_csr
from webgraph_tpu_torch.ops.kplan import plan_kernel_decode
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.utils import trace as T
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

CPU = torch.device("cpu")

LOAD_SPANS = {
    "wg.load_csr", "wg.files", "wg.to_device", "wg.files.read", "wg.plan",
    "wg.plan.offsets", "wg.plan.outdegrees", "wg.plan.scan_refs",
    "wg.plan.split", "wg.plan.chunks", "wg.plan.needed_preds",
    "wg.plan.lanes", "wg.plan.chain_depths", "wg.plan.upload", "wg.resolve",
    "wg.decode_to_csr", "wg.csr.index", "wg.b1", "wg.csr.flags", "wg.b2",
    "wg.from_decoded"}
REPORT_KEYS = {"format", "route", "read_s", "plan_s", "resolve_s",
               "resolve_passes", "decode_to_csr_s", "fallback_arcs", "load_s"}


@pytest.fixture(scope="module")
def basename(tmp_path_factory):
    """A crawl-like graph with reference copies across lane boundaries, so
    the cold plan has halo triples."""
    off, succ = synthesize_webgraph(300, mean_outdegree=4, seed=5)
    base = str(tmp_path_factory.mktemp("trace") / "g")
    BVGraph.store(CSRGraph(off, succ, device=CPU), base)
    return base


def _wg_events(prof):
    return [e for e in prof.events() if e.name.startswith("wg.")]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _wg_events(prof)


def _root(e):
    while e.cpu_parent is not None and e.cpu_parent.name.startswith("wg."):
        e = e.cpu_parent
    return e


def _plan(basename):
    bv = BVGraph.load(basename)
    data = np.array(bv.data, dtype=np.uint8)
    offsets = bv.offsets_array()
    outd = native.decode_outdegrees(data, offsets,
                                    bv.settings.outdegree_coding)
    plan = plan_kernel_decode(offsets, outd, bv.settings, data, device=CPU)
    resolve_halos(plan)
    return plan


@pytest.fixture(scope="module")
def traced_load(basename):
    """One load in a traced window: its report, the ``wg.*`` events and
    the benchmark's ``Trace`` of the window."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            report = dict(load_csr(basename, device=CPU).report)
    return report, _wg_events(prof), Trace.from_profiler(prof)


def test_load_csr_spans_nest_under_one_root(traced_load):
    report, evs, _ = traced_load
    assert report["route"] == "kernel"
    names = [e.name for e in evs]
    assert set(names) == LOAD_SPANS and names.count("wg.load_csr") == 1
    assert {_root(e).name for e in evs} == {"wg.load_csr"}
    assert not any(e.is_user_annotation for e in evs)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in evs)
    plan = next(e for e in evs if e.name == "wg.plan")
    assert {e.name for e in evs if e.cpu_parent is plan} == {
        n for n in LOAD_SPANS if n.startswith("wg.plan.")}


@pytest.mark.parametrize("flag", [False, True])
def test_decode_to_csr_spans(basename, monkeypatch, flag):
    plan = _plan(basename)
    if flag:
        real = csr.lanes_flagged

        def flagged(plan, diag):
            f = real(plan, diag).clone()
            f[int(torch.argmax(plan.expect[:, 0]))] = True
            return f

        monkeypatch.setattr(csr, "lanes_flagged", flagged)
    fills, evs = _profiled(lambda: [csr.decode_to_csr(plan)[2]
                                    for _ in range(2)])
    assert [f > 0 for f in fills] == [flag, flag]
    first, again = sorted((e for e in evs if e.name == "wg.decode_to_csr"),
                          key=lambda e: e.time_range.start)
    calls = {"wg.b1", "wg.csr.flags", "wg.b2"}
    calls |= {"wg.csr.fill"} if flag else set()
    assert {e.name for e in evs if e.cpu_parent is first} == calls | {
        "wg.csr.index"}
    kids = sorted((e for e in evs if e.cpu_parent is again),
                  key=lambda e: e.time_range.start)
    assert [e.name for e in kids][:3] == ["wg.b1", "wg.csr.flags", "wg.b2"]
    assert {e.name for e in kids} == calls
    assert {_root(e).name for e in evs} == {"wg.decode_to_csr"}


def _path_with_cluster():
    lists = [[i + 1] for i in range(39)] + [[0, 20]]
    off = np.zeros(len(lists) + 1, dtype=np.int64)
    off[1:] = np.cumsum([len(x) for x in lists])
    return CSRGraph(off, np.concatenate(lists).astype(np.int64), device=CPU)


@pytest.mark.parametrize("external_chunk", [0, 64])
def test_hyperball_rounds_and_arcs(external_chunk):
    g = _path_with_cluster()
    hb = HyperBall(g, log2m=4, seed=3, gt=g.transpose(),
                   external_chunk=external_chunk)
    T.reset_counters()
    _, evs = _profiled(hb.run)
    rounds = sorted((e for e in evs if e.name.startswith("wg.hyperball.round.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in rounds] == [
        "wg.hyperball.round." + m for m in hb.mode_history]
    assert {"dense", "systolic"} <= {m.split("-")[0] for m in hb.mode_history}
    assert T.counters() == {"hyperball.arcs": sum(hb.arcs_touched)}
    for r in rounds:
        kids = {e.name for e in evs if e.cpu_parent is r}
        want = {"wg.hyperball.merge", "wg.hyperball.changed",
                "wg.hyperball.estimate"}
        if not r.name.endswith(("dense", "dense-external")):
            want.add("wg.hyperball.must_check")
        assert kids == want, r.name


def test_nothing_counted_without_a_profiler(basename):
    T.reset_counters()
    g = _path_with_cluster()
    HyperBall(g, log2m=4, seed=3, gt=g.transpose()).run()
    t0 = time.perf_counter()
    r = load_csr(basename, device=CPU).report
    wall = time.perf_counter() - t0
    assert T.counters() == {}
    assert set(r) == REPORT_KEYS and r["route"] == "kernel"
    parts = [r[k] for k in ("load_s", "read_s", "plan_s", "resolve_s",
                            "decode_to_csr_s")]
    assert all(isinstance(p, float) and p >= 0 for p in parts)
    assert sum(parts) <= wall
    with T.span("test") as s:
        time.sleep(0.01)
    assert s.seconds >= 0.01


def test_host_route_report(basename, monkeypatch):
    monkeypatch.setattr(bvgraph, "plan_kernel_decode", lambda *a, **k: None)
    g, evs = _profiled(lambda: load_csr(basename, device=CPU))
    assert set(g.report) == {"format", "route", "read_s", "host_decode_s",
                             "load_s"}
    assert g.report["route"] == "host" and g.report["host_decode_s"] > 0
    assert "wg.host_decode" in {e.name for e in evs}


def _ctx(tr, calls, **kw):
    return SimpleNamespace(trace=tr, calls=calls, counters=kw, env=None,
                           window_s=tr.window_s, kind="cpu")


def test_plan_readers_on_a_traced_load(traced_load):
    report, _, tr = traced_load
    ctx = _ctx(tr, 1, reports=[report])
    refs = load_module("layers", "plan_refs_s").read(ctx)
    tables = load_module("layers", "plan_tables_s").read(ctx)
    plan_s = load_module("layers", "plan_s").read(ctx)
    assert refs > 0 and tables > 0
    assert refs + tables <= plan_s
    assert load_module("layers", "csr_idle_ms").read(ctx) is None


def test_merged_arcs_reader_on_traced_runs():
    g = _path_with_cluster()
    gt = g.transpose()
    T.reset_counters()
    runs = []

    def window():
        for seed in (1, 2):
            hb = HyperBall(g, log2m=4, seed=seed, gt=gt)
            hb.run()
            runs.append(sum(hb.arcs_touched))

    _, tr = capture(window, CPU)
    got = load_module("layers", "merged_arcs_per_run").read(_ctx(tr, 2))
    assert got == sum(runs) / 2 / 1e9 > 0


def test_lane_steps_reader_on_traced_calls(basename):
    plan = _plan(basename)
    steps = int(csr.decode_chunked(plan)[:, csr.DIAG_STEPS].max())
    T.reset_counters()
    _, tr = capture(lambda: [csr.decode_to_csr(plan) for _ in range(3)], CPU)
    got = load_module("layers", "longest_lane_steps").read(_ctx(tr, 3))
    T.reset_counters()
    assert got == steps > 0
    assert load_module("layers", "longest_lane_steps").read(_ctx(tr, 3)) \
        is None


def test_csr_idle_reader_on_a_known_trace():
    # window 0..1000 us; device busy 100-300, 350-400, 700-800 and 900-950;
    # two decode_to_csr calls, 50-450 (idle 50 + 50 + 50 = 150) and
    # 650-850 (idle 50 + 50 = 100): 125 us a call
    dev = [("bv_decode_lanes", 100, 300), ("compact_runs", 350, 400),
           ("bv_decode_lanes", 700, 780), ("compact_runs", 770, 800),
           ("bv_decode_lanes", 900, 950)]
    host = [("wg.decode_to_csr", 50, 450), ("wg.b1", 60, 90),
            ("wg.decode_to_csr", 650, 850), ("aten::empty", 660, 661)]
    tr = Trace(dev, [("bench.decode_to_csr", 40, 460)], host, (0, 1000))
    read = load_module("layers", "csr_idle_ms").read
    assert read(_ctx(tr, 2)) == pytest.approx(0.125)
    bare = Trace(dev, [], [("aten::empty", 0, 5)], (0, 1000))
    assert read(_ctx(bare, 2)) is None
