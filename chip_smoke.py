#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``webgraph_tpu_torch``) on one GPU.

Drives the port's main path -- a cold BVGraph decode planned from the
stream and its offsets alone, into a device-resident CSR, then one
HyperBall round over it -- at uk-2002 scale (18.5M nodes, ~355M arcs of a
synthetic web graph), after holding both hand-written CUDA kernels against
their plain PyTorch versions on the card; and the probe path -- every probe
of the JAX package's ``experiments/`` ported to a CUDA kernel in
``webgraph_tpu_torch/experiments/`` -- at the probes' own shapes.

Phases, each printing one line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds the kernels, g++ the shared host library;
3. kernels: the decode kernel (B1) against ``decode_lanes_plain`` under
   four stream formats and one garbled stream, the compaction kernel (B2)
   against ``compact_plain`` on random run tables with invalid runs;
4. probes: with launch counts reset just before and read just after,
   every case of every probe module (``cases`` of ``probe``, ``probe2``
   ... ``probe17``: 23 probe sites, every variant) launches its kernel at
   the probe's step count, times it with CUDA events, and holds it equal
   to its plain version (at a smaller step count where the plain version
   at the full count would take too long; the line says which);
5. slice: the synthetic graph is generated and encoded (cached in
   ``.bench_synth_<N>.npz``), then plan -> resolve_halos -> decode_to_csr
   -> device_round with launch counts reset just before and read just
   after; then timings, both kernels against their plain versions at the
   shapes the slice gave them, and the CSR bit-exact against the native
   sequential decoder.

Then one JSON line of the kernels (both main-path kernels and the 23 probe
sites), one of the slice's numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without a CUDA device it fails before doing anything.

Usage: ``python3 chip_smoke.py``; it needs one CUDA device.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from webgraph_tpu import native  # noqa: E402
from webgraph_tpu.codecs.bvgraph import BVGraphSettings  # noqa: E402
from webgraph_tpu.codecs.bvgraph import CompressionFlags as C  # noqa: E402
from webgraph_tpu.utils.synth import synthesize_webgraph  # noqa: E402
from webgraph_tpu_torch import require_cuda  # noqa: E402
from webgraph_tpu_torch.algo import hyperball as HB  # noqa: E402
from webgraph_tpu_torch.experiments import common as PC  # noqa: E402
from webgraph_tpu_torch.ops import _build, kcompact, kdecode, kplan  # noqa
from webgraph_tpu_torch.ops.csr import decode_to_csr  # noqa: E402
from webgraph_tpu_torch.ops.resolve import resolve_halos  # noqa: E402

KERNELS = {
    "bv_decode_lanes": dict(source="webgraph_tpu_torch/csrc/bv_decode.cu",
                            replaces="webgraph_tpu/ops/kdecode.py:1105"),
    "compact_runs": dict(source="webgraph_tpu_torch/csrc/compact.cu",
                         replaces="webgraph_tpu/ops/kcompact.py:115"),
}
# the probe modules, in the order the probes phase runs them
PROBE_MODULES = ("probe", "probe2", "probe3", "probe4", "probe16", "probe5",
                 "probe6", "probe7", "probe8", "probe9", "probe10", "probe11",
                 "probe12", "probe13", "probe14", "probe15", "probe17")
_CS = "webgraph_tpu_torch/csrc/"
PROBE_SITES = _build.PROBE_SITES   # site: (kernel source, replaced site)
SLICE_NODES = 18_500_000   # uk-2002: 18.52M nodes (BASELINE.md)
CHECK_NODES = 20_000
CHECK_SETTINGS = {
    "default": BVGraphSettings(),
    "w0_noint": BVGraphSettings(window_size=0, min_interval_length=0),
    "delta_w4_int2": BVGraphSettings(outdegree_coding=C.DELTA, window_size=4,
                                     min_interval_length=2),
    "gamma_res": BVGraphSettings(residual_coding=C.GAMMA),
}
LOG2M = 4


def emit(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def cuda_ms(fn, reps: int = 1, warmup: int = 0) -> float:
    """Device time of ``fn`` (CUDA events around ``reps`` calls after
    ``warmup`` untimed ones), in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class Errors:
    """Largest kernel-vs-plain difference seen per kernel (must stay 0:
    every value is an integer, so the tolerance is exact equality)."""

    def __init__(self):
        self.err = {k: 0 for k in (*KERNELS, *PROBE_SITES)}

    def check(self, name: str, what: str, a, b) -> None:
        e = max_abs_diff(a, b)
        self.err[name] = max(self.err[name], e)
        if e:
            raise AssertionError(f"{name} != plain on {what}: max abs {e}")


def phase_device() -> torch.device:
    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    emit("device", dict(name=torch.cuda.get_device_name(0),
                        count=torch.cuda.device_count(),
                        torch=torch.__version__, cuda=torch.version.cuda))
    print(smi[0], flush=True)
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.use_built_native()
    gxx_s = time.perf_counter() - t0
    emit("build", dict(nvcc_s=nvcc_s, gxx_s=gxx_s, dir=_build.BUILD_DIR))


def _decode_vs_plain(plan, errors: Errors, what: str):
    """B1 on the card against its plain version, same store image.
    A decode's output depends on the halo rows and the stream only, never
    on what the chunk rows held before, so both start from one image.
    Returns (kernel ms, plain ms, diag)."""
    store_p = plan.store.clone()
    out = {}

    def kernel():
        out["k"] = kdecode.decode_lanes(plan.words, plan.meta, plan.store,
                                        plan.spec)

    def plain():
        out["p"] = kdecode.decode_lanes_plain(plan.words, plan.meta, store_p,
                                              plan.spec)

    ms = cuda_ms(kernel, warmup=1)
    plain_ms = cuda_ms(plain)
    errors.check("bv_decode_lanes", f"{what} store", plan.store, store_p)
    errors.check("bv_decode_lanes", f"{what} diag", out["k"], out["p"])
    return ms, plain_ms, out["k"]


def phase_kernels(dev, errors: Errors) -> None:
    co, su = synthesize_webgraph(CHECK_NODES, seed=3)
    n = CHECK_NODES
    rows = []
    for name, s in CHECK_SETTINGS.items():
        graph, _gb, offs, _ob, _st = native.bv_encode(co, su, s, threads=8)
        offsets = native.decode_offset_stream(offs, n, s.offset_coding)
        outd = np.diff(co)
        for garbled in ((False, True) if name == "default" else (False,)):
            data = graph.copy()
            if garbled:
                data[len(data) // 2:] = 0xFF
            plan = kplan.plan_kernel_decode(offsets, outd, s, data,
                                            device=dev, halo_csr=(co, su))
            tag = name + ("_garbled" if garbled else "")
            ms, plain_ms, diag = _decode_vs_plain(plan, errors, tag)
            errs = kdecode.check_diag(plan, diag)
            if garbled:
                if not errs.any():
                    raise AssertionError("garbled stream raised no flag")
            else:
                if errs.any():
                    raise AssertionError(f"{tag}: lanes flagged on a clean "
                                         f"stream: {np.unique(errs)}")
                _, succ, filled = decode_to_csr(plan)
                if filled or not np.array_equal(succ.cpu().numpy(), su):
                    raise AssertionError(f"{tag}: CSR differs from the graph")
            rows.append(dict(setting=tag, lanes=plan.lanes, arcs=plan.m,
                             flagged=int((errs != 0).sum()), ms=ms,
                             plain_ms=plain_ms))

    # B2 on random run tables with empty and invalid runs
    rng = np.random.default_rng(7)
    R = 1 << 16
    arcs = rng.integers(0, 600, size=R)
    arcs[rng.random(R) < 0.1] = 0
    gap = rng.integers(0, 64, size=R)
    arc_start = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(arcs, out=arc_start[1:])
    seg = arcs + gap
    src0 = np.cumsum(seg) - arcs
    m = int(arc_start[-1])
    valid = rng.random(R) >= 0.3
    store = torch.randint(0, 1 << 30, (int(seg.sum()),), dtype=torch.int32,
                          device=dev)
    cp = kcompact.plan_compact(arc_start, src0, valid, m, device=dev)
    got = kcompact.compact(cp, store)
    ms = cuda_ms(lambda: kcompact.compact(cp, store), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: kcompact.compact_plain(cp, store))
    exp = kcompact.compact_plain(cp, store)
    vmask = torch.from_numpy(np.repeat(valid, arcs)).to(dev)
    errors.check("compact_runs", "random runs", got[vmask], exp[vmask])
    rows.append(dict(setting="compact_random", runs=R, arcs=m,
                     invalid=int((~valid).sum()), ms=ms, plain_ms=plain_ms))
    emit("kernels", rows)


def phase_probes(dev, errors: Errors) -> dict:
    """The probe path: every case of every probe module, launch counts
    reset just before and read just after.  Returns per site its launches,
    summed kernel and plain ms and the number of cases."""
    mods = [importlib.import_module(f"webgraph_tpu_torch.experiments.{m}")
            for m in PROBE_MODULES]
    rng = np.random.default_rng(0)
    cases = [c for m in mods for c in m.cases(dev, rng)]
    _build.reset_launches()
    rows = PC.run_cases(cases)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in PROBE_SITES}
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the probe path never launched {k}")
    lines = []
    for r in rows:
        lines.append(dict(site=r.site, name=r.name.strip(), ms=r.ms,
                          floor_ms=r.floor_ms, plain_ms=r.plain_ms,
                          steps=r.steps,
                          checked_steps=r.checked_steps,
                          ns_per_step=r.ns_per_step, lanes=r.lanes,
                          tiles=r.tiles, max_abs_err=r.max_abs_err))
        errors.err[r.site] = max(errors.err[r.site], r.max_abs_err)
    emit("probes", lines)
    bad = [r.name for r in rows if not r.ok]
    if bad:
        raise AssertionError(f"probe kernels differ from their plain "
                             f"versions: {bad}")
    per_site = {k: dict(launches=v, ms=0.0, plain_ms=0.0, cases=0)
                for k, v in launches.items()}
    for r in rows:
        d = per_site[r.site]
        d["ms"] += r.ms
        d["plain_ms"] += r.plain_ms
        d["cases"] += 1
    return per_site


def synth_input(n_nodes: int):
    """The encoded synthetic graph, cached in .bench_synth_<N>.npz (the
    format bench_synth.py writes)."""
    settings = BVGraphSettings()
    cache = os.path.join(ROOT, f".bench_synth_{n_nodes}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        z = np.load(cache)
        data, offsets = z["data"], z["offsets"]
        n, m = int(z["n"]), int(z["m"])
        src = "cache"
    else:
        co, su = synthesize_webgraph(n_nodes)
        n, m = n_nodes, int(co[-1])
        graph, gbits, offs, _ob, _st = native.bv_encode(
            co, su, settings, threads=os.cpu_count() or 1)
        del co, su
        offsets = native.decode_offset_stream(offs, n,
                                              settings.offset_coding)
        data = graph
        np.savez(cache, data=data, offsets=offsets, n=n, m=m, gbits=gbits)
        src = "generated"
    return data, offsets, n, m, settings, src, time.perf_counter() - t0


def phase_slice(dev, errors: Errors, n_nodes: int) -> dict:
    data, offsets, n, m, settings, src, input_s = synth_input(n_nodes)
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, launch counts reset just before ----
    _build.reset_launches()
    t0 = time.perf_counter()
    outd = native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    plan = kplan.plan_kernel_decode(offsets, outd, settings, data,
                                    device=dev)
    if plan is None or not plan.cold:
        raise AssertionError("no cold plan for the default settings")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    passes = resolve_halos(plan)
    torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    co, succ, filled = decode_to_csr(plan)
    torch.cuda.synchronize()
    first_csr_s = time.perf_counter() - t0
    regs0 = torch.from_numpy(HB.hyperloglog_init(n, LOG2M, seed=1)).to(dev)
    regs1 = HB.device_round(co, succ, regs0)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    peak_main = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the main path never launched {k}")

    # ---- timings (steady state: a resolved plan) ----
    decode_ms = min(cuda_ms(lambda: kdecode.decode_chunked(plan))
                    for _ in range(3))
    csr_times = []
    for _ in range(3):
        succ = None
        t0 = time.perf_counter()
        _, succ, _ = decode_to_csr(plan)
        torch.cuda.synchronize()
        csr_times.append(time.perf_counter() - t0)
    csr_s = min(csr_times)
    hb_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = HB.device_round(co, succ, regs0)
        torch.cuda.synchronize()
        hb_times.append(time.perf_counter() - t0)
        del r
    hb_s = min(hb_times)
    compact_ms = min(cuda_ms(lambda: kcompact.compact(plan.compact_plan,
                                                      plan.store))
                     for _ in range(3))
    lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs

    # ---- both kernels against their plain versions, slice shapes ----
    _, decode_plain_ms, diag = _decode_vs_plain(plan, errors, "slice")
    got = kcompact.compact(plan.compact_plan, plan.store)
    t0 = time.perf_counter()
    exp = kcompact.compact_plain(plan.compact_plan, plan.store)
    torch.cuda.synchronize()
    compact_plain_ms = (time.perf_counter() - t0) * 1e3
    errors.check("compact_runs", "slice", got, exp)
    del got, exp

    # ---- correctness against the native sequential decoder ----
    t0 = time.perf_counter()
    hco, hsu = native.bv_decode_all(data, n, m, settings)
    host_s = time.perf_counter() - t0
    if filled or kdecode.check_diag(plan, diag).any():
        raise AssertionError("lanes flagged on a clean stream")
    if not np.array_equal(co, hco):
        raise AssertionError("CSR offsets differ from the native decode")
    succ_h = succ.cpu().numpy()
    if not np.array_equal(succ_h, hsu):
        bad = np.flatnonzero(succ_h != hsu)
        raise AssertionError(f"CSR differs from the native decode at "
                             f"{len(bad)} arcs, first {bad[:5]}")
    # the HyperBall round against a host merge on sampled nodes
    r0 = regs0.cpu().numpy()
    r1 = regs1.cpu().numpy()
    if r1.shape != r0.shape or (r1 < r0).any():
        raise AssertionError("HyperBall round lowered a register")
    rng = np.random.default_rng(0)
    for x in rng.integers(0, n, size=2000):
        want = r0[x].copy()
        ys = hsu[hco[x]:hco[x + 1]]
        if len(ys):
            want = np.maximum(want, r0[ys].max(axis=0))
        if not np.array_equal(r1[x], want):
            raise AssertionError(f"HyperBall registers of node {x} differ")
    est = HB.estimate_counts(r1[:100000])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite HyperBall estimates")

    return dict(
        input=src, nodes=n, arcs=m, input_s=input_s,
        lanes=plan.lanes, longest_lane_arcs=int(lane_arcs.max()),
        halo_arcs=int(plan.halo_arcs.sum()), store_elems=int(
            plan.store_off[-1]),
        plan_s=plan_s, resolve_s=resolve_s, resolve_passes=passes,
        first_decode_to_csr_s=first_csr_s,
        decode_ms=decode_ms, decode_Medges_per_s=m / decode_ms / 1e3,
        decode_to_csr_s=csr_s, decode_to_csr_Medges_per_s=m / csr_s / 1e6,
        compact_ms=compact_ms, hyperball_round_s=hb_s, log2m=LOG2M,
        fallback_arc_frac=filled / max(m, 1),
        host_decode_s=host_s, host_decode_Medges_per_s=m / host_s / 1e6,
        peak_main_path_bytes=peak_main,
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, decode_plain_ms=decode_plain_ms,
        compact_plain_ms=compact_plain_ms, bit_exact=True)


def main() -> int:
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    errors = Errors()
    phase_kernels(dev, errors)
    t0 = time.perf_counter()
    probes = phase_probes(dev, errors)
    probes_s = time.perf_counter() - t0
    res = phase_slice(dev, errors, SLICE_NODES)
    emit("slice", res)
    times = {"bv_decode_lanes": (res["decode_ms"], res["decode_plain_ms"]),
             "compact_runs": (res["compact_ms"], res["compact_plain_ms"])}
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=res["launches"][k],
                    max_abs_err=errors.err[k], ms=times[k][0],
                    plain_ms=times[k][1])
               for k, v in KERNELS.items()]
    # a probe site's ms and plain_ms: the sums over its cases
    kernels += [dict(name=k, route="cuda", source=_CS + src, replaces=rep,
                     launches=probes[k]["launches"],
                     max_abs_err=errors.err[k], ms=probes[k]["ms"],
                     plain_ms=probes[k]["plain_ms"])
                for k, (src, rep) in PROBE_SITES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", dict(seconds=time.perf_counter() - t_start,
                       probes_s=probes_s))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
