"""Headline benchmark of the port: BVGraph cold decode throughput on one GPU.

The counterpart of the repository's ``bench.py`` (the JAX package's), run as
``python -m webgraph_tpu_torch.bench``.  It decodes a BVGraph basename
(``--basename``; cnr-2000 by default, 325,557 nodes / 3,216,152 arcs, w=7
maxref=3 minInterval=3 zeta_3) and the uk-2002-scale synthetic of
:mod:`webgraph_tpu_torch.bench_synth` with the port's two kernels, B1
(``csrc/bv_decode.cu``) and B2 (``csrc/compact.cu``), and prints ONE JSON
line: ``metric``, ``value`` (Medges/s), ``unit`` and ``vs_baseline``.  The
rows behind it go to ``--extra-out`` (``bench_torch_extra.json`` at the
repository root), each with the card's name and power limit, the torch and
CUDA versions and the row's B1 and B2 launches.

Protocol, in the JAX bench's order:

1. the kernels and the host library are built first, timed on their own
   (the ``build`` row): no build falls inside a timed window;
2. a COLD plan from ``.graph``/``.offsets``/settings alone
   (``native.decode_outdegrees``, ``kplan.plan_kernel_decode``), then its
   halos resolved by wavefront passes of B1 (``resolve.resolve_halos``);
3. warm-up: the CSR index and a first ``decode_to_csr`` (``warm_s``).  Lanes
   the decode flags are decoded on the host; their arcs give
   ``fallback_arc_frac``, 0 on a clean stream;
4. the headline: 3 windows of ``depth`` back-to-back ``decode_chunked``
   launches, one synchronise at each window's end; the median window over
   ``depth``, host clock (``decode_window_s``).  CUDA events around the
   same launches give B1's device time per launch (``decode_ms``, and
   ``decode_Medges_per_s``, the metric of that name in PERF.md);
5. ``decode_to_csr``, median of 3 calls; one HyperBall round (log2m 4) over
   the CSR, its per-arc source index built outside the timing;
6. only then the native sequential decode, the oracle, and the check that
   the device CSR equals it bit for bit.

The basename's rows add the native multithreaded encode, the device encode
(``vencode.EncodeDevicePlan``, held byte-identical to the stored stream,
so store the basename single-stream) and the EFGraph device decode.

``vs_baseline`` is the rate over the JAX bench's target: 10x an estimated
single-thread Java decode (~200 M edges/s, BASELINE.md), so 1.0 at 2.0 G
edges/s.  It is not a TPU figure.

Not carried over from the JAX bench, and why:

- ``v_cap``/``r_cap`` (``BENCH_VCAP``/``BENCH_RCAP``) and
  ``BENCH_HUB_DEVICE``: the TPU's scratch envelopes and its hub path.  The
  port sizes each lane's store segment exactly, so no lane is cut and no
  hub is split: a large node makes a long lane;
- ``WG_CSR_ENGINE=gather``: it bypasses the compaction kernel, which here
  would be a second route that hides B2;
- the ``jax.jit`` warm-up that switched the TPU runtime into its truthful
  dispatch mode: a CUDA launch needs none;
- ``spec=dict(T, V, R)``, the TPU tile shape: here ``spec`` holds the
  plan's ``lanes``, ``store_elems`` and ``target_arcs_per_lane``.

Env knobs: BENCH_TARGET_ARCS (arcs per lane, default 128),
BENCH_SYNTH_NODES (the synthetic's nodes, default 18,500,000; 0 disables
it), BENCH_VERBOSE (progress on stderr).

Exit code 0 when every row that ran raised nothing and is bit-exact (and
byte-identical); 1 otherwise.  A failing row keeps its error in the extra
file and does not lose the headline; when no decode ran bit-exact there is
no headline to print.  ``--device cpu`` runs the kernels' plain versions
(for tests: its rates are the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import native
from .algo import hyperball as HB
from .codecs.bvgraph import BVGraph
from .core.graph import CSRGraph, sync
from .device import require_cuda
from .ops import _build, kdecode, kplan
from .ops.csr import decode_to_csr, plan_csr_index
from .ops.resolve import resolve_halos

__all__ = ["bench_graph", "bench_ef", "bench_device_encode", "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX bench's fixture (bench.py:61): the reference's cnr-2000 basename
CNR = "/root/reference/slow/it/unimi/dsi/big/webgraph/cnr-2000"
JAVA_SINGLE_THREAD_EDGES_PER_S = 200e6  # documented estimate (BASELINE.md)
TARGET = 10 * JAVA_SINGLE_THREAD_EDGES_PER_S
METRIC_SYNTH = "bvgraph_cold_decode_uk2002scale_edges_per_sec"
METRIC_BASENAME = "bvgraph_cold_decode_cnr2000_edges_per_sec"
KERNELS = ("bv_decode_lanes", "compact_runs")   # B1, B2
LOG2M = 4
WINDOWS = 3


def _log(*a):
    if os.environ.get("BENCH_VERBOSE"):
        print(*a, file=sys.stderr, flush=True)


def build(device) -> float:
    """Build what the bench runs -- the host library, and the kernels when
    ``device`` is a card -- and return the seconds it took (about 0 once
    built)."""
    t0 = time.perf_counter()
    native.lib_path()
    if torch.device(device).type == "cuda":
        _build.lib()
    return time.perf_counter() - t0


def bench_graph(bv, data, target_arcs, *, device, oracle=None):
    """Cold plan + timed decode of one BVGraph on ``device``.

    ``bv``: ``offsets`` (int64[n+1] bit offsets), ``settings``,
    ``num_nodes``, ``num_arcs``; ``data``: the stream bytes; ``oracle``:
    (csr_off, succ) to hold the decode to, else the native sequential
    decode of ``data``, run after the timing.  Returns (decode_s, extras):
    ``decode_s`` is the headline's seconds per decode."""
    device = torch.device(device)
    build(device)   # outside every timed window
    m = bv.num_arcs

    # ---- cold plan: .graph/.offsets/settings only ----
    t0 = time.perf_counter()
    outd = native.decode_outdegrees(data, bv.offsets,
                                    bv.settings.outdegree_coding)
    plan = kplan.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                    device=device,
                                    target_arcs_per_lane=target_arcs)
    sync(device)
    plan_s = time.perf_counter() - t0
    if plan is None:
        raise RuntimeError("config outside kernel envelope")
    if not plan.cold:
        raise RuntimeError("plan must not see any oracle decode")
    t0 = time.perf_counter()
    passes = resolve_halos(plan)
    sync(device)
    resolve_s = time.perf_counter() - t0
    _log(f"plan {plan_s:.2f}s resolve {resolve_s:.2f}s ({passes} passes)")

    # ---- warm-up: the CSR index, a first decode_to_csr, the host fill ----
    t0 = time.perf_counter()
    plan_csr_index(plan)
    co, succ, filled = decode_to_csr(plan)
    sync(device)
    warm_s = time.perf_counter() - t0
    del succ
    bad_lanes = int((kdecode.check_diag(
        plan, kdecode.decode_chunked(plan)) != 0).sum())
    _log(f"warm {warm_s:.2f}s bad lanes {bad_lanes} fallback arcs {filled}")

    # ---- timed windows of back-to-back launches ----
    store_bytes = plan.store.numel() * plan.store.element_size()
    depth = max(1, min(5, int(5e9 // max(store_bytes, 1))))
    windows, events = [], []
    for _ in range(WINDOWS):
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if device.type == "cuda" else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        res = [kdecode.decode_chunked(plan) for _ in range(depth)]
        if ev:
            ev[1].record()
        sync(device)
        windows.append((time.perf_counter() - t0) / depth)
        if ev:
            events.append(ev[0].elapsed_time(ev[1]) / depth)
        del res
    decode_s = sorted(windows)[WINDOWS // 2]
    decode_ms = sorted(events)[WINDOWS // 2] if events else None
    _log(f"depth {depth} window {decode_s:.6f}s events {decode_ms} ms")

    csr_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, s, _ = decode_to_csr(plan)
        sync(device)
        csr_times.append(time.perf_counter() - t0)
        del s
    csr_s = sorted(csr_times)[1]

    # ---- one HyperBall round over the device CSR ----
    co_t, succ_t, _ = decode_to_csr(plan)
    g = CSRGraph.from_decoded(co_t, succ_t)
    regs = HB.hyperloglog_init_device(bv.num_nodes, LOG2M, 0, device)
    r = HB.device_round(g.offsets, g.succ, regs)
    sync(device)
    t0 = time.perf_counter()
    r = HB.device_round(g.offsets, g.succ, regs)
    sync(device)
    hb_s = time.perf_counter() - t0
    del r, regs, g, succ_t

    # ---- the oracle, decoded NOW, after the timing ----
    if oracle is None:
        hco, hsu = native.bv_decode_all(data, bv.num_nodes, m, bv.settings)
    else:
        hco, hsu = oracle
    _, succ, _ = decode_to_csr(plan)
    ok = (np.array_equal(co, hco)
          and np.array_equal(succ.cpu().numpy(), hsu))
    del succ
    lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs

    extras = dict(
        device=str(device), nodes=bv.num_nodes, arcs=m,
        plan_s=plan_s, resolve_s=resolve_s, resolve_passes=passes,
        warm_s=warm_s, bit_exact=bool(ok), depth=depth,
        decode_window_s=decode_s,
        decode_window_Medges_per_s=m / decode_s / 1e6,
        decode_ms=decode_ms,
        decode_Medges_per_s=(m / decode_ms / 1e3 if decode_ms else None),
        csr_s=csr_s, decode_to_csr_Medges_per_s=m / csr_s / 1e6,
        hyperball_round_s=hb_s, log2m=LOG2M,
        bad_lanes=bad_lanes, fallback_arcs=filled,
        fallback_arc_frac=filled / max(m, 1),
        longest_lane_arcs=int(lane_arcs.max()),
        spec=dict(lanes=plan.lanes, store_elems=int(plan.store_off[-1]),
                  target_arcs_per_lane=target_arcs))
    return decode_s, extras


def bench_ef(bv, hco, hsu, *, device):
    """EFGraph on-device decode of the same graph: ``EFGraph.store`` of its
    CSR, loaded back, then ``EFDevicePlan.decode`` (torch ops), median of
    3 decodes of the resident stream, held equal to (hco, hsu)."""
    from .codecs.efgraph import EFGraph
    from .ops.efdecode import EFDevicePlan

    device = torch.device(device)
    with tempfile.TemporaryDirectory() as td:
        base = os.path.join(td, "ef")
        t0 = time.perf_counter()
        EFGraph.store(CSRGraph(hco, hsu, num_nodes=bv.num_nodes,
                               device="cpu"), base)
        enc_s = time.perf_counter() - t0
        ef = EFGraph.load(base)

    # the plan uploads the stream once; each decode is the device CSR
    t0 = time.perf_counter()
    plan = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                        ef.log2_quantum, device=device)
    co, succ = plan.decode()
    sync(device)
    warm = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        co, succ = plan.decode()
        sync(device)
        times.append(time.perf_counter() - t0)
    dec_s = sorted(times)[1]
    ok = (np.array_equal(co.cpu().numpy(), hco)
          and np.array_equal(succ.cpu().numpy(), hsu))
    return dict(encode_s=enc_s, warm_s=warm, decode_s=dec_s,
                decode_Medges_per_s=len(hsu) / dec_s / 1e6,
                bit_exact=bool(ok))


def bench_device_encode(hco, hsu, settings, golden_bytes=None, *, device):
    """The device encoder (``vencode.EncodeDevicePlan``): CSR -> BVGraph
    stream on ``device``, single-stream.  The CSR uploads once; each timed
    encode is the device pipeline, the host's greedy selection and the
    stream's download (best of 2).  ``golden_bytes``: the stream it must
    reproduce byte for byte."""
    from .ops import vencode

    device = torch.device(device)
    m = int(hco[-1])
    t0 = time.perf_counter()
    plan = vencode.EncodeDevicePlan(hco, hsu, settings, device=device)
    gbytes, gbits = plan.encode()[:2]
    sync(device)
    warm = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        gbytes, gbits = plan.encode()[:2]
        sync(device)
        times.append(time.perf_counter() - t0)
    enc_s = min(times)
    r = dict(warm_s=warm, encode_s=enc_s,
             encode_Medges_per_s=m / enc_s / 1e6,
             bits_per_link=gbits / max(m, 1))
    if golden_bytes is not None:
        r["byte_identical"] = bool(np.array_equal(
            np.frombuffer(gbytes, dtype=np.uint8),
            np.asarray(golden_bytes, dtype=np.uint8)))
    return r


def _machine(device: torch.device) -> dict:
    """What every row carries: the card's name and power limit as
    nvidia-smi gives them (None off a card), the torch and CUDA versions."""
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda)


def _row(results: dict, key: str, machine: dict, fn) -> None:
    """``results[key] = fn()`` with the launch counts reset just before and
    read just after; an exception becomes the row's ``error``."""
    _build.reset_launches()
    try:
        row = fn()
    except Exception as e:  # noqa: BLE001 -- a row must not lose the rest
        traceback.print_exc(file=sys.stderr)
        row = {"error": repr(e)}
    row.update(machine)
    row["launches"] = {k: _build.LAUNCHES[k] for k in KERNELS}
    results[key] = row


def _failed(row: dict) -> bool:
    return ("error" in row or row.get("bit_exact") is False
            or row.get("byte_identical") is False)


def _basename_rows(results: dict, basename: str, target_arcs: int,
                   device: torch.device, machine: dict) -> None:
    """The basename's rows: its decode (with the native encode beside it),
    the device encode and the EF decode, keyed by the basename's stem."""
    stem = os.path.basename(basename.rstrip(os.sep))
    keys = (stem, f"{stem}_device_encode", f"{stem}_ef")
    if not os.path.exists(basename + ".graph"):
        for k in keys:
            results[k] = {"skipped": f"{basename} not found"}
        return
    held = {}

    def graph_row():
        bv = BVGraph.load(basename)
        data = np.asarray(bv.data)
        m = bv.num_arcs
        _, extra = bench_graph(bv, data, target_arcs, device=device)
        hco, hsu = native.bv_decode_all(data, bv.num_nodes, m, bv.settings)
        threads = os.cpu_count() or 1
        t0 = time.perf_counter()
        gbits = native.bv_encode(hco, hsu, bv.settings, threads=threads)[1]
        enc_s = time.perf_counter() - t0
        extra.update(encode_Medges_per_s=m / enc_s / 1e6,
                     encode_threads=threads,
                     encode_bits_per_link=gbits / max(m, 1))
        held.update(bv=bv, data=data, hco=hco, hsu=hsu)
        return extra

    _row(results, stem, machine, graph_row)
    if not held:
        for k in keys[1:]:
            results[k] = {"skipped": f"the {stem} row failed"}
        return
    bv, hco, hsu = held["bv"], held["hco"], held["hsu"]
    _row(results, keys[1], machine, lambda: bench_device_encode(
        hco, hsu, bv.settings, golden_bytes=held["data"], device=device))
    _row(results, keys[2], machine,
         lambda: bench_ef(bv, hco, hsu, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m webgraph_tpu_torch.bench",
        description="Time the port's cold BVGraph decode on the card and "
                    "print one JSON line.")
    ap.add_argument("--basename", default=CNR,
                    help="BVGraph basename to decode (default: cnr-2000)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--extra-out",
                    default=os.path.join(ROOT, "bench_torch_extra.json"),
                    help="where the rows go (JSON)")
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None else torch.device(
        args.device)
    target_arcs = int(os.environ.get("BENCH_TARGET_ARCS", 128))
    synth_nodes = int(os.environ.get("BENCH_SYNTH_NODES", 18_500_000))

    machine = _machine(device)
    results = {}
    _row(results, "build", machine, lambda: dict(build_s=build(device)))
    _basename_rows(results, args.basename, target_arcs, device, machine)
    # uk-2002-scale synthetic (~18.5M nodes / ~355M arcs) by default
    if synth_nodes:
        from .bench_synth import bench_synth
        _row(results, "synthetic", machine,
             lambda: bench_synth(synth_nodes, target_arcs, device=device))

    with open(args.extra_out, "w") as f:
        json.dump(results, f, indent=1, default=str)

    # headline: BASELINE.md's build target is uk-2002 scale, so the
    # synthetic's rate when it ran bit-exact; the basename's otherwise
    stem = os.path.basename(args.basename.rstrip(os.sep))
    failed = sorted(k for k, r in results.items() if _failed(r))
    for metric, key in ((METRIC_SYNTH, "synthetic"),
                        (METRIC_BASENAME, stem)):
        row = results.get(key, {})
        if row.get("bit_exact"):
            value = row["decode_window_Medges_per_s"]
            print(json.dumps({"metric": metric, "value": value,
                              "unit": "Medges/s",
                              "vs_baseline": value * 1e6 / TARGET}),
                  flush=True)
            break
    else:
        failed.append("no decode ran bit-exact")
    if failed:
        print(f"bench: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
