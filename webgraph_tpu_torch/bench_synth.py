"""uk-2002-scale synthetic benchmark of the port (BASELINE.md's headline scale).

The counterpart of the repository's ``bench_synth.py``.  Generates a
power-law web-like graph (``utils/synth.py``), encodes it with the native
multithreaded encoder, then times the cold decode exactly like the
basename's in :mod:`webgraph_tpu_torch.bench`.  The synthetic CSR is the
ground truth: the native decode of the encoded stream must equal it (the
encode round trip, on the run that builds the cache), and the device decode
must equal that oracle bit for bit.

The stream is cached in ``.bench_synth_<N>.npz`` (keys ``data``,
``offsets``, ``n``, ``m``, ``gbits``), the file the JAX bench and
``chip_smoke.py`` read and write, so the three share one cache.  After the
timing the stream is decoded on the host (its rate is the port's first
bar) and re-encoded, and the re-encode must reproduce the cached stream.

Scale: BENCH_SYNTH_NODES nodes at mean outdegree ~19: 18.5M nodes give
~355M arcs, the uk-2002 regime (18.52M nodes / 298.1M arcs).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import native
from .bench import ROOT, _log, bench_graph
from .settings import BVGraphSettings
from .utils.synth import synthesize_webgraph

__all__ = ["bench_synth"]


class _SynthBV:
    """Duck-typed stand-in for BVGraph in ``bench.bench_graph``."""

    def __init__(self, data, n, m, settings, offsets):
        self.data = data
        self.num_nodes = n
        self.num_arcs = m
        self.settings = settings
        self.offsets = offsets


def bench_synth(n_nodes, target_arcs, *, device, cache_dir=ROOT):
    """The synthetic's row: ``bench_graph``'s extras plus its nodes, arcs,
    generation seconds (-1 on a cache hit), native encode and host decode
    rates and bits per link."""
    settings = BVGraphSettings()
    threads = os.cpu_count() or 1
    # the generator is seeded, so the encoded stream is cached across runs
    cache = os.path.join(cache_dir, f".bench_synth_{n_nodes}.npz")
    gen_s = -1.0
    hit = os.path.exists(cache)
    if hit:
        with np.load(cache) as z:
            data, offsets = z["data"], z["offsets"]
            n, m, gbits = int(z["n"]), int(z["m"]), int(z["gbits"])
        _log(f"synth cache hit: n={n} m={m}")
    else:
        t0 = time.perf_counter()
        co, su = synthesize_webgraph(n_nodes)
        n, m = n_nodes, int(co[-1])
        gen_s = time.perf_counter() - t0
        _log(f"synth: n={n} m={m} gen {gen_s:.1f}s")
        data, gbits, offs_stream, _ob, _st = native.bv_encode(
            co, su, settings, threads=threads)
        offsets = native.decode_offset_stream(offs_stream, n,
                                              settings.offset_coding)
        hco0, hsu0 = native.bv_decode_all(data, n, m, settings)
        if not (np.array_equal(hco0, co) and np.array_equal(hsu0, su)):
            raise RuntimeError("synthetic encode roundtrip mismatch")
        del co, su, hco0, hsu0
        tmp = f"{cache}.tmp{os.getpid()}.npz"
        np.savez(tmp, data=data, offsets=offsets, n=n, m=m, gbits=gbits)
        os.replace(tmp, cache)

    # the cold decode first: the plan and the timing never see an oracle
    # decode (bench_graph decodes it after its timing)
    bv = _SynthBV(data, n, m, settings, offsets)
    _, extra = bench_graph(bv, data, target_arcs, device=device)
    if not extra["bit_exact"]:
        raise RuntimeError("synthetic kernel decode not bit-exact")

    # host decode rate (the first bar) and the encode's; the re-encode
    # must reproduce the cached stream
    t0 = time.perf_counter()
    hco, hsu = native.bv_decode_all(data, n, m, settings)
    dec_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g2, gbits2 = native.bv_encode(hco, hsu, settings, threads=threads)[:2]
    enc_s = time.perf_counter() - t0
    if gbits2 != gbits or not np.array_equal(g2, data):
        raise RuntimeError("synthetic re-encode diverged from cached stream")
    del g2, hco, hsu
    _log(f"host decode {dec_host_s:.1f}s encode {enc_s:.1f}s")
    extra.update(nodes=n, arcs=m, cache_hit=hit, gen_s=gen_s,
                 encode_Medges_per_s=m / enc_s / 1e6, encode_threads=threads,
                 encode_bits_per_link=gbits / m,
                 host_decode_Medges_per_s=m / dec_host_s / 1e6)
    return extra


if __name__ == "__main__":
    from .device import require_cuda
    print(json.dumps(bench_synth(
        int(os.environ.get("BENCH_SYNTH_NODES", 18_500_000)),
        int(os.environ.get("BENCH_TARGET_ARCS", 128)),
        device=require_cuda()), default=str))
