"""CLI implementation.  See the package docstring for the command map.

The commands, arguments, printed lines and written files are those of
``webgraph_tpu/cli/main.py``; what differs:

- ``--device`` (on every command) in place of the JAX ``WEBGRAPH_PLATFORM``
  switch.  With none, the command runs on the GPU and raises where there is
  none; ``--device cpu`` runs the same code on the host (the kernels' plain
  versions).
- Graphs reach the device through ``load_csr`` (BVGraph: the cold plan and
  the kernels B1 and B2; formats with no device decoder: a host scan,
  uploaded), and re-encodes into one BVGraph stream use the device encoder.
- ``speedtest``'s sequential mode times ``decode_to_csr`` of a resolved plan
  (B1 and B2), in place of the JAX package's ``vdecode2``.

Every command imports its modules when it runs: ``--help`` builds nothing
and loads no kernel.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np


def _device(name):
    import torch

    from ..device import require_cuda
    return require_cuda() if name is None else torch.device(name)


def _load(basename: str, mode: str = "standard"):
    """The host graph of any registered format."""
    from ..core import graph as core
    return core.load(basename, mode=mode)


def _csr(basename: str, dev):
    """The graph at ``basename`` as a ``CSRGraph`` on ``dev``."""
    from ..core.graph import load_csr
    return load_csr(basename, dev)


def _settings(window_size=-1, max_ref_count=-1, min_interval_length=-1,
              zeta_k=-1):
    """``BVGraph.store``'s settings from its -1-means-default knobs."""
    from ..settings import BVGraphSettings
    s = BVGraphSettings()
    for k, v in (("window_size", window_size),
                 ("max_ref_count", max_ref_count),
                 ("min_interval_length", min_interval_length),
                 ("zeta_k", zeta_k)):
        if v >= 0:
            s = replace(s, **{k: v})
    return s


def _store_one_stream(g, dest: str, dev, **knobs) -> None:
    """Store ``g`` as a BVGraph encoded in one stream: the bytes the JAX CLI
    writes when it stores a graph it scans sequentially.  The device
    encoder where it covers the settings, else the native encoder on one
    thread."""
    from ..codecs.bvgraph import BVGraph
    from ..ops import vencode
    s = _settings(**knobs)
    if vencode.supported(s):
        BVGraph.store(g, dest, settings=s, backend="cuda", device=dev)
    else:
        BVGraph.store(g, dest, settings=s, backend="native", num_threads=1)


def cmd_bvgraph(args) -> int:
    if args.offsets:
        g = _load(args.source)
        offs = g.decode_offsets_from_stream()
        from ..ops.bitio import BitWriter
        w = BitWriter()
        prev = 0
        for o in offs.tolist():
            g.settings.write_offset(w, o - prev)
            prev = o
        with open(args.source + ".offsets", "wb") as f:
            f.write(w.to_bytes())
        return 0
    if args.outdegrees:
        g = _load(args.source)
        g.write_outdegrees(args.source + ".outdegrees")
        return 0
    if args.obl:
        g = _load(args.source)
        print(g.write_offsets_cache(args.source))
        return 0
    dest = args.dest or args.source
    g = _csr(args.source, args.dev)
    _store_one_stream(g, dest, args.dev, window_size=args.window_size,
                      max_ref_count=args.max_ref_count,
                      min_interval_length=args.min_interval_length,
                      zeta_k=args.zeta_k)
    return 0


def cmd_efgraph(args) -> int:
    from ..codecs.efgraph import EFGraph
    g = _csr(args.source, args.dev)
    EFGraph.store(g, args.dest or args.source,
                  log2_quantum=args.log2_quantum,
                  upper_bound=args.upper_bound)
    return 0


def cmd_transform(args) -> int:
    from .. import transform as T
    from ..core import graph as core
    g = _csr(args.source, args.dev)
    op = args.operation
    if op in ("transpose", "transposeOffline"):
        out = T.transpose_offline(g) if "Offline" in op else T.transpose(g)
    elif op in ("symmetrize", "symmetrizeOffline"):
        out = (T.symmetrize_offline(g) if "Offline" in op
               else T.symmetrize(g))
    elif op in ("simplify", "simplifyOffline"):
        out = T.simplify_offline(g) if "Offline" in op else T.simplify(g)
    elif op == "identity":
        # the JAX CLI stores the loaded graph itself, sequentially
        _store_one_stream(g, args.dest, args.dev)
        return 0
    elif op in ("mapOffline", "map"):
        node_map = np.fromfile(args.map_file, dtype=">i8").astype(np.int64)
        out = T.map_offline(g, node_map)
    elif op == "union":
        out = T.union(g, _csr(args.other, args.dev))
    elif op == "compose":
        out = T.compose(g, _csr(args.other, args.dev))
    elif op in ("gray", "grayPerm", "lex", "lexPerm", "random"):
        if op.startswith("gray"):
            perm = T.gray_code_permutation(g)
        elif op.startswith("lex"):
            perm = T.lexicographical_permutation(g)
        else:
            perm = T.random_permutation(g, seed=args.seed)
        if op.endswith("Perm"):
            perm.cpu().numpy().astype(">i8").tofile(args.dest)
            return 0
        out = T.apply_permutation(g, perm)
    elif op == "arcfilter":
        if args.filter == "NO_LOOPS":
            out = T.filter_arcs(g, T.no_loops)
        else:
            raise SystemExit(f"unknown filter {args.filter}")
    else:
        raise SystemExit(f"unknown operation {op}")
    core.store(out, args.dest)
    if hasattr(out, "cleanup"):
        out.cleanup()
    return 0


def cmd_ascii(args) -> int:
    from ..codecs.ascii import ASCIIGraph
    if args.to_ascii:
        ASCIIGraph.store(_csr(args.source, args.dev), args.dest)
    else:
        g = ASCIIGraph.load(args.source, mode="offline").to_device(args.dev)
        _store_one_stream(g, args.dest, args.dev)
    return 0


def cmd_scattered(args) -> int:
    from ..codecs.scattered import ScatteredArcsASCIIGraph
    from ..core import graph as core
    g = ScatteredArcsASCIIGraph(
        args.source if args.source != "-" else sys.stdin,
        symmetrize=args.symmetrize, no_loops=args.no_loops, device=args.dev)
    core.store(g.batch_graph, args.dest)
    g.save_ids(args.dest + ".ids")
    g.batch_graph.cleanup()
    return 0


def cmd_stats(args) -> int:
    import torch

    from ..utils.stats import compute_stats, write_stats
    g = _csr(args.source, args.dev)
    comp = None
    if args.scc:
        from ..algo import strongly_connected_components
        _, comp = strongly_connected_components(g)
    s = compute_stats(g, component=comp)
    write_stats(s, args.dest or args.source)
    for k, v in s.items():
        if not isinstance(v, torch.Tensor):
            print(f"{k}={v}")
    return 0


def cmd_hyperball(args) -> int:
    from ..algo import HyperBall
    g = _csr(args.source, args.dev)
    hb = HyperBall(g, log2m=args.log2m, seed=args.seed,
                   do_sum_of_distances=args.sum_of_distances,
                   do_sum_of_inverse_distances=args.harmonic)
    nf = hb.run(upper_bound=args.upper_bound, threshold=args.threshold)
    for t, v in enumerate(nf):
        print(f"{t}\t{v}")
    if args.harmonic and args.dest:
        hb.sum_of_inverse_distances.cpu().numpy().tofile(args.dest)
    return 0


def cmd_bfs(args) -> int:
    from ..algo import bfs
    g = _csr(args.source, args.dev)
    dist, rounds = bfs(g, [args.start])
    print(f"reached={int((dist >= 0).sum())} rounds={rounds}")
    if args.dest:
        # 32-bit, as the JAX CLI writes its device array of distances
        dist.cpu().numpy().astype(np.int32).tofile(args.dest)
    return 0


def cmd_cc(args) -> int:
    from ..algo import compute_sizes, connected_components, sort_by_size
    g = _csr(args.source, args.dev)
    comp = connected_components(g)
    if args.sort_by_size:
        comp = sort_by_size(comp)
    sizes = compute_sizes(comp)
    print(f"components={len(sizes)} largest={int(sizes.max())}")
    if args.dest:
        comp.cpu().numpy().tofile(args.dest)
    return 0


def cmd_scc(args) -> int:
    from ..algo import scc_sizes, strongly_connected_components
    g = _csr(args.source, args.dev)
    k, comp = strongly_connected_components(g)
    sizes = scc_sizes(comp)
    print(f"components={k} largest={int(sizes.max())}")
    if args.dest:
        comp.cpu().numpy().tofile(args.dest)
    return 0


def _decode_times(g, dev, repeat: int) -> list:
    """Seconds of each of ``repeat`` decodes of BVGraph ``g`` to a CSR on
    ``dev``, after one untimed: ``decode_to_csr`` of a resolved plan (B1
    and B2), or, outside the kernel's envelope, the whole ``to_device``.
    Each ends in a synchronise."""
    from .. import native
    from ..core.graph import sync
    from ..ops.csr import decode_to_csr
    from ..ops.kplan import plan_kernel_decode
    from ..ops.resolve import resolve_halos
    data = np.asarray(g.data, dtype=np.uint8)
    offsets = g.offsets_array()
    outd = native.decode_outdegrees(data, offsets, g.settings.outdegree_coding)
    plan = plan_kernel_decode(offsets, outd, g.settings, data, device=dev)
    if plan is None:
        def run():
            return g.to_device(dev)
    else:
        resolve_halos(plan)

        def run():
            return decode_to_csr(plan)
    run()
    sync(dev)
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        run()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def cmd_speedtest(args) -> int:
    """Decode-speed harness (test/SpeedTest.java:44-145: warmup + timed
    reps, sequential scan or random access, reports ns/link)."""
    g = _load(args.source, mode="mapped" if args.mapped else "standard")
    n, m = g.num_nodes, g.num_arcs
    rng = np.random.default_rng(0)
    if args.random is not None:
        nodes = rng.integers(0, n, args.random)
        for _ in range(args.warmup):
            for x in nodes[:100]:
                g.successors(int(x))
        times = []
        for _ in range(args.repeat):
            t0 = time.time()
            links = 0
            for x in nodes:
                links += len(g.successors(int(x)))
            times.append((time.time() - t0) / max(links, 1))
        best = min(times)
        print(f"{best * 1e9:.2f} ns/link")
    else:
        best = min(_decode_times(g, args.dev, args.repeat))
        print(f"{best / m * 1e9:.2f} ns/link  "
              f"({m / best / 1e6:.1f} M links/s)")
    return 0


def main(argv=None) -> int:
    dv = argparse.ArgumentParser(add_help=False)
    dv.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU; raises "
                         "without one)")
    p = argparse.ArgumentParser(
        prog="webgraph_tpu_torch",
        description="WebGraph on PyTorch / CUDA: command line")
    sub = p.add_subparsers(dest="command", required=True)

    def cmd(name, fn, **kw):
        sp = sub.add_parser(name, parents=[dv], **kw)
        sp.set_defaults(fn=fn)
        return sp

    b = cmd("bvgraph", cmd_bvgraph, help="compress to / manage BVGraph")
    b.add_argument("source")
    b.add_argument("dest", nargs="?")
    b.add_argument("-w", "--window-size", type=int, default=-1)
    b.add_argument("-m", "--max-ref-count", type=int, default=-1)
    b.add_argument("-i", "--min-interval-length", type=int, default=-1)
    b.add_argument("-k", "--zeta-k", type=int, default=-1)
    b.add_argument("-o", "--offline", action="store_true")
    b.add_argument("-O", "--offsets", action="store_true",
                   help="regenerate the offsets file")
    b.add_argument("-d", "--outdegrees", action="store_true",
                   help="dump the outdegree stream")
    b.add_argument("-L", "--obl", action="store_true",
                   help="write the .obl Elias-Fano offsets cache")

    e = cmd("efgraph", cmd_efgraph, help="compress to EFGraph")
    e.add_argument("source")
    e.add_argument("dest", nargs="?")
    e.add_argument("-q", "--log2-quantum", type=int, default=8)
    e.add_argument("-u", "--upper-bound", type=int, default=-1)
    e.add_argument("-o", "--offline", action="store_true")

    t = cmd("transform", cmd_transform, help="graph transformations")
    t.add_argument("operation", choices=[
        "identity", "transpose", "transposeOffline", "symmetrize",
        "symmetrizeOffline", "simplify", "simplifyOffline", "mapOffline",
        "union", "compose", "gray", "grayPerm", "lex", "lexPerm", "random",
        "arcfilter"])
    t.add_argument("source")
    t.add_argument("dest")
    t.add_argument("--other", help="second graph (union/compose)")
    t.add_argument("--map-file", help="binary big-endian longs (mapOffline)")
    t.add_argument("--filter", default="NO_LOOPS")
    t.add_argument("--seed", type=int, default=0)

    a = cmd("ascii", cmd_ascii, help="ASCII graph conversion")
    a.add_argument("source")
    a.add_argument("dest")
    a.add_argument("--to-ascii", action="store_true")

    sc = cmd("scattered", cmd_scattered, help="scattered arc-list ingestion")
    sc.add_argument("source", help="file or - for stdin")
    sc.add_argument("dest")
    sc.add_argument("--symmetrize", action="store_true")
    sc.add_argument("--no-loops", action="store_true")

    st = cmd("stats", cmd_stats, help="graph statistics")
    st.add_argument("source")
    st.add_argument("dest", nargs="?")
    st.add_argument("--scc", action="store_true")
    st.add_argument("-o", "--offline", action="store_true")

    h = cmd("hyperball", cmd_hyperball,
            help="approximate neighbourhood function")
    h.add_argument("source")
    h.add_argument("dest", nargs="?")
    h.add_argument("-l", "--log2m", type=int, default=6)
    h.add_argument("-s", "--seed", type=int, default=0)
    h.add_argument("-u", "--upper-bound", type=int, default=-1)
    h.add_argument("-t", "--threshold", type=float, default=-1)
    h.add_argument("--sum-of-distances", action="store_true")
    h.add_argument("--harmonic", action="store_true")

    bf = cmd("bfs", cmd_bfs, help="parallel breadth-first visit")
    bf.add_argument("source")
    bf.add_argument("dest", nargs="?")
    bf.add_argument("-s", "--start", type=int, default=0)

    c = cmd("cc", cmd_cc, help="connected components (symmetric graph)")
    c.add_argument("source")
    c.add_argument("dest", nargs="?")
    c.add_argument("--sort-by-size", action="store_true")

    s2 = cmd("scc", cmd_scc, help="strongly connected components")
    s2.add_argument("source")
    s2.add_argument("dest", nargs="?")

    sp = cmd("speedtest", cmd_speedtest, help="decode speed harness")
    sp.add_argument("source")
    sp.add_argument("-r", "--random", type=int, default=None,
                    help="random-access test over N nodes")
    sp.add_argument("-R", "--repeat", type=int, default=3)
    sp.add_argument("-W", "--warmup", type=int, default=1)
    sp.add_argument("--mapped", action="store_true")

    args = p.parse_args(argv)
    args.dev = _device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
