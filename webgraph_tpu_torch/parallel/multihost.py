"""Multi-host scaling: per-host encode shards and per-host decode plans.

Counterpart of ``webgraph_tpu/parallel/multihost.py``.  The reference
scales by threads that each compress a node range into a stream of their
own, the streams then concatenated bit-exactly (BVGraph.java:2373-2483).
Here the same ranges go to hosts:

- **Encode**: the node range splits into arc-balanced shards (the
  splitNodeIterators analogue, ImmutableGraph.java:405-436, and the native
  encoder's own thread split); each host compresses its shard with global
  node ids and a window that starts empty at the shard boundary, and writes
  ``basename-h<k>.{graph,offsets,meta}``; an owner pass concatenates the
  shard streams bit-exactly, rebases the offsets and sums the statistics
  into the properties.  The merged files are those of an N-thread encode.
- **Decode**: each host plans its own node range against the shared stream
  (:func:`plan_shard_decode`: a cold plan whose lanes start at the shard's
  first node; the lists its first nodes reference across the boundary are
  decoded on the host at plan time), so hosts never communicate on the hot
  path.  ``ops.csr.decode_to_csr`` of the plan is the shard's CSR on its
  device, through the kernels B1 and B2.

The process group is ``torch.distributed``'s (:func:`initialize`): torchrun's
rendezvous variables or an explicit ``init_method``.  Its collectives are
host coordination only (a barrier before the owner's merge), so the
default backend is gloo; NCCL needs a card of its own for each rank.  One
process can also emulate any host count (:func:`store_multihost`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from ..device import require_cuda

__all__ = ["initialize", "shard_bounds", "encode_shard", "merge_shards",
           "store_multihost", "plan_shard_decode"]

_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(init_method: Optional[str] = None, world_size: int = 0,
               rank: int = -1, backend: str = "gloo") -> Tuple[int, int]:
    """Join the ``torch.distributed`` process group when one is configured:
    ``init_method`` given, or torchrun's rendezvous variables set
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns
    (rank, world size): the group's when it is already initialised, (0, 1)
    for a single process.  ``world_size``/``rank`` default to
    ``WORLD_SIZE``/``RANK``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None and all(os.environ.get(k) for k in _RENDEZVOUS):
        init_method = "env://"
    if init_method is None:
        return 0, 1
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def shard_bounds(csr_off, n_shards: int) -> np.ndarray:
    """Arc-balanced contiguous node shards (the splitNodeIterators
    contract, ImmutableGraph.java:405-436): int64[n_shards+1]."""
    csr_off = np.asarray(csr_off, dtype=np.int64)
    n = len(csr_off) - 1
    m = int(csr_off[-1])
    targets = (m * np.arange(1, n_shards, dtype=np.int64)) // n_shards
    bounds = np.empty(n_shards + 1, dtype=np.int64)
    bounds[0] = 0
    bounds[1:n_shards] = np.searchsorted(csr_off, targets, side="left")
    bounds[n_shards] = n
    return np.maximum.accumulate(bounds)


def _host(a) -> np.ndarray:
    """int64 numpy form of a host array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy().astype(np.int64)
    return np.asarray(a, dtype=np.int64)


def _on(a, device, dtype) -> torch.Tensor:
    """``a`` (a host array, read-only ones too, or a tensor) on
    ``device`` as ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, dtype)
    return torch.from_numpy(np.array(a)).to(device, dtype)


def _encode_device(sco: torch.Tensor, ssu: torch.Tensor, settings, lo: int,
                   threads: int):
    """The native encoder's output for one shard, from the device encoder:
    the shard's thread ranges (the native split, ``threads`` clamped to
    the node count) each encoded with a fresh window, their streams
    concatenated bit-exactly.  Returns (graph uint8, bits, offsets bytes,
    stats int64[138])."""
    from ..ops import vencode

    if not vencode.supported(settings):
        raise ValueError("the cuda backend does not support this coding "
                         "combination; use backend='native'")
    co_h = sco.cpu().numpy()
    n = len(co_h) - 1
    tb = shard_bounds(co_h, max(1, min(threads, n)))
    cat = vencode.BitCat()
    starts = []
    stats = np.zeros(_native.STAT_WORDS, dtype=np.int64)
    for a, b in zip(tb[:-1].tolist(), tb[1:].tolist()):
        gb, bits, st, sv = vencode.encode_csr_chunked(
            sco[a:b + 1] - int(co_h[a]), ssu[int(co_h[a]):int(co_h[b])],
            settings, node_base=lo + a)
        starts.append(st + cat.bits)
        cat.push(gb, bits)
        stats += sv
    offs_b, _ = vencode.offsets_stream(torch.cat(starts), cat.bits, settings)
    return (np.frombuffer(cat.to_bytes(), dtype=np.uint8), cat.bits, offs_b,
            stats)


def encode_shard(csr_off, succ, settings, basename: str, shard: int,
                 lo: int, hi: int, threads: int = 0,
                 backend: str = "native", device=None) -> dict:
    """Encode nodes [lo, hi) of the graph ``(csr_off, succ)`` (numpy arrays
    or tensors on any device) with global ids and a window that starts
    empty at ``lo``, in ``threads`` ranges (0: one per core) as the native
    encoder splits them; write ``basename-h<shard>.{graph,offsets,meta}``
    and return the meta.

    ``backend``: "native", the multithreaded C++ encoder on the host (the
    shard's arrays brought there); "cuda", the device encoder
    (``ops/vencode.py``) on ``device`` (the card when None, "cpu" runs the
    same torch ops there), its bytes equal to the native encoder's at the
    same ``threads``."""
    threads = threads or (os.cpu_count() or 1)
    a0, a1 = int(csr_off[lo]), int(csr_off[hi])
    sco, ssu = csr_off[lo:hi + 1], succ[a0:a1]
    if backend == "native":
        graph_b, gbits, offs_b, _obits, st = _native.bv_encode(
            _host(sco) - a0, _host(ssu), settings, threads=threads,
            node_base=lo)
        offs_b = offs_b.tobytes()
    elif backend == "cuda":
        dev = require_cuda() if device is None else torch.device(device)
        graph_b, gbits, offs_b, st = _encode_device(
            _on(sco, dev, torch.int64) - a0, _on(ssu, dev, torch.int32),
            settings, lo, threads)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    part = f"{basename}-h{shard}"
    graph_b.tofile(part + ".graph")
    with open(part + ".offsets", "wb") as f:
        f.write(offs_b)
    meta = dict(shard=shard, lo=lo, hi=hi, bits=int(gbits),
                stats=[int(v) for v in st])
    with open(part + ".meta", "w") as f:
        json.dump(meta, f)
    return meta


def merge_shards(basename: str, n_shards: int, settings,
                 comment: str = "BVGraph properties",
                 keep_parts: bool = False) -> dict:
    """The owner's pass, on the host: bit-exact concatenation of the shard
    streams, the offsets rebased onto the merged stream, the statistics
    summed into the properties (BVGraph.java:2432-2483).  Removes the
    parts unless ``keep_parts``."""
    from ..codecs.bvgraph import (GRAPH_EXTENSION, OFFSETS_EXTENSION,
                                  PROPERTIES_EXTENSION, _properties)
    from ..ops.vencode import BitCat, pack_gaps
    from ..utils import properties as javaprops

    cat = BitCat()
    metas = []
    starts_parts = []
    base_bits = 0
    for k in range(n_shards):
        part = f"{basename}-h{k}"
        with open(part + ".meta") as f:
            meta = json.load(f)
        metas.append(meta)
        data = np.fromfile(part + ".graph", dtype=np.uint8)
        cat.push(data.tobytes(), meta["bits"])
        # the shard's node offsets, rebased to the merged stream
        nk = meta["hi"] - meta["lo"]
        ob = np.fromfile(part + ".offsets", dtype=np.uint8)
        gaps_abs = _native.decode_offset_stream(ob, nk, settings.offset_coding)
        starts_parts.append(gaps_abs[:-1] + base_bits)
        base_bits += meta["bits"]
    with open(basename + GRAPH_EXTENSION, "wb") as f:
        f.write(cat.to_bytes())
    n = metas[-1]["hi"]
    starts = np.concatenate(starts_parts)
    gaps = (np.concatenate([[0], np.diff(starts), [base_bits - starts[-1]]])
            if n else np.zeros(1, dtype=np.int64))
    offs_b, _bits = pack_gaps(torch.from_numpy(gaps.astype(np.int64)),
                              settings.offset_coding, settings.zeta_k)
    with open(basename + OFFSETS_EXTENSION, "wb") as f:
        f.write(offs_b)
    props = _properties(settings, n, base_bits,
                        np.sum([mt["stats"] for mt in metas], axis=0))
    javaprops.dump(props, basename + PROPERTIES_EXTENSION, comment)
    if not keep_parts:
        for k in range(n_shards):
            for ext in (".graph", ".offsets", ".meta"):
                os.remove(f"{basename}-h{k}{ext}")
    return props


def store_multihost(graph, basename: str, n_hosts: int, settings=None,
                    comment: str = "BVGraph properties",
                    threads_per_host: int = 1, backend: str = "native",
                    device=None, report: Optional[dict] = None) -> dict:
    """One process driving the multi-host encode: shard, encode every
    shard (on a cluster each host runs its own :func:`encode_shard`),
    merge.  ``graph``: a ``CSRGraph`` on any device (with "cuda" its
    successors stay there) or any graph with ``iter_nodes``.  With
    ``threads_per_host=1`` the files are byte-identical to an
    ``n_hosts``-thread native encode of the whole graph; more threads add
    further window resets inside each shard, as further reference threads
    would.  ``report``: a dict to fill with the shard bounds, each shard's
    encode seconds and the merge's (host clock; each encode ends with its
    stream on the host)."""
    from ..core.graph import CSRGraph, host_csr
    from ..settings import BVGraphSettings

    s = settings or BVGraphSettings()
    if isinstance(graph, CSRGraph) and backend == "cuda":
        csr_off, succ = graph.offsets, graph.succ
        co_h = csr_off.cpu().numpy()
    else:
        csr_off, succ = host_csr(graph)
        co_h = csr_off
    bounds = shard_bounds(co_h, n_hosts)
    shard_s = []
    for k in range(n_hosts):
        t0 = time.perf_counter()
        encode_shard(csr_off, succ, s, basename, k, int(bounds[k]),
                     int(bounds[k + 1]), threads=threads_per_host,
                     backend=backend, device=device)
        shard_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    props = merge_shards(basename, n_hosts, s, comment)
    if report is not None:
        report.update(bounds=bounds.tolist(), shard_s=shard_s,
                      merge_s=time.perf_counter() - t0)
    return props


def plan_shard_decode(bv, data, process_id: int, num_processes: int,
                      device=None, **plan_kw):
    """Host ``process_id``'s decode plan: a cold ``LanePlan`` on ``device``
    (the card when None) over ``offsets[:hi+1]`` whose lanes cover nodes
    [lo, hi), the arc-balanced shard of :func:`shard_bounds` (the lists it
    references before ``lo`` are decoded on the host at plan time, so hosts
    never communicate during the decode).  ``plan_kw`` goes to
    ``kplan.plan_kernel_decode``.  Returns (plan, lo, hi); the plan is None
    outside the kernel's envelope.  ``ops.csr.decode_to_csr(plan)`` gives
    the shard's CSR."""
    from ..ops.kplan import plan_kernel_decode

    dev = require_cuda() if device is None else torch.device(device)
    data = np.asarray(data, dtype=np.uint8)
    offsets = bv.offsets_array()
    outd = _native.decode_outdegrees(data, offsets,
                                     bv.settings.outdegree_coding)
    cum = np.zeros(bv.num_nodes + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    bounds = shard_bounds(cum, num_processes)
    lo, hi = int(bounds[process_id]), int(bounds[process_id + 1])
    plan = plan_kernel_decode(offsets[:hi + 1], outd[:hi], bv.settings, data,
                              device=dev, first_node=lo, **plan_kw)
    return plan, lo, hi
