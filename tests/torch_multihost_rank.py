"""One rank of the two-process multi-host test (``test_torch_multihost``).

A module of its own, importing neither jax nor the JAX package, so that a
spawned rank starts quickly: ``rank_main`` joins a gloo group through a
``file://`` rendezvous in ``tmp``, encodes its shard of ``tmp/{co,su}.npy``
into ``tmp/g-h<rank>.*`` on the CPU, waits at a barrier while rank 0
merges, waits again, then plans and decodes its shard of ``tmp/g`` and
saves the successors as ``tmp/succ<rank>.npy``."""

import os

import numpy as np
import torch


def rank_main(rank: int, tmp: str) -> None:
    import torch.distributed as dist

    from webgraph_tpu_torch.codecs.bvgraph import BVGraph
    from webgraph_tpu_torch.ops.csr import decode_to_csr
    from webgraph_tpu_torch.parallel import multihost as MH
    from webgraph_tpu_torch.settings import BVGraphSettings

    torch.set_num_threads(1)
    got = MH.initialize("file://" + os.path.join(tmp, "rendezvous"), 2, rank)
    assert got == (rank, 2), got
    try:
        s = BVGraphSettings()
        co = np.load(os.path.join(tmp, "co.npy"))
        su = np.load(os.path.join(tmp, "su.npy"), mmap_mode="r")
        bounds = MH.shard_bounds(co, 2)
        base = os.path.join(tmp, "g")
        MH.encode_shard(co, su, s, base, rank, int(bounds[rank]),
                        int(bounds[rank + 1]), threads=1, backend="cuda",
                        device="cpu")
        dist.barrier()
        if rank == 0:
            MH.merge_shards(base, 2, s)
        dist.barrier()
        bv = BVGraph.load(base)
        plan, lo, hi = MH.plan_shard_decode(bv, bv.data, rank, 2,
                                            device="cpu")
        assert (lo, hi) == (bounds[rank], bounds[rank + 1])
        _co, succ, _filled = decode_to_csr(plan)
        np.save(os.path.join(tmp, f"succ{rank}.npy"),
                succ.numpy().astype(np.int64))
    finally:
        dist.destroy_process_group()
