"""Traffic op ``decode``: a resident compressed graph decoded to a CSR.

Set-up encodes the generated graph into the single stream the reference's
sequential compressor writes, with the port's device encoder, then makes the
decode plan cold from the stream and its offsets alone, as ``load_csr``
does: outdegrees, ``plan_kernel_decode``, ``resolve_halos``, the CSR index
and one warm ``decode_to_csr``.  Each operation of the window is one
``decode_to_csr(plan)`` ending in a synchronise; its output is dropped
unless the check keeps it.

The cell's work is B1 and B2 on the card.  ``decode_to_csr`` decodes a lane
the kernel flags on the host instead and returns how many arcs it filled so;
every call's count is kept, and a call that filled any is not correct, even
though its answer is exact (``fallback_arcs``, limit 0).
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch import native
from webgraph_tpu_torch.ops import kplan, vencode
from webgraph_tpu_torch.ops.csr import decode_to_csr, plan_csr_index
from webgraph_tpu_torch.ops.resolve import resolve_halos
from webgraph_tpu_torch.settings import BVGraphSettings

from ..reference import csr as ref_csr
from ..harness import sync, timed
from ..trace import span


class Op:
    def __init__(self, env):
        self.env = env
        self.plan = None
        self.counters = {"fallback_arcs": []}

    def setup(self) -> None:
        env = self.env
        if env.control:
            return
        settings = BVGraphSettings(**env.config["bvgraph"])
        with timed(env, "encode"):
            stream, bits, starts, _ = vencode.encode_csr_chunked(
                env.offsets, env.succ, settings)
            offsets = np.empty(env.n + 1, dtype=np.int64)
            offsets[:-1] = starts.cpu().numpy()
            offsets[-1] = bits
            data = np.frombuffer(stream, dtype=np.uint8)
            del starts, stream
        env.park()       # the reference waits on the host
        self.counters["stream_bytes"] = data.nbytes
        with timed(env, "plan"):
            outd = native.decode_outdegrees(data, offsets,
                                            settings.outdegree_coding)
            plan = kplan.plan_kernel_decode(offsets, outd, settings, data,
                                            device=env.device)
            if plan is None or not plan.cold:
                raise RuntimeError("the settings are outside the kernel's "
                                   "envelope: no cold device plan")
        with timed(env, "resolve"):
            resolve_halos(plan)
        with timed(env, "warm"):
            plan_csr_index(plan)
            _, succ, _ = decode_to_csr(plan)
            del succ
        lane_arcs = plan.store_off[1:] - plan.store_off[:-1] - plan.halo_arcs
        self.counters["longest_lane_arcs"] = int(lane_arcs.max())
        self.plan = plan

    def step(self):
        env = self.env
        if env.control:
            out = ref_csr.control(env.ref_offsets(), env.ref_succ())
        else:
            with span("decode_to_csr"):
                off, succ, filled = decode_to_csr(self.plan)
            self.counters["fallback_arcs"].append(filled)
            out = (off, succ)
        sync(env.device)
        return out

    def end_to_end(self, window_s: float, done: int) -> dict:
        return {"decode_to_csr_Medges_per_s": self.env.m * done / window_s
                / 1e6}

    def release(self) -> None:
        self.plan = None

    def check(self, kept: list) -> tuple:
        env = self.env
        worst, wrong = ref_csr.check(env.ref_offsets(), env.ref_succ(), kept)
        host = self.counters["fallback_arcs"]
        worst["fallback_arcs"] = max(host, default=0)
        wrong |= {i for i, a in enumerate(host) if a}
        return worst, len(wrong)
