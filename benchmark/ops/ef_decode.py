"""Traffic op ``ef_decode``: a resident EFGraph stream decoded to a CSR.

Set-up stores the generated graph as an EFGraph with the port's device
writer (``EFGraph.store(backend="cuda")``, no other backend) into a
temporary directory under ``TMPDIR``, loads the basename back
(``EFGraph.load``: the stream's words and the per-node bit offsets) and
makes the decode plan from them as ``EFGraph.to_device`` does
(``EFDevicePlan``: the stream and offsets uploaded, the outdegrees read on
the card), then runs one warm decode.  Each operation of the window is one
``plan.decode()`` of the whole graph ending in a synchronise; its output is
dropped unless the check keeps it.  No BVGraph code and no host plan runs
in the window.

The check holds the kept CSRs whole against the generated graph, and the
stored stream against the plain reference of the format
(``reference/efgraph.py``): every node's entry length against the closed
form, and the entries of nodes drawn from the seed, plus the longest list,
bit for bit against the reference encoder and read back by its decoder.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile

import numpy as np
import torch

from webgraph_tpu_torch.codecs.efgraph import EFGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops.efdecode import EFDevicePlan

from ..harness import sync, timed
from ..reference import csr as ref_csr
from ..reference import efgraph as ref_ef
from ..trace import span


class Op:
    def __init__(self, env):
        self.env = env
        self.plan = self.ef = self.tmp = None
        self.counters = {}

    def _format(self):
        ef = self.env.config["efgraph"]
        ub = ef["upper_bound"]
        return (self.env.n if ub == "n" else int(ub)), int(ef["log2_quantum"])

    def setup(self) -> None:
        env = self.env
        if env.control:
            return
        u, q = self._format()
        self.tmp = tempfile.mkdtemp(prefix="wg_ef_")
        base = os.path.join(self.tmp, "g")
        with timed(env, "store"):
            EFGraph.store(CSRGraph(env.offsets, env.succ, device=env.device),
                          base, upper_bound=u, log2_quantum=q,
                          backend="cuda", device=env.device)
        env.park()       # the reference waits on the host
        with timed(env, "load"):
            self.ef = EFGraph.load(base)
        with timed(env, "plan"):
            ef = self.ef
            self.plan = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                                     ef.log2_quantum, device=env.device)
        with timed(env, "warm"):
            off, succ = self.plan.decode()
            del off, succ
        self.counters.update(
            stream_bytes=os.path.getsize(base + ".graph"),
            arcs=self.plan.m, nodes=self.plan.n)

    def step(self):
        env = self.env
        if env.control:
            out = ref_csr.control(env.ref_offsets(), env.ref_succ())
        else:
            with span("ef_decode"):
                out = self.plan.decode()
        sync(env.device)
        return out

    def end_to_end(self, window_s: float, done: int) -> dict:
        return {"decode_to_csr_Medges_per_s": self.env.m * done / window_s
                / 1e6}

    def release(self) -> None:
        self.plan = None
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def _stream_checks(self) -> dict:
        """Nodes whose stored entry length differs from the reference's
        closed form; sampled nodes whose stored entry is not the
        reference encoder's or does not decode back to the list."""
        env, ef = self.env, self.ef
        u, q = self._format()
        ref_off = env.ref_offsets()
        n = ref_off.numel() - 1
        stored = torch.from_numpy(np.diff(ef.offsets)).to(ref_off.device)
        want = ref_ef.entry_bits(ref_off[1:] - ref_off[:-1], u, q)
        gap = (int((stored != want).sum()) if stored.shape == want.shape
               else max(stored.numel(), want.numel()))
        d = ref_off[1:] - ref_off[:-1]
        picks = random.Random(env.seed ^ 0xEF).sample(
            range(n), min(int(env.traffic["sample_nodes"]), n))
        picks = sorted(set(picks) | ({int(torch.argmax(d))} if n else set()))
        ref_off_h = ref_off.cpu().numpy()
        succ = env.ref_succ().cpu().numpy()
        bad = 0
        for x in picks:
            lst = succ[ref_off_h[x]:ref_off_h[x + 1]].tolist()
            if x + 1 >= len(ef.offsets):
                bad += 1
                continue
            bits = ref_ef.stored_bits(ef.words, int(ef.offsets[x]),
                                      int(ef.offsets[x + 1]))
            try:
                back = ref_ef.decode_entry(bits, u, q)
            except (IndexError, ValueError):
                back = None
            bad += bits != ref_ef.encode_list(lst, u, q) or back != lst
        return {"stream_bits_gap": gap, "stream_mismatch": bad}

    def check(self, kept: list) -> tuple:
        env = self.env
        worst, wrong = ref_csr.check(env.ref_offsets(), env.ref_succ(), kept)
        if env.control:
            # nothing was stored: the control breaks the decode alone
            worst.update(stream_bits_gap=0, stream_mismatch=0)
        else:
            worst.update(self._stream_checks())
            self.ef = None
        return worst, len(wrong)
