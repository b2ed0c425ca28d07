"""Traffic op ``decode_stream``: the op ``decode``, with the stored stream
also held to the plain reference of its format.

Set-up and window are ``decode``'s: the generated graph encoded with the
port's device encoder under the configuration's settings, a cold plan from
the stream and its offsets alone, ``resolve_halos``, one warm
``decode_to_csr``; each operation one ``decode_to_csr(plan)`` ending in a
synchronise, its output dropped unless the check keeps it.

The check holds the kept CSRs whole against the generated graph, as
``decode``'s does, and the stream the encoder wrote against the plain
reference of BVGraph's gap-coded setting (``reference/bvgraph_gd.py``):
every node's entry length (the difference of the encoder's node starts)
against the closed form, with the starts' first entry and the stream's
bit count; and the entries of nodes drawn from the seed, plus the longest
list, node 0 and the last node, bit for bit against the reference encoder
and read back by its decoder.  A round trip alone would pass an encoder
and a decoder that agreed on a wrong format.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..reference import bvgraph_gd as ref_gd
from . import decode


class Op(decode.Op):
    def __init__(self, env):
        super().__init__(env)
        self.stream = None

    def setup(self) -> None:
        super().setup()
        if self.plan is not None:
            # the encoder's bytes and node starts (plus its bit count)
            self.stream = (self.plan.data, self.plan.offsets)

    def _stream_checks(self) -> dict:
        """Nodes whose stored entry length differs from the reference's
        closed form (and 1 each for a first start that is not 0 and a bit
        count that is not the entries' sum); sampled nodes whose stored
        entry is not the reference encoder's or does not decode back to
        the list."""
        env = self.env
        data, offsets = self.stream
        ref_off, ref_succ = env.ref_offsets(), env.ref_succ()
        n = ref_off.numel() - 1
        want = ref_gd.entry_bits(ref_off, ref_succ)
        stored = torch.from_numpy(np.diff(offsets)).to(want.device)
        gap = (int((stored != want).sum()) + int(offsets[0] != 0)
               + int(int(offsets[-1]) != int(want.sum())))
        d = ref_off[1:] - ref_off[:-1]
        picks = random.Random(env.seed ^ 0x6D).sample(
            range(n), min(int(env.traffic["sample_nodes"]), n))
        picks = sorted(set(picks) | {0, n - 1, int(torch.argmax(d))})
        ref_off_h = ref_off.cpu().numpy()
        bad = 0
        for x in picks:
            lst = ref_succ[ref_off_h[x]:ref_off_h[x + 1]].tolist()
            try:
                bits = ref_gd.stored_bits(data, offsets[x], offsets[x + 1])
                back = ref_gd.decode_entry(bits, x)
            except (IndexError, ValueError):
                bits = back = None
            bad += bits != ref_gd.encode_list(x, lst) or back != lst
        return {"stream_bits_gap": gap, "stream_mismatch": bad}

    def check(self, kept: list) -> tuple:
        worst, wrong = super().check(kept)
        if self.env.control:
            # nothing was encoded: the control breaks the decode alone
            worst.update(stream_bits_gap=0, stream_mismatch=0)
        else:
            worst.update(self._stream_checks())
            self.stream = None
        return worst, wrong
