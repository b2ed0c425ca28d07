"""Plain reference of a decode: the graph itself.

A lossless decode gives back the generated CSR exactly, so the reference of
every decode and load is the generator's own (offsets, successors), and the
comparison counts what differs.  Plain torch; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def mismatches(ref_off: torch.Tensor, ref_succ: torch.Tensor, off,
               succ: torch.Tensor) -> dict:
    """Offsets and successors that differ from the reference (a length
    that differs counts every entry of the longer array)."""
    ro = ref_off.cpu().numpy()
    o = np.asarray(off.cpu().numpy() if isinstance(off, torch.Tensor)
                   else off, dtype=np.int64)
    off_bad = (int((o != ro).sum()) if o.shape == ro.shape
               else max(len(o), len(ro)))
    if succ.numel() != ref_succ.numel():
        succ_bad = max(succ.numel(), ref_succ.numel())
    else:
        succ_bad = int((succ.to(ref_succ.device, torch.int32)
                        != ref_succ).sum())
    return {"offsets_mismatch": off_bad, "succ_mismatch": succ_bad}


def control(ref_off: torch.Tensor, ref_succ: torch.Tensor) -> tuple:
    """The reference with the decode's one guarantee broken: successor ids
    kept to one bit less (the lowest bit dropped), a lossy decode."""
    return ref_off.cpu().numpy(), ref_succ & ~1


def check(ref_off: torch.Tensor, ref_succ: torch.Tensor, kept: list) -> tuple:
    """(the worst count of each kind over the kept (call, (offsets,
    successors)) answers, the set of calls whose answer differs at all)."""
    worst = {"offsets_mismatch": 0, "succ_mismatch": 0}
    wrong = set()
    for i, (off, succ) in kept:
        bad = mismatches(ref_off, ref_succ, off, succ)
        if any(bad.values()):
            wrong.add(i)
        for k, v in bad.items():
            worst[k] = max(worst[k], v)
    return worst, wrong
