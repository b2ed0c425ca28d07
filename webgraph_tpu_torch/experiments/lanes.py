"""The lane state machine of probes 6-15, kernel and plain twin.

Probes 6 to 15 of the JAX package time the decode kernel's per-lane state
machine and its pieces: a refill that loads the lane's next column word, a
pair of variable shifts, a copy-head read from the lane's output column and a
write into it.  Each body here is one entry of ``BODIES``; its index is the
variant id of ``csrc/probe_lane.cu``, where each body is a struct and one
kernel template runs them all.  The plain twin is ``run_plain``: one torch
step function (``_step``) with the same switches.

A body runs on one (8, 128) tile of 1,024 lanes: a column ``col`` of shape
``(R, 8, 128)`` (row r of lane t is ``col[r].flatten()[t]``).  Loops with a
``while`` condition stop when no lane of the tile meets it any more; until
then every lane steps.  A load from a row outside ``[0, R)`` gives 0 and a
write to a row outside ``[0, V)`` writes nothing, as the masked sums and
selects of the TPU did.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import _build
from .common import (LANES, M32, TILE, Case, i64, launch, on_cpu, out32, ptr,
                     s32, shl, shr)

# kinds of output: "col" is a zero-filled (V, 8, 128) column, "tile" (8, 128)


@dataclass(frozen=True)
class Body:
    name: str
    out: str            # "col" or "tile"
    diag: bool = False  # also a (2, 8, 128) diag output
    scratch: bool = False  # the column is staged in scratch first
    vote: bool = True   # a tile-wide any() condition each step


# index = variant id of wg_probe_lane (csrc/probe_lane.cu); keep in order
BODIES = (
    Body("p9_all", "col", diag=True),
    Body("p9_no_refill", "col", diag=True),
    Body("p9_no_shift", "col", diag=True),
    Body("p9_no_read", "col", diag=True),
    Body("p9_no_write", "col", diag=True),
    Body("p9_refill_shift", "col", diag=True),
    Body("p9_read_write", "col", diag=True),
    Body("p7_refwrite", "col"),
    Body("p7_maskedwrite", "col"),
    Body("p7_fori_maskedwrite", "col", vote=False),
    Body("p7_maskedsum_col", "col"),
    Body("p7_maskedread_out", "col"),
    Body("p7_uintshift", "col"),
    Body("p8_vec_mod_vec", "col"),
    Body("p8_scalar_bcast", "col"),
    Body("p8_two_outputs", "col", diag=True),
    Body("p8_mixed_carry", "col"),
    Body("p8_shift_by_32_minus", "col"),
    Body("p10_sum", "col"),
    Body("p10_barrier", "col"),
    Body("p10_barrier_k", "col"),
    Body("p10_fori", "col"),
    Body("p10_max", "col"),
    *(Body(f"p11_v{i}", "tile") for i in range(1, 8)),
    *(Body(f"p12_p{i}", "tile") for i in range(1, 5)),
    *(Body(f"p13_q{i}", "tile") for i in range(1, 6)),
    Body("p14_q8", "tile", scratch=True),
    Body("p14_q6", "tile"),
    Body("p14_q9", "tile", scratch=True),
    Body("p14_q10", "tile"),
    *(Body(f"p15_r{i}", "tile", scratch=True) for i in range(1, 5)),
)
VARIANT = {b.name: i for i, b in enumerate(BODIES)}
BODY = {b.name: b for b in BODIES}

# the p9 pieces switched on, per body: refill, shift, read, write
P9_FLAGS = {
    "p9_all": (1, 1, 1, 1), "p9_no_refill": (0, 1, 1, 1),
    "p9_no_shift": (1, 0, 1, 1), "p9_no_read": (1, 1, 0, 1),
    "p9_no_write": (1, 1, 1, 0), "p9_refill_shift": (1, 1, 0, 0),
    "p9_read_write": (0, 0, 1, 1)}
# the stream bodies of probes 12-14 as (form, staged in scratch); probe12's
# p4 is p3 with the shift amount cast from int32, probe14's q8/q10 are p2
STREAM_FORM = {
    "p12_p1": "p1", "p12_p2": "p2", "p12_p3": "p3", "p12_p4": "p3",
    "p13_q1": "q1", "p13_q2": "q2", "p13_q3": "q3", "p13_q4": "q4",
    "p13_q5": "q5", "p14_q8": "p2", "p14_q6": "q6", "p14_q9": "q6",
    "p14_q10": "p2"}
BILLION = 10 ** 9


def pair(site: str, body: str, V: int, steps: int):
    """The kernel wrapper and plain twin of ``body`` for a probe module:
    ``f(col, steps=steps)`` for the probe's ``V`` and launch site."""
    def kernel(col: torch.Tensor, steps: int = steps):
        return run(site, body, col, steps, V)

    def plain(col: torch.Tensor, steps: int = steps):
        return run_plain(body, col, steps, V)

    kernel.__name__, plain.__name__ = body, body + "_plain"
    return kernel, plain


def column(rng: np.random.Generator, device, R: int, high: int = 1 << 30
           ) -> torch.Tensor:
    """A random ``(R, 8, 128)`` column in ``[0, high)``, as the probes draw
    it."""
    return torch.from_numpy(rng.integers(0, high, (R, *TILE)).astype(
        np.int32)).to(device)


def cases(site: str, bodies, device, rng: np.random.Generator, R: int,
          steps: int, high: int = 1 << 30) -> list[Case]:
    """A probe module's cases: each ``(kernel, plain, name)`` of ``bodies``
    on a column of its own."""
    return [Case(site, name, fn, plain, (column(rng, device, R, high),),
                 steps=steps) for fn, plain, name in bodies]


def out_shapes(body: str, V: int):
    b = BODY[body]
    shapes = [(V, *TILE) if b.out == "col" else TILE]
    if b.diag:
        shapes.append((2, *TILE))
    return shapes


# ------------------------------------------------------------------- kernel
def run(site: str, body: str, col: torch.Tensor, steps: int, V: int):
    """Run ``body`` on the tile ``col`` (``(R, 8, 128)`` int32) for at most
    ``steps`` steps; returns its output, or ``(out, diag)`` for bodies with
    a diag.  ``site`` is the probe site counted in ``_build.LAUNCHES``."""
    _build.check_tensor(col, "col", (None, *TILE))
    b = BODY[body]
    R = col.shape[0]
    if R < 1 or V < 1 or steps < 0:
        raise ValueError(f"need R >= 1, V >= 1, steps >= 0: {R}, {V}, {steps}")
    if body == "p13_q2" and R & (R - 1):
        raise ValueError("p13_q2 masks its row index: R must be a power of 2")
    if on_cpu(col):
        return run_plain(body, col, steps, V)
    outs = [torch.empty(s, dtype=torch.int32, device=col.device)
            for s in out_shapes(body, V)]
    scr = torch.empty_like(col) if b.scratch else None
    diag = outs[1] if b.diag else None
    launch(site, "wg_probe_lane", VARIANT[body], ptr(col), ptr(outs[0]),
           ptr(diag), ptr(scr), R, V, steps, like=col)
    return tuple(outs) if b.diag else outs[0]


# -------------------------------------------------------------------- plain
class _Tile:
    """The lane columns of one tile as int64 carriers: ``src`` (R, 1024),
    ``out`` (V, 1024) where the body has an output column."""

    def __init__(self, src: torch.Tensor, out: torch.Tensor | None):
        self.src, self.out = src, out

    @staticmethod
    def _get(a, row):
        ok = (row >= 0) & (row < a.shape[0])
        v = a[row.clamp(0, a.shape[0] - 1), torch.arange(a.shape[1],
                                                           device=a.device)]
        return torch.where(ok, v, 0)

    def mload(self, rp):
        return self._get(self.src, rp)

    def mread(self, row):
        return self._get(self.out, row)

    @staticmethod
    def put(a, row, val):
        ok = (row >= 0) & (row < a.shape[0])
        lane = torch.arange(a.shape[1], device=a.device)
        a[row[ok], lane[ok]] = val[ok]

    def mwrite(self, row, val):
        self.put(self.out, row, val)


def _init(body: str, z: torch.Tensor) -> dict:
    """The body's carries at step 0 (int64 carriers of (1024,) lanes)."""
    fam = body.split("_")[0]
    if body in ("p7_uintshift",):
        return dict(b0=z + 3, b1=z + 5)
    if body == "p8_shift_by_32_minus":
        return dict(b0=z + 3, b1=z + 0x12345678)
    if body == "p8_mixed_carry":
        return dict(b0=z + 12345, avail=z + 96, acc=z)
    if body == "p8_vec_mod_vec":
        return dict(acc=z, w=z + 1)
    if fam in ("p9", "p10", "p12", "p13", "p14"):
        return dict(rp=z, wcur=z, b0=z, b1=z, avail=z + 96, acc=z)
    if fam == "p11":
        return dict(rp=z, b0=z, b1=z)
    return dict(rp=z, acc=z)


def _go(body: str, s: dict) -> torch.Tensor:
    """The lanes whose own loop condition holds (the tile steps while any
    does)."""
    fam = body.split("_")[0]
    if body in ("p7_uintshift", "p8_shift_by_32_minus"):
        return s["b0"] < (1 << 31)
    if fam in ("p7", "p8"):
        return s["acc"] < BILLION
    if fam == "p9":
        return s["acc"] >= 0
    if fam == "p10":
        return s["acc"] < (1 << 30)
    if fam == "p11":
        return s["b0"] < M32
    if fam in ("p12", "p13", "p14"):
        return s["avail"] > -(1 << 30)
    return s["acc"] > -(1 << 30)           # p15


def _refill(s, t: _Tile, R: int, idx_out: int, shift16: bool,
            need=None):
    """The conditional refill: lanes with avail <= 64 load their next column
    word (others load row ``idx_out``, which lies outside the column)."""
    if need is None:
        need = s["avail"] <= 64
    w = t.mload(torch.where(need, s["rp"], idx_out)) & M32
    if shift16:
        w = shr(w, 16)
    s["b1"] = torch.where(need, s["b1"] | w, s["b1"])
    s["avail"] = torch.where(need, s["avail"] + 32, s["avail"])
    return need


def _shift_pair(s):
    k = (s["b1"] & 7) + 1
    s["b0"] = shl(s["b0"], k) | shr(s["b1"], 32 - k)
    s["b1"] = shl(s["b1"], k)
    return k


def _step(body: str, s: dict, step: int, t: _Tile, R: int, V: int) -> None:
    """One step of ``body`` on the carries ``s`` (updated in place)."""
    fam = body.split("_")[0]
    if fam == "p9":
        rf, sh, rd, wr = P9_FLAGS[body]
        if rf:
            need = _refill(s, t, R, R + 1, shift16=True)
            s["rp"] = torch.where(need, s["rp"] + 1, s["rp"])
        if sh:
            s["avail"] = s["avail"] - _shift_pair(s)
        val = s["b0"] ^ (s["acc"] & M32)
        if rd:
            r = torch.remainder(s32(s["acc"] + step),
                                torch.clamp(s["wcur"], min=1))
            val = (t.mread(r) & M32 ^ val) & 0x7FFFFFFF
        if wr:
            t.mwrite(torch.remainder(s["wcur"], V), val)
        s["acc"] = s32(s["acc"] + (val & 7))
        s["rp"] = torch.remainder(s["rp"], R)
        s["wcur"] = s["wcur"] + 1
    elif fam == "p7":
        acc = s["acc"] if "acc" in s else None
        if body == "p7_refwrite":
            t.out[0] = acc
            s["acc"] = acc + 1
        elif body in ("p7_maskedwrite", "p7_fori_maskedwrite"):
            t.mwrite(torch.remainder(acc, V), acc)
            s["acc"] = acc + 1
        elif body == "p7_maskedsum_col":
            s["acc"] = acc + (t.mload(torch.remainder(acc, R)) & 7)
        elif body == "p7_maskedread_out":
            row = torch.remainder(acc, V)
            t.mwrite(row, s32(t.mread(row) + acc))
            s["acc"] = acc + 1
        elif body == "p7_uintshift":
            k = (s["b1"] & 7) + 1
            s["b0"] = shl(s["b0"], k) | shr(s["b1"], 32 - k)
            s["b1"] = shl(s["b1"], k) | s["b0"]
    elif fam == "p8":
        if body == "p8_vec_mod_vec":
            r = torch.remainder(s32(s["acc"] + step),
                                torch.clamp(s["w"], min=1))
            s["acc"] = s32(s["acc"] + r)
            s["w"] = s["w"] + 1
        elif body == "p8_scalar_bcast":
            s["acc"] = s32(s["acc"] + step)
        elif body == "p8_two_outputs":
            s["acc"] = s["acc"] + 1
        elif body == "p8_mixed_carry":
            k = (s["b0"] & 7) + 1
            s["b0"] = shl(s["b0"], k)
            s["avail"] = s["avail"] - k
            need = s["avail"] <= 64
            s["avail"] = torch.where(need, s["avail"] + 32, s["avail"])
            s["b0"] = torch.where(need, s["b0"] | 0x9E3779B9, s["b0"])
            s["acc"] = s32(s["acc"] + (s["b0"] & 7))
        elif body == "p8_shift_by_32_minus":
            _shift_pair(s)
    elif fam == "p10":
        need = s["avail"] <= 64
        idx = torch.where(need, s["rp"], R + 1)
        w = t.mload(idx)
        if body == "p10_max":
            w = torch.clamp(w, min=0)
        # p10_fori sums where(idx == i, col[i], 0) over the rows: the same
        # value; the barrier forms change no value
        w = w & M32
        s["b1"] = torch.where(need, s["b1"] | shr(w, 16), s["b1"])
        s["avail"] = torch.where(need, s["avail"] + 32, s["avail"])
        s["rp"] = torch.where(need, s["rp"] + 1, s["rp"])
        s["avail"] = s["avail"] - _shift_pair(s)
        s["acc"] = s32(s["acc"] + s["b0"])
        s["rp"] = torch.remainder(s["rp"], R)
    elif fam == "p11":
        w = t.mload(s["rp"]) & M32
        b0, b1 = s["b0"], s["b1"]
        v = body[-1]
        if v == "1":
            b0 = shl(b0, (w & 7) + 1) | w
        elif v == "7":
            b1 = (b1 + 1) & M32
            b0 = shl(b1, (w & 7) + 1) | b0
        else:
            b1 = b1 | w
            k = (b1 & 7) + 1
            if v == "2":
                b0 = shl(b0, k) | 1
            elif v == "3":
                b0 = (b0 + k * k) & M32
            elif v == "4":
                b0 = shl(b0, 3) | shr(b1, 16)
            elif v == "5":
                b0 = (b0 + shl(b1, k)) & M32
            elif v == "6":
                b0 = shl(b0, k) | 1
        s["b0"], s["b1"] = b0, b1
        s["rp"] = torch.remainder(s["rp"] + 1, R)
    elif fam in ("p12", "p13", "p14"):
        form = STREAM_FORM[body]
        if form == "p1":
            s["b1"] = s["b1"] | (t.mload(s["rp"]) & M32)
            _shift_pair(s)
            s["rp"] = torch.remainder(s["rp"] + 1, R)
            return
        need = s["avail"] <= 64
        if form == "q5":
            need = torch.full_like(need, step % 2 == 0) & (
                s["avail"] > -(1 << 30))
        if form == "q3":
            w = t.mload(torch.remainder(s["rp"], R))
        else:
            w = t.mload(torch.where(need, s["rp"], -1 if form == "q1"
                                    else R + 1))
        w = w & M32
        s["b1"] = torch.where(need, s["b1"] | w, s["b1"])
        s["avail"] = torch.where(need, s["avail"] + 32, s["avail"])
        nxt = (s["rp"] + 1) & (R - 1) if form == "q2" else s["rp"] + 1
        s["rp"] = torch.where(need, nxt, s["rp"])
        if form == "p3":
            k = _shift_pair(s)
        else:
            k = (s["b1"] & 7) + 1
            if form == "q4":
                s["b0"] = (s["b0"] + shl(s["b1"], 3) + k) & M32
            else:
                s["b0"] = (s["b0"] + shl(s["b1"], k)) & M32
        s["avail"] = (s["avail"] - 4 - step % 3 if form == "q6"
                      else s["avail"] - k)
        if form not in ("q2", "q3"):
            s["rp"] = torch.remainder(s["rp"], R)
    else:                                       # p15
        v = body[-1]
        rp, acc = s["rp"], s["acc"]
        if v == "2":
            w = t.mload(torch.where((acc & 1) == 0, rp, -1))
            rp = torch.remainder(rp + 1, R)
        else:
            w = t.mload(rp)
            if v == "4":
                t.put(t.src, torch.remainder(rp + 7, R), s32(w + 1))
            if v == "3":
                rp = torch.remainder(torch.where((w & 1) == 0, rp + 1, rp),
                                     R)
            else:
                rp = torch.remainder(rp + (w & 1) + 1, R)
        s["rp"], s["acc"] = rp, s32(acc + w)


def _finish(body: str, s: dict, t: _Tile, out_tile):
    """The body's outputs from its final carries."""
    fam = body.split("_")[0]
    if fam == "p9":
        return torch.stack([s["acc"], s["wcur"]])
    if body in ("p7_uintshift", "p8_shift_by_32_minus") or fam in (
            "p11", "p12", "p13", "p14"):
        res = s["b0"]
    elif body in ("p7_refwrite", "p7_maskedwrite", "p7_fori_maskedwrite",
                  "p7_maskedread_out"):
        return None
    else:
        res = s["acc"]
    if out_tile:
        return res
    t.out[0] = res
    if body == "p8_two_outputs":
        return torch.stack([res, res])
    return None


def run_plain(body: str, col: torch.Tensor, steps: int, V: int):
    """The plain PyTorch twin of ``run`` (same arguments and outputs)."""
    b = BODY[body]
    R = col.shape[0]
    dev = col.device
    src = i64(col).reshape(R, LANES)
    if b.scratch:
        src = src.clone()
    t = _Tile(src, torch.zeros((V, LANES), dtype=torch.int64, device=dev)
              if b.out == "col" else None)
    s = _init(body, torch.zeros(LANES, dtype=torch.int64, device=dev))
    step = 0
    while step < steps:
        if b.vote and not bool(_go(body, s).any()):
            break
        _step(body, s, step, t, R, V)
        step += 1
    res = _finish(body, s, t, b.out == "tile")
    if b.out == "tile":
        return out32(res).reshape(TILE)
    out = out32(t.out).reshape(V, *TILE)
    if b.diag:
        return out, out32(res).reshape(2, *TILE)
    return out
