"""Shared pieces of the probe ports.

32-bit arithmetic on int64 carriers for the plain versions (CPU tensors have
no shifts on ``torch.uint32``, and int64 keeps wrap-around explicit), the
launch helper of the kernel wrappers, CUDA-event timing, and the runner that
holds each kernel against its plain version and prints the probe's lines.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import require_cuda
from ..ops import _build

M32 = 0xFFFFFFFF
LANES = 1024          # one (8, 128) tile; one thread block on the card
TILE = (8, 128)


# ---------------------------------------------------------------- 32-bit ops
def s32(v: torch.Tensor) -> torch.Tensor:
    """int64 carrier -> the int32 value it wraps to (still int64)."""
    return ((v + (1 << 31)) & M32) - (1 << 31)


def u32(v: torch.Tensor) -> torch.Tensor:
    """int64 carrier -> the uint32 value it wraps to (still int64)."""
    return v & M32


def i64(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> int64 carrier of its signed value."""
    return t.to(torch.int64)


def out32(v: torch.Tensor) -> torch.Tensor:
    """int64 carrier (signed or unsigned) -> int32 tensor of its low bits."""
    return s32(v).to(torch.int32)


def _amount(k) -> None:
    ok = ((k >= 0) & (k < 32)).all() if torch.is_tensor(k) else 0 <= k < 32
    if not bool(ok):
        raise AssertionError("shift amount outside 0..31")


def shl(v, k):
    """Left shift of a uint32 carrier, wrapped to 32 bits."""
    _amount(k)
    return (v << k) & M32


def shr(v, k):
    """Logical right shift of a uint32 carrier."""
    _amount(k)
    return v >> k


def sar(v, k):
    """Arithmetic right shift of an int32 carrier."""
    _amount(k)
    return s32(v) >> k


# ------------------------------------------------------------- the wrappers
def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on
    one CUDA device; raises otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch(site: str, entry: str, *args, like: torch.Tensor) -> None:
    """Call the C entry ``entry`` of the kernel library on ``like``'s
    stream, raise on a launch error, and count the launch under ``site``."""
    fn = getattr(_build.lib(), entry)
    _build.check(fn(*args, _build.stream_ptr(like)), site)
    _build.LAUNCHES[site] += 1


# variant ids of wg_probe_loop (csrc/probe_loop.cu)
(LOOP_TRIVIAL, LOOP_GATHER_TBL, LOOP_GATHER_1D, LOOP_VPU, LOOP_ADD,
 LOOP_XORADD, LOOP_MUL, LOOP_SHIFT, LOOP_GATHER_TILE, LOOP_CARRIES) = range(10)


def check_lanes(x: torch.Tensor, steps: int = 0,
                tbl: torch.Tensor | None = None) -> bool:
    """Check the arguments of a loop-family wrapper: ``x`` an ``(S, 128)``
    int32 tensor of lanes, ``tbl`` a gather table on its device whose row
    count is a power of two.  Returns whether they lie on the CPU."""
    _build.check_tensor(x, "x", (None, 128))
    if tbl is not None:
        _build.check_tensor(tbl, "tbl", device=x.device)
        if tbl.shape[0] & (tbl.shape[0] - 1):
            raise ValueError("the table's row count must be a power of 2")
    if x.numel() == 0 or steps < 0:
        raise ValueError("need lanes and steps >= 0")
    return on_cpu(x)


def loop(site: str, variant: int, x: torch.Tensor, steps: int,
         tbl: torch.Tensor | None = None, param: int = 0, sweep: int = 0
         ) -> torch.Tensor:
    """Launch one loop-family kernel on the lanes of ``x`` (checked by
    ``check_lanes``, on a CUDA device).  Returns the ``(S, 128)`` result."""
    if check_lanes(x, steps, tbl):
        raise ValueError("the kernels run on CUDA tensors only")
    out = torch.empty_like(x)
    launch(site, "wg_probe_loop", variant, param, sweep, ptr(x), ptr(tbl),
           ptr(out), x.numel(), steps,
           0 if tbl is None else tbl.shape[0] - 1, like=x)
    return out


# ------------------------------------------------------------------ timing
QUEUE_CYCLES = 4_000_000   # ~2 ms of device sleep


def device_ms(fn: Callable[[], object], reps: int = 5, warmup: int = 1
              ) -> float:
    """Device time of one ``fn()`` in ms: CUDA events around ``reps`` calls
    after ``warmup`` untimed ones.  The calls queue behind a device sleep,
    so that a launch takes its device time and not the host's time to
    enqueue it (tens of microseconds of Python and ctypes a wrapper call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


def max_abs_err(a, b) -> int:
    err = 0
    for x, y in zip(_tuple(a), _tuple(b), strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shapes differ: {x.shape} vs {y.shape}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return err


def checksum(r) -> int:
    return int(sum(int(x.to(torch.int64).sum()) for x in _tuple(r))) & M32


# ------------------------------------------------------------------ cases
@dataclass
class Case:
    """One probe kernel at one setting.

    ``kernel`` and ``plain`` take ``*args`` and the keyword ``steps`` (where
    the body loops); ``steps`` is the probe's count, ``check_steps`` the
    count at which kernel and plain are compared when the plain version at
    the full count would take too long (default: the full count)."""
    site: str
    name: str
    kernel: Callable
    plain: Callable
    args: tuple
    steps: int | None = None
    check_steps: int | None = None
    lanes: int = LANES
    tiles: int = 1
    reps: int = 5
    kw: dict = field(default_factory=dict)


@dataclass
class Row:
    site: str
    name: str
    ok: bool
    max_abs_err: int
    ms: float
    floor_ms: float | None
    plain_ms: float
    steps: int | None
    checked_steps: int | None
    ns_per_step: float | None
    lanes: int
    tiles: int
    checksum: int

    def line(self) -> str:
        head = "OK  " if self.ok else "WRONG"
        per = ("" if self.ns_per_step is None else
               f", {self.ns_per_step:.2f} ns/step over {self.floor_ms:.4f} "
               f"ms at 0 steps")
        chk = ("" if self.checked_steps == self.steps else
               f", checked at {self.checked_steps} steps")
        return (f"{head} {self.name}: {self.ms:.4f} ms{per} "
                f"(plain {self.plain_ms:.3f} ms{chk}; {self.lanes} lanes, "
                f"{self.tiles} tiles; checksum {self.checksum})")


def _call(fn, case: Case, steps):
    kw = dict(case.kw)
    if steps is not None:
        kw["steps"] = steps
    return fn(*case.args, **kw)


def run_case(case: Case) -> Row:
    """Launch the kernel at the probe's step count and time it, and at 0
    steps (ns/step is the difference over the steps); hold it against the
    plain version (at ``check_steps`` where that is set); time the plain
    version once at the checked count."""
    got = _call(case.kernel, case, case.steps)
    ms = device_ms(lambda: _call(case.kernel, case, case.steps),
                   reps=case.reps)
    floor_ms = ns = None
    if case.steps:
        floor_ms = device_ms(lambda: _call(case.kernel, case, 0),
                             reps=case.reps)
        ns = (ms - floor_ms) * 1e6 / case.steps
    chk = case.steps if case.check_steps is None else case.check_steps
    if chk != case.steps:
        got_chk = _call(case.kernel, case, chk)
    else:
        got_chk = got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = _call(case.plain, case, chk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got_chk, exp)
    return Row(case.site, case.name, err == 0, err, ms, floor_ms, plain_ms,
               case.steps, chk, ns, case.lanes, case.tiles, checksum(got))


def run_cases(cases: list[Case]) -> list[Row]:
    return [run_case(c) for c in cases]


def main(make_cases: Callable[[torch.device, np.random.Generator],
                              list[Case]], extras=None, seed: int = 0
         ) -> int:
    """The probe modules' ``__main__``: one line per case, FAIL with the
    error where a case raises; exit code 1 unless every case is OK."""
    dev = require_cuda()
    print("device:", torch.cuda.get_device_name(dev), flush=True)
    bad = 0
    for case in make_cases(dev, np.random.default_rng(seed)):
        try:
            row = run_case(case)
            print(row.line(), flush=True)
            bad += not row.ok
        except Exception as e:  # noqa: BLE001 -- reported, and exit code 1
            bad += 1
            msg = str(e).split("\n")[0][:200]
            print(f"FAIL {case.name}: {type(e).__name__}: {msg}", flush=True)
            traceback.print_exc(file=sys.stderr)
    if extras is not None:
        for line in extras(dev, np.random.default_rng(seed)):
            print(line, flush=True)
    return 1 if bad else 0
