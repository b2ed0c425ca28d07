"""Spans and counters of the port, on the profiler's clock.

A span names one stage of a call (a load's host plan, the CSR assembly, a
HyperBall round) as a CPU range of ``torch.profiler``, beside the kernels
the stage launches, so a trace of any call shows which stage the host was
in while the device waited.  Every span name starts with ``wg.``; the spans
of one call nest under one root span (``wg.load_csr``, ``wg.to_device``,
``wg.decode_to_csr``, ``wg.hyperball.round.<mode>``), and the profiler's
parent links tie its stages together.

The ranges are ordinary CPU ranges, not user annotations: the profiler does
not mirror them onto the device's timeline, so they never count as device
time.  With no profiler running a span records nothing and costs about a
microsecond; it still reads the host clock, and ``span.seconds`` gives the
stage's seconds to callers that report them.

Counters add only while a profiler records, as spans record, so a count
covers exactly the profiled window.  Nothing is written to a file and no
thread is started: wrap any call in ``torch.profiler.profile(...)`` and
export its trace.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["span", "count", "counters", "recording", "reset_counters"]

PREFIX = "wg."

try:    # a private API: without it spans still time, but record nothing
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:     # pragma: no cover - every supported torch has it
    _Range = None

_recording = torch._C._autograd._profiler_enabled
_counts: Dict[str, int] = defaultdict(int)


class span:
    """``with span("plan.lanes") as s: ...`` records the CPU range
    ``wg.plan.lanes`` while a profiler runs; ``s.seconds`` is the block's
    time on the host clock once it has exited."""

    __slots__ = ("_range", "_t0", "seconds")

    def __init__(self, name: str):
        self._range = (_Range(PREFIX + name) if _Range is not None
                       and _recording() else None)
        self.seconds = None

    def __enter__(self) -> "span":
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a profiler records: a count would add now."""
    return _recording()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _counts[name] += int(n)


def counters() -> Dict[str, int]:
    """A copy of the counters: what the profiled windows counted."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()
