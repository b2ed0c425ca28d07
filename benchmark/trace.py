"""The traced window: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result's ``breakdown`` need.

The harness wraps the window in a ``bench.window`` span and every call it
makes into the program in a ``bench.<call>`` span (``record_function``).
From the profiler's events this keeps the device activities (kernels,
copies, sets), those spans and the host's operators, each as (name, start,
end) in microseconds on the profiler's clock.  Busy time is the union of
the device activities inside the window; an idle gap is a stretch of the
window with none, named by the harness span and the host operator that were
running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "bench.window"
TOP = 10


def span(name: str):
    """A harness span around one call into the program."""
    return torch.profiler.record_function("bench." + name)


class Trace:
    def __init__(self, device_events, spans, host_ops, window):
        self.device = sorted(device_events, key=lambda e: e[1])
        self.spans = sorted(spans, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.window = window                  # (start us, end us)
        self.intervals = self._busy_intervals()

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        dev, spans, ops, window = [], [], [], None
        for e in prof.events():
            row = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # the harness spans are mirrored on the device's timeline
                if not e.name.startswith("bench."):
                    dev.append(row)
            elif e.name == WINDOW:
                window = row[1:]
            elif e.name.startswith("bench."):
                spans.append(row)
            else:
                ops.append(row)
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return cls(dev, spans, ops, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _busy_intervals(self):
        lo, hi = self.window
        merged = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals) / 1e6

    def device_time_s(self, contains: str) -> float:
        """Seconds of the device activities whose name contains
        ``contains``, inside the window."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device
                   if contains in n and min(e, hi) > max(s, lo)) / 1e6

    def device_ops(self) -> list:
        """[name, seconds] of the device activities that took most time."""
        tot = defaultdict(float)
        lo, hi = self.window
        for n, s, e in self.device:
            if min(e, hi) > max(s, lo):
                tot[n[:96]] += (min(e, hi) - max(s, lo)) / 1e6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    @staticmethod
    def _at(rows, starts, t, back=256):
        """Name of the latest-starting row of ``rows`` that covers ``t``."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - back, -1), -1):
            if rows[j][2] >= t:
                return rows[j][0]
        return None

    def idle_gaps(self) -> list:
        """[what the host was doing, seconds] over the idle gaps of the
        window, summed by that name: the largest first."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.intervals:
            edges += [s, e]
        edges.append(hi)
        span_starts = [r[1] for r in self.spans]
        op_starts = [r[1] for r in self.host_ops]
        tot = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = "{} / {}".format(
                self._at(self.spans, span_starts, mid) or "harness",
                self._at(self.host_ops, op_starts, mid) or "host code")
            tot[name[:120]] += (b - a) / 1e6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def capture(fn, device: torch.device):
    """(``fn()``, its ``Trace``): ``fn`` runs inside the window span under
    the profiler, the device's activities recorded where it is a card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return out, Trace.from_profiler(prof)
