"""Progress logging and per-phase timing.

The analogue of dsiutils' ProgressLogger, which the reference threads
through every long operation (BVGraph.java:1517/:2207-2297, HyperBall.java
:1056-1062): rate + ETA logging at a bounded frequency, plus a structured
per-phase timing recorder (the substitute for the reference's running
bits/link logs -- SURVEY §5 tracing).  The port's own copy of
``webgraph_tpu/utils/progress.py``, the same classes and behaviour.

Loggers default to the ``webgraph_tpu_torch`` logging namespace; nothing
prints unless the application configures logging (or
``WEBGRAPH_PROGRESS=1`` is set, which installs a stderr handler at
import)."""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["ProgressLogger", "PhaseTimer", "null_progress"]

LOGGER = logging.getLogger("webgraph_tpu_torch.progress")

if os.environ.get("WEBGRAPH_PROGRESS"):
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)


class ProgressLogger:
    """Rate/ETA progress logging (dsiutils ProgressLogger semantics:
    ``start`` / ``update`` / ``light_update`` / ``done``; logs at most once
    per ``log_interval`` seconds)."""

    def __init__(self, items_name: str = "items",
                 expected_updates: int = -1,
                 log_interval: float = 10.0,
                 logger: Optional[logging.Logger] = None):
        self.items_name = items_name
        self.expected_updates = expected_updates
        self.log_interval = log_interval
        self.logger = logger or LOGGER
        self.count = 0
        self._t0 = self._last = 0.0
        self._started = False

    def start(self, message: str = "") -> "ProgressLogger":
        self.count = 0
        self._t0 = self._last = time.time()
        self._started = True
        if message:
            self.logger.info(message)
        return self

    def update(self, n: int = 1) -> None:
        self.count += n
        now = time.time()
        if now - self._last >= self.log_interval:
            self._last = now
            self._log(now)

    # the reference's lightUpdate: cheap counter bump, same throttling
    light_update = update

    def _log(self, now: float) -> None:
        dt = max(now - self._t0, 1e-9)
        rate = self.count / dt
        msg = f"{self.count:,} {self.items_name}, {rate:,.0f}/s"
        if self.expected_updates > 0 and rate > 0:
            eta = (self.expected_updates - self.count) / rate
            msg += f", {100.0 * self.count / self.expected_updates:.1f}%" \
                   f", ETA {eta:,.0f}s"
        self.logger.info(msg)

    def done(self) -> None:
        if not self._started:
            return
        dt = max(time.time() - self._t0, 1e-9)
        self.logger.info(
            f"done: {self.count:,} {self.items_name} in {dt:,.2f}s "
            f"({self.count / dt:,.0f}/s)")
        self._started = False


def null_progress() -> ProgressLogger:
    """A ProgressLogger that never logs (for pl-optional call sites)."""
    pl = ProgressLogger(log_interval=float("inf"),
                        logger=logging.getLogger("webgraph_tpu_torch.null"))
    pl.logger.addHandler(logging.NullHandler())
    pl.logger.propagate = False
    return pl


class PhaseTimer:
    """Structured per-phase wall-time recorder.

    Usage::

        t = PhaseTimer()
        with t.phase("plan"):
            ...
        with t.phase("decode"):
            ...
        t.report()   # dict of phase -> seconds (insertion-ordered)

    The analogue of the reference's per-component bit/timing stats (SURVEY
    §5): where a long operation's wall time goes."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self._phases: List[Tuple[str, float]] = []
        self.logger = logger or LOGGER

    class _Phase:
        def __init__(self, timer: "PhaseTimer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self._t0 = time.time()
            return self

        def __exit__(self, *exc):
            self.timer._phases.append((self.name, time.time() - self._t0))
            return False

    def phase(self, name: str) -> "_Phase":
        return PhaseTimer._Phase(self, name)

    def add(self, name: str, seconds: float) -> None:
        self._phases.append((name, seconds))

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s in self._phases:
            out[name] = out.get(name, 0.0) + s
        return out

    def log(self, prefix: str = "") -> None:
        parts = [f"{k}={v:.3f}s" for k, v in self.report().items()]
        self.logger.info((prefix + " " if prefix else "") + " ".join(parts))
