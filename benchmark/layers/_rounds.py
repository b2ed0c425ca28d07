"""Median milliseconds of the window's HyperBall rounds of some modes, each
timed by the harness on the host clock and ending in a synchronise."""

import statistics


def median_ms(ctx, modes):
    r = [s for mode, s in ctx.counters.get("rounds", []) if mode in modes]
    return 1e3 * statistics.median(r) if r else None
