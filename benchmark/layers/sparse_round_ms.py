"""Median milliseconds of a systolic or local HyperBall round in the
window (the rounds that merge only the predecessors of changed nodes)."""

from benchmark.layers._rounds import median_ms


def read(ctx):
    return median_ms(ctx, ("systolic", "local"))
