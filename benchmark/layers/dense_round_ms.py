"""Median milliseconds of a dense HyperBall round in the window."""

from benchmark.layers._rounds import median_ms


def read(ctx):
    return median_ms(ctx, ("dense",))
