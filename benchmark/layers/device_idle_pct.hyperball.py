"""Device idle share of the traced window of the hyperball cells."""

from benchmark.layers._idle import read  # noqa: F401
