"""Device idle share of the traced window of the load cells."""

from benchmark.layers._idle import read  # noqa: F401
