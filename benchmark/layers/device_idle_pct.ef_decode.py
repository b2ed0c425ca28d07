"""Device idle share of the traced window of the EF decode cells."""

from benchmark.layers._idle import read  # noqa: F401
