"""Device idle share of the traced window of the stream-checked decode cells."""

from benchmark.layers._idle import read  # noqa: F401
