"""BVGraph compression settings and code identifiers.

The port's own copy of the fields of the JAX package's ``BVGraphSettings``
and ``CompressionFlags`` (``webgraph_tpu/codecs/bvgraph.py``) that the plan,
the kernels and the host library read.  Every function of the port takes any
object with these fields, so the JAX package's settings work as well.
"""

from __future__ import annotations

from dataclasses import dataclass


class CompressionFlags:
    """Code identifiers (CompressionFlags.java:23-47)."""

    NONE = 0
    DELTA = 1
    GAMMA = 2
    GOLOMB = 3
    SKEWED_GOLOMB = 4
    UNARY = 5
    ZETA = 6
    NIBBLE = 7


_C = CompressionFlags


@dataclass
class BVGraphSettings:
    """Compression parameters and per-component codings; defaults follow
    BVGraph.java:455-473 and :527-542."""

    window_size: int = 7
    max_ref_count: int = 3
    min_interval_length: int = 4
    zeta_k: int = 3
    outdegree_coding: int = _C.GAMMA
    block_coding: int = _C.GAMMA
    residual_coding: int = _C.ZETA
    reference_coding: int = _C.UNARY
    block_count_coding: int = _C.GAMMA
    offset_coding: int = _C.GAMMA
