"""Peaks of the card and the least bytes each decode kernel must move.

Published peak of one NVIDIA H100 SXM (80 GB HBM3): 3.35 TB/s of memory
bandwidth, at its full power limit of 700 W (the result line's ``device``
gives the card's own limit beside every share).  A card not in the table has
no roofline: the readers then return nothing.

The byte counts are what these inputs need, not what the plan allocates:
B1 (``csrc/bv_decode.cu``) must read the ``.graph`` stream once and write
each decoded successor once, 4 bytes; B2 (``csrc/compact.cu``) must read
each successor from the lane store and write it into the CSR, 4 + 4 bytes.
Halo lists, lane tables and store padding are the design's, not the
problem's, and are not counted.
"""

PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
SUCC_BYTES = 4


def peak_bytes_per_s(kind: str):
    return PEAK_BYTES_PER_S.get(kind)


def b1_bytes(stream_bytes: int, arcs: int) -> int:
    return stream_bytes + SUCC_BYTES * arcs


def b2_bytes(arcs: int) -> int:
    return 2 * SUCC_BYTES * arcs


def share_pct(nbytes: int, seconds: float, kind: str):
    """Percent of the card's byte roofline that ``nbytes`` moved in
    ``seconds`` reach; None without a peak or a time."""
    peak = peak_bytes_per_s(kind)
    if peak is None or not seconds > 0:
        return None
    return 100.0 * nbytes / peak / seconds


def kernel_share(ctx, kernel: str, nbytes: int):
    """Roofline share of ``kernel`` (a substring of its device name) per
    call of the window, or None when the trace shows no such kernel."""
    if ctx.trace is None or not ctx.calls:
        return None
    t = ctx.trace.device_time_s(kernel)
    if t <= 0:
        return None
    return share_pct(nbytes, t / ctx.calls, ctx.kind)
