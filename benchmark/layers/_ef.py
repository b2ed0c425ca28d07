"""The least bytes an EF decode must move, and the device's time inside
the program's ``wg.ef.decode`` spans.

A whole decode of a resident EFGraph must read the stream once and write
the CSR once: 4 bytes a successor and 8 bytes a node's offset.  The word
ranks, the per-node layout and the chunking are the design's, not the
problem's, and are not counted.
"""

import bisect

from benchmark.layers._roofline import SUCC_BYTES

NAME = "wg.ef.decode"
OFFSET_BYTES = 8


def ef_decode_bytes(stream_bytes: int, arcs: int, nodes: int) -> int:
    return stream_bytes + SUCC_BYTES * arcs + OFFSET_BYTES * nodes


def decode_spans(ctx):
    """(start, end) microseconds of the window's ``wg.ef.decode`` spans, in
    order; None without a trace, device activities or such spans."""
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.calls:
        return None
    lo, hi = tr.window
    spans = sorted((max(s, lo), min(e, hi)) for n, s, e in tr.host_ops
                   if n == NAME)
    return [(s, e) for s, e in spans if e > s] or None


def busy_us(tr, spans) -> list:
    """Microseconds of each [s, e) of ``spans`` that the device is busy."""
    busy = tr.intervals                 # merged, in order
    ends = [b for _, b in busy]
    out = []
    for s, e in spans:
        i = bisect.bisect_right(ends, s)   # the first interval ending past s
        t = 0.0
        while i < len(busy) and busy[i][0] < e:
            t += min(busy[i][1], e) - max(busy[i][0], s)
            i += 1
        out.append(t)
    return out
