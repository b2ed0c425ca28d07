"""The EF decode's share of its byte roofline: the stream read once, each
successor and each node's offset written once, over the device's busy time
per call.  A call's device work runs from its ``wg.ef.decode`` span's start
until the next call's (its last chunk's kernels run on after the span
returns, while the harness synchronises; the device runs nothing else
there).  None where the program records no such span."""

from benchmark.layers._ef import busy_us, decode_spans, ef_decode_bytes
from benchmark.layers._roofline import share_pct


def read(ctx):
    spans = decode_spans(ctx)
    if spans is None or "stream_bytes" not in ctx.counters:
        return None
    tr = ctx.trace
    ends = [s for s, _ in spans[1:]] + [tr.window[1]]
    busy = sum(busy_us(tr, [(s, e) for (s, _), e in zip(spans, ends)]))
    c = ctx.counters
    return share_pct(ef_decode_bytes(c["stream_bytes"], c["arcs"],
                                     c["nodes"]),
                     busy / 1e6 / len(spans), ctx.kind)
