"""Mean milliseconds an EF decode leaves the device idle while the program
is inside it: the window's time outside every device activity, within the
program's ``wg.ef.decode`` spans (the chunk bounds' and each chunk's
readback, the launches), per call.  None without device activities or
without such spans."""

from benchmark.layers._ef import busy_us, decode_spans


def read(ctx):
    spans = decode_spans(ctx)
    if spans is None:
        return None
    idle = sum(e - s for s, e in spans) - sum(busy_us(ctx.trace, spans))
    return idle / 1e3 / ctx.calls
