"""Mean milliseconds a ``decode_to_csr`` call leaves the device idle while
the program is inside it: the window's time outside every device activity,
within the program's ``wg.decode_to_csr`` spans (B1's launch, the flag
check's sync, B2's output and launch), per call.  None without device
activities or without such spans."""

import bisect

NAME = "wg.decode_to_csr"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.calls:
        return None
    lo, hi = tr.window
    spans = [(max(s, lo), min(e, hi)) for n, s, e in tr.host_ops
             if n == NAME]
    if not spans:
        return None
    busy = tr.intervals                 # merged, in order
    ends = [e for _, e in busy]
    idle = 0.0
    for s, e in spans:
        if e <= s:
            continue
        idle += e - s
        i = bisect.bisect_right(ends, s)   # the first interval ending past s
        while i < len(busy) and busy[i][0] < e:
            idle -= min(busy[i][1], e) - max(busy[i][0], s)
            i += 1
    return idle / 1e3 / ctx.calls
