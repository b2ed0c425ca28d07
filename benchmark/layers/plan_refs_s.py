"""Mean seconds a load spends in the host plan's reference stages: the
program's spans ``wg.plan.scan_refs`` (the native header scan),
``wg.plan.needed_preds`` (the predecessors each lane copies across its
boundary) and ``wg.plan.chain_depths`` (the cold plan's wavefront depths),
summed over the traced window, per load.  None where the program records
no such span."""

NAMES = ("wg.plan.scan_refs", "wg.plan.needed_preds", "wg.plan.chain_depths")


def span_s(ctx, names):
    """Seconds of the program's spans named in ``names`` inside the window,
    per operation of the window; None when the trace has none."""
    tr = ctx.trace
    if tr is None or not ctx.calls:
        return None
    lo, hi = tr.window
    rows = [(max(s, lo), min(e, hi)) for n, s, e in tr.host_ops
            if n in names]
    if not rows:
        return None
    return sum(e - s for s, e in rows if e > s) / 1e6 / ctx.calls


def read(ctx):
    return span_s(ctx, NAMES)
