"""Billions of arcs a HyperBall run merges: the program's counter
``hyperball.arcs`` (each round's arcs, counted only while a profiler
records, so over the traced window alone), per completed run.  None where
the program has no such counter."""


def read(ctx):
    try:
        from webgraph_tpu_torch.utils.trace import counters
    except ImportError:     # a program without counters
        return None
    arcs = counters().get("hyperball.arcs")
    if not arcs or not ctx.calls:
        return None
    return arcs / ctx.calls / 1e9
