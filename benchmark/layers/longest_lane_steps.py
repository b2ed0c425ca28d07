"""Steps of B1's longest lane a ``decode_to_csr`` call: the program's
counter ``b1.lane_steps`` (each call's largest ``DIAG_STEPS`` over every
lane, preset lanes included, counted only while a profiler records, so
over the traced window alone), per call.  The lane that sets B1's time
where one lane outlasts the rest.  None where the program has no such
counter."""


def read(ctx):
    try:
        from webgraph_tpu_torch.utils.trace import counters
    except ImportError:     # a program without counters
        return None
    steps = counters().get("b1.lane_steps")
    if not steps or not ctx.calls:
        return None
    return steps / ctx.calls
