"""Mean seconds of the host plan per load: ``load_csr``'s ``plan_s`` (bit
offsets, outdegrees, the cold ``plan_kernel_decode``), a program span."""


def read(ctx):
    r = [x["plan_s"] for x in ctx.counters.get("reports", []) if "plan_s" in x]
    return sum(r) / len(r) if r else None
