"""Mean seconds of the file layer per load: ``load_csr``'s ``load_s``
(properties, stream and offsets read), a program span."""


def read(ctx):
    r = [x["load_s"] for x in ctx.counters.get("reports", []) if "load_s" in x]
    return sum(r) / len(r) if r else None
