"""B2's share of its byte roofline: each successor read and written once,
over B2's device time per ``decode_to_csr`` call."""

from benchmark.layers._roofline import b2_bytes, kernel_share


def read(ctx):
    return kernel_share(ctx, "compact_runs", b2_bytes(ctx.env.m))
