"""B1's share of its byte roofline: the stream read once and each successor
written once, over B1's device time per ``decode_to_csr`` call."""

from benchmark.layers._roofline import b1_bytes, kernel_share


def read(ctx):
    c = ctx.counters
    return kernel_share(ctx, "bv_decode_lanes",
                        b1_bytes(c["stream_bytes"], ctx.env.m))
