"""Mean seconds a load spends building the host plan's tables: the
program's spans ``wg.plan.chunks`` (the arc and cost sums, the lane bounds)
and ``wg.plan.lanes`` (the halo layout, store offsets, the lane table, the
halo triples, the store's allocation, the lane order), summed over the
traced window, per load.  None where the program records no such span."""

from benchmark.layers.plan_refs_s import span_s

NAMES = ("wg.plan.chunks", "wg.plan.lanes")


def read(ctx):
    return span_s(ctx, NAMES)
