"""Arcs of the plan's longest lane (its store segment less its halo lists):
the lane that sets B1's time when one list is long."""


def read(ctx):
    return ctx.counters.get("longest_lane_arcs")
