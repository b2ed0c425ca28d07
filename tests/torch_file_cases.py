"""Helpers shared by the file-layer tests of the port: the edge graphs
every entry must take, and ``.properties`` text without its date line."""

import numpy as np

from webgraph_tpu.core.graph import CSRGraph as JCSR


def edge_graphs():
    """n = 0, one node without and with a loop, isolated nodes."""
    e = np.zeros(0, np.int64)
    return {"n0": JCSR.from_lists([]),
            "one": JCSR.from_lists([e]),
            "one_loop": JCSR.from_lists([np.array([0])]),
            "isolated": JCSR.from_lists([e, np.array([3]), e, e,
                                         np.array([0, 1, 4]), e])}


def props_lines(path):
    """A .properties file's lines bar the date comment (the second line,
    which ``properties.dumps`` writes from the clock)."""
    with open(path, encoding="iso-8859-1") as f:
        lines = f.read().split("\n")
    assert lines[1].startswith("#")
    return [lines[0]] + lines[2:]
