"""Small configurations for running cells on the CPU in the self-tests:
the cell's own configuration with its scale cut, everything else as is."""

import copy
import time

from benchmark.harness import cell_files, load_bench, run_cell

SMALL = {"webgraph": {"nodes": 1500}, "kronecker": {"scale": 9}}
SEED = 2**31 + 77   # past 32 signed bits, as the driver's seeds are


def small_config(bench, workload):
    cfg = copy.deepcopy(cell_files(bench, workload)["config"])
    cfg["params"].update(SMALL[cfg["generator"]])
    return cfg


def run_small(workload, trace=False, control=False, seed=SEED, bench=None,
              seconds=0.01):
    bench = bench or load_bench()
    return run_cell(bench, workload, seed, seconds, trace, "cpu",
                    time.perf_counter(), control=control,
                    config=small_config(bench, workload),
                    log=lambda *a: None)
