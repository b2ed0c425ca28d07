"""Nothing the harness runs imports JAX, the JAX package or the root and
port bench entries."""

import os
import subprocess
import sys

from benchmark.harness import HERE, ROOT

FORBIDDEN = ("jax", "jaxlib", "webgraph_tpu", "bench", "bench_synth",
             "webgraph_tpu_torch.bench", "webgraph_tpu_torch.bench_synth")

SCRIPT = '''
import glob, os, sys
import benchmark.run, benchmark.control
from benchmark.harness import HERE, load_bench, load_module
from benchmark.selftest._small import run_small
for kind in ("gen", "ops", "layers", "reference"):
    for p in sorted(glob.glob(os.path.join(HERE, kind, "*.py"))):
        name = os.path.basename(p)[:-3]
        if name != "__init__":
            load_module(kind, name)
for w in load_bench()["workloads"]:
    run_small(w["name"])
bad = sorted(m for m in sys.modules
             if m in {forbidden} or m.split(".")[0] in ("jax", "jaxlib",
                                                        "webgraph_tpu"))
print("BAD", bad)
'''


def test_harness_imports():
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "BAD []"


def test_sources_name_no_forbidden_module():
    for d, _, fs in os.walk(HERE):
        for f in fs:
            if not f.endswith(".py") or f == "test_imports.py":
                continue
            src = open(os.path.join(d, f)).read()
            for mod in ("jax", "webgraph_tpu ", "webgraph_tpu.",
                        "webgraph_tpu_torch.bench", "bench_synth"):
                assert f"import {mod}" not in src, (f, mod)
                assert f"from {mod}" not in src, (f, mod)
