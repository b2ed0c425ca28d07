"""The result line has exactly the contract's keys, and the run fails
without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, load_bench, metrics_of
from benchmark.selftest._small import run_small

BENCH = load_bench()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(workload, trace):
    r = run_small(workload, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys, "the checks come last"
    json.loads(json.dumps(r))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in metrics_of(BENCH, kind, workload)}
    assert set(r["metrics"]) <= names
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert set(r["metrics"]) == names, "every end-to-end metric"


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "uk2002.decode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
