"""The control of each cell's check comes out not correct: the reference
in the program's place, with the decode's guarantee broken (successor ids
cut by a bit) or HyperBall's sums in float32."""

import pytest

from benchmark.harness import load_bench
from benchmark.selftest._small import run_small


@pytest.mark.parametrize("workload",
                         [w["name"] for w in load_bench()["workloads"]])
def test_control_is_not_correct(workload):
    r = run_small(workload, control=True)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
