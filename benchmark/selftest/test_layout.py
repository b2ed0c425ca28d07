"""Every cell finds its files by name, and a new cell, configuration,
traffic mix and per-layer metric are new files and entries alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import (HERE, ROOT, cell_files, load_bench,
                               load_module, metrics_of)

BENCH = load_bench()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(workload):
    f = cell_files(BENCH, workload)
    assert f["cell"]["name"] == workload == "{}.{}".format(
        f["cell"]["config"], f["cell"]["traffic"])
    assert f["config"]["name"] == f["cell"]["config"]
    assert callable(load_module("gen", f["config"]["generator"]).generate)
    assert hasattr(load_module("ops", f["traffic"]["op"]), "Op")
    assert f["traffic"]["limits"]
    e2e = metrics_of(BENCH, "end_to_end", workload)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = metrics_of(BENCH, "per_layer", workload)
    assert layers
    for m in layers:
        assert callable(load_module("layers", m["name"]).read)
        assert m["moves"] in [x["name"] for x in e2e]


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]


def _digest(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


DUMMY_READER = '''
def read(ctx):
    return 8.0 * ctx.counters["stream_bytes"] / ctx.env.m
'''

DUMMY_RUN = '''
import json, sys, time
from benchmark.harness import load_bench, run_cell, cell_files
bench = load_bench()
cfg = cell_files(bench, "tiny.decode-once")["config"]
r = run_cell(bench, "tiny.decode-once", 2**31 + 3, 0.01, {trace}, "cpu",
             time.perf_counter(), log=lambda *a: None)
print(json.dumps(r))
'''


def test_dummy_cell_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "benchmark")
    b = root / "benchmark"
    json.dump(dict(name="tiny", generator="webgraph",
                   params=dict(nodes=600, mean_outdegree=8, group=4,
                               global_frac=0.1),
                   bvgraph=dict(window_size=7, max_ref_count=3,
                                min_interval_length=4, zeta_k=3),
                   reduced=["nodes"]),
              open(b / "configs" / "tiny.json", "w"))
    json.dump(dict(op="decode", keep=1, keep_among=1,
                   limits=dict(offsets_mismatch=0, succ_mismatch=0)),
              open(b / "traffic" / "decode-once.json", "w"))
    (b / "layers" / "bits_per_link.py").write_text(DUMMY_READER)
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append(dict(name="tiny", source="a test", why="a test",
                                 file="benchmark/configs/tiny.json",
                                 reduced=["nodes"]))
    bench["workloads"].append(dict(name="tiny.decode-once", config="tiny",
                                   traffic="decode-once", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "decode_to_csr_Medges_per_s":
            m["workloads"].append("tiny.decode-once")
    bench["per_layer"].append(dict(
        name="bits_per_link", unit="bits", better="lower",
        source="program_counter", layer="codec",
        moves="decode_to_csr_Medges_per_s", workloads=["tiny.decode-once"]))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    after = _digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    env = dict(os.environ, PYTHONPATH=ROOT)
    for trace in (False, True):
        p = subprocess.run([sys.executable, "-c",
                            DUMMY_RUN.format(trace=trace)], cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] is True
        want = {"bits_per_link"} if trace else {"decode_to_csr_Medges_per_s",
                                                "setup_s"}
        assert set(r["metrics"]) == want
