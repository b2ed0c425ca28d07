"""Each generator gives a valid graph, fixed by its seed."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell_files, load_bench, load_module


def _valid(off, succ, n):
    off, succ = off.numpy(), succ.numpy().astype(np.int64)
    assert off[0] == 0 and off[-1] == len(succ) and len(off) == n + 1
    assert (np.diff(off) >= 0).all()
    assert len(succ) == 0 or (succ.min() >= 0 and succ.max() < n)
    row = np.repeat(np.arange(n), np.diff(off))
    same = row[1:] == row[:-1]
    assert (succ[1:][same] > succ[:-1][same]).all(), "ascending, distinct"
    return row, succ


@pytest.mark.parametrize("nodes", [3, 100, 2_000, 30_000])
def test_webgraph_valid_and_seeded(nodes):
    gen = load_module("gen", "webgraph")
    params = dict(nodes=nodes, mean_outdegree=13.45, group=4, global_frac=0.1)
    a = gen.generate(params, 2**31 + 5, "cpu")
    _valid(*a, nodes)
    b = gen.generate(params, 2**31 + 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if nodes >= 2_000:
        c = gen.generate(params, 6, "cpu")
        assert not (a[1].shape == c[1].shape and torch.equal(a[1], c[1]))
        # a web graph: mostly local successors, lists copied in groups
        row, succ = _valid(*a, nodes)
        assert np.median(np.abs(succ - row)) < nodes / 20


def test_webgraph_config_is_uk2002_scale():
    cfg = cell_files(load_bench(), "uk2002.decode")["config"]
    assert cfg["params"]["nodes"] == 18_520_486
    assert cfg["published"] == {"nodes": 18_520_486, "arcs": 298_113_762}
    assert cfg["bvgraph"] == dict(window_size=7, max_ref_count=3,
                                  min_interval_length=4, zeta_k=3)


def test_kronecker_parameters_are_graph500():
    cfg = cell_files(load_bench(), "graph500-s24.decode")["config"]
    p = cfg["params"]
    assert (p["A"], p["B"], p["C"], p["edgefactor"]) == (0.57, 0.19, 0.19, 16)
    assert p["scale"] == 24 and cfg["reduced"] == ["scale"]


@pytest.mark.parametrize("scale", [12, 14])
def test_kronecker_valid_seeded_heavy_tail(scale):
    gen = load_module("gen", "kronecker")
    params = dict(scale=scale, edgefactor=16, A=0.57, B=0.19, C=0.19)
    off, succ = gen.generate(params, 2**31 + 9, "cpu")
    n = 1 << scale
    row, s = _valid(off, succ, n)
    assert not (row == s).any(), "no self-loops"
    fwd = set(zip(row.tolist(), s.tolist()))
    assert all((b, a) in fwd for a, b in list(fwd)[:5000]), "undirected"
    deg = np.diff(off.numpy())
    # between 1 and 2 arcs per generated edge once duplicates go
    assert 16 * n < len(s) < 2 * 16 * n
    assert deg.max() > 30 * deg.mean(), "hubs: a heavy degree tail"
    again = gen.generate(params, 2**31 + 9, "cpu")
    assert torch.equal(again[1], succ) and torch.equal(again[0], off)
    other = gen.generate(params, 10, "cpu")
    assert not (other[1].shape == succ.shape and torch.equal(other[1], succ))
