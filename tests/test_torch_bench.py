"""The port's benchmark entry (``webgraph_tpu_torch.bench``, ``bench_synth``)
against the JAX bench (``bench.py``, ``bench_synth.py``) on the same inputs.

The port runs on the CPU (``device="cpu"``: the kernels' plain versions),
the JAX bench's kernel in interpret mode.  ``synthesize_webgraph`` below a
few thousand nodes may list a successor twice or past n, so the graphs here
are made simple (``torch_edge_cases.simple``), the synthetic's generator
included.  Every decode is held bit for bit; the rates are the CPU's and
are not checked.
"""

import ast
import contextlib
import functools
import io
import json
import os
import pathlib

import numpy as np
import pytest

from webgraph_tpu_torch import bench as PB
from webgraph_tpu_torch import bench_synth as PS
from webgraph_tpu_torch import native
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.settings import BVGraphSettings
from webgraph_tpu_torch.utils.synth import synthesize_webgraph

from .torch_edge_cases import simple

ROOT = pathlib.Path(__file__).resolve().parents[1]
# cnr-2000's settings (bench.py:3-4)
CNR_SETTINGS = BVGraphSettings(window_size=7, max_ref_count=3,
                               min_interval_length=3, zeta_k=3)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
SYNTH_NODES = 600
JAX_CONFIG = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_bench():
    """The repository's ``bench.py``, its compilation-cache settings undone
    (they would apply to every later test of the process)."""
    import jax
    keep = {k: getattr(jax.config, k) for k in JAX_CONFIG}
    import bench
    for k, v in keep.items():
        jax.config.update(k, v)
    return bench


def _simple_synth(n, **kw):
    return simple(*synthesize_webgraph(n, **kw))


def _store(tmp, name, n, seed):
    co, su = _simple_synth(n, seed=seed)
    base = str(tmp / name)
    BVGraph.store(CSRGraph(co, su, device="cpu"), base,
                  settings=CNR_SETTINGS, num_threads=1)
    return base, co, su


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    return _store(tmp_path_factory.mktemp("bench"), "g", 1000, 7)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _store(tmp_path_factory.mktemp("small"), "s", 400, 3)


def _main(argv, synth_nodes, cache_dir, mp):
    """``bench.main(argv + ["--device", "cpu"])`` with BENCH_SYNTH_NODES set
    and the synthetic cached in ``cache_dir``: (exit code, stdout lines)."""
    mp.setenv("BENCH_SYNTH_NODES", str(synth_nodes))
    mp.setattr(PS, "synthesize_webgraph", _simple_synth)
    mp.setattr(PS, "bench_synth", functools.partial(
        PS.bench_synth, cache_dir=str(cache_dir)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = PB.main(argv + ["--device", "cpu"])
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def run(graph, tmp_path_factory):
    """One whole run of ``main``: the basename and a small synthetic."""
    tmp = tmp_path_factory.mktemp("run")
    extra = tmp / "extra.json"
    with pytest.MonkeyPatch.context() as mp:
        rc, lines = _main(["--basename", graph[0], "--extra-out",
                           str(extra)], SYNTH_NODES, tmp, mp)
    return dict(rc=rc, lines=lines, rows=json.loads(extra.read_text()),
                cache=tmp / f".bench_synth_{SYNTH_NODES}.npz")


def test_bench_graph_agrees_with_the_jax_bench(jax_bench, graph):
    from webgraph_tpu.codecs.bvgraph import BVGraph as JBVGraph
    base, co, su = graph
    jbv = JBVGraph.load(base)
    _, want = jax_bench.bench_graph(jbv, np.asarray(jbv.data), 128, 512, 160)
    bv = BVGraph.load(base)
    _, got = PB.bench_graph(bv, np.asarray(bv.data), 128, device="cpu")
    assert got["bit_exact"] is want["bit_exact"] is True
    assert got["fallback_arc_frac"] == want["fallback_arc_frac"] == 0
    assert got["fallback_arcs"] == got["bad_lanes"] == 0
    assert got["arcs"] == jbv.num_arcs == bv.num_arcs == len(su)
    assert got["nodes"] == jbv.num_nodes == len(co) - 1
    assert set(want) <= set(got), set(want) - set(got)
    assert set(got["spec"]) == {"lanes", "store_elems",
                                "target_arcs_per_lane"}
    assert got["resolve_passes"] >= 1 and got["depth"] == 5
    assert got["decode_ms"] is None and got["decode_Medges_per_s"] is None


def test_the_constants_are_the_jax_bench_s(jax_bench):
    assert PB.CNR == jax_bench.CNR
    assert PB.TARGET == jax_bench.TARGET == 2e9


def test_main_prints_the_jax_headline(run):
    assert run["rc"] == 0
    assert len(run["lines"]) == 1
    head = json.loads(run["lines"][-1])
    assert set(head) == HEADLINE_KEYS
    assert head["metric"] == "bvgraph_cold_decode_uk2002scale_edges_per_sec"
    assert head["unit"] == "Medges/s"
    assert head["value"] == run["rows"]["synthetic"][
        "decode_window_Medges_per_s"]
    assert head["vs_baseline"] == pytest.approx(head["value"] * 1e6 / 2e9,
                                                rel=1e-12)


def test_main_rows_are_bit_exact(run):
    rows = run["rows"]
    assert set(rows) == {"build", "g", "g_device_encode", "g_ef",
                         "synthetic"}
    for key in ("g", "synthetic"):
        assert rows[key]["bit_exact"] is True
        assert rows[key]["fallback_arc_frac"] == 0
    assert rows["g_device_encode"]["byte_identical"] is True
    assert rows["g_ef"]["bit_exact"] is True
    assert rows["synthetic"]["nodes"] == SYNTH_NODES
    for row in rows.values():
        assert row["card"] is None and row["cuda"] is None
        assert set(row["launches"]) == {"bv_decode_lanes", "compact_runs"}
        assert "error" not in row and "skipped" not in row


def test_bench_synth_cache_is_the_jax_one(run, monkeypatch):
    """The cache has the JAX keys and the JAX native encoder's stream of
    the same graph; a second call hits it and re-checks the re-encode."""
    from webgraph_tpu import native as jnative
    from webgraph_tpu.codecs.bvgraph import BVGraphSettings as JSettings
    from webgraph_tpu.utils.synth import synthesize_webgraph as jsynth
    with np.load(run["cache"]) as z:
        assert set(z.files) == {"data", "offsets", "n", "m", "gbits"}
        cache = {k: z[k] for k in z.files}
    co, su = simple(*jsynth(SYNTH_NODES))
    s = JSettings()
    g, gbits, offs, _ob, _st = jnative.bv_encode(
        co, su, s, threads=os.cpu_count() or 1)
    np.testing.assert_array_equal(cache["data"], g)
    np.testing.assert_array_equal(
        cache["offsets"],
        jnative.decode_offset_stream(offs, SYNTH_NODES, s.offset_coding))
    assert (int(cache["n"]), int(cache["m"]), int(cache["gbits"])) == (
        SYNTH_NODES, len(su), gbits)

    def no_generation(*a, **k):
        raise AssertionError("a cache hit generates nothing")

    monkeypatch.setattr(PS, "synthesize_webgraph", no_generation)
    again = PS.bench_synth(SYNTH_NODES, 128, device="cpu",
                           cache_dir=str(run["cache"].parent))
    assert again["cache_hit"] is True and again["gen_s"] == -1
    assert again["bit_exact"] is True and again["arcs"] == len(su)
    assert again["encode_bits_per_link"] == gbits / len(su)


def test_bench_synth_raises_on_a_cache_the_re_encode_misses(run, tmp_path):
    with np.load(run["cache"]) as z:
        cache = {k: z[k] for k in z.files}
    cache["gbits"] = cache["gbits"] + 1
    np.savez(tmp_path / f".bench_synth_{SYNTH_NODES}.npz", **cache)
    with pytest.raises(RuntimeError, match="re-encode diverged"):
        PS.bench_synth(SYNTH_NODES, 128, device="cpu",
                       cache_dir=str(tmp_path))


def test_an_oracle_one_arc_off_fails_the_run(small, tmp_path, monkeypatch):
    """An oracle that differs in one arc: ``bench_graph`` reports
    ``bit_exact`` false, no headline is printed and ``main`` exits 1."""
    real = native.bv_decode_all

    def one_arc_off(*a, **k):
        co, su = real(*a, **k)
        su = su.copy()
        su[len(su) // 2] += 1
        return co, su

    monkeypatch.setattr(PB.native, "bv_decode_all", one_arc_off)
    extra = tmp_path / "x.json"
    rc, lines = _main(["--basename", small[0], "--extra-out", str(extra)],
                      0, tmp_path, monkeypatch)
    rows = json.loads(extra.read_text())
    assert rows["s"]["bit_exact"] is False
    assert rc == 1 and lines == []


def test_an_absent_basename_is_skipped(tmp_path, monkeypatch):
    extra = tmp_path / "x.json"
    missing = str(tmp_path / "nowhere")
    rc, lines = _main(["--basename", missing, "--extra-out", str(extra)],
                      0, tmp_path, monkeypatch)
    rows = json.loads(extra.read_text())
    for key in ("nowhere", "nowhere_device_encode", "nowhere_ef"):
        assert rows[key] == {"skipped": f"{missing} not found"}
    assert "synthetic" not in rows
    assert rc != 0 and lines == []


def test_a_failing_row_keeps_the_headline(small, tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(PB, "bench_ef", boom)
    extra = tmp_path / "x.json"
    rc, lines = _main(["--basename", small[0], "--extra-out", str(extra)],
                      0, tmp_path, monkeypatch)
    rows = json.loads(extra.read_text())
    assert "boom" in rows["s_ef"]["error"]
    assert rows["s"]["bit_exact"] is True
    assert rows["s_device_encode"]["byte_identical"] is True
    head = json.loads(lines[-1])
    assert set(head) == HEADLINE_KEYS
    assert head["metric"] == "bvgraph_cold_decode_cnr2000_edges_per_sec"
    assert rc == 1


@pytest.mark.parametrize("mod", ["bench.py", "bench_synth.py"])
def test_the_bench_imports_neither_jax_nor_the_root_bench(mod):
    tree = ast.parse((ROOT / "webgraph_tpu_torch" / mod).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and not n.level]
    bad = [nm for nm in names if nm.split(".")[0] in (
        "jax", "webgraph_tpu", "bench", "bench_synth")]
    assert not bad, bad


def test_hub_graph_replaces_only_the_hubs_lists():
    import chip_smoke
    n, ids, degrees = 5000, (0, 1200, 4999), (300, 4000, 2500)
    co, su = chip_smoke.hub_graph(n, ids, degrees, seed=2)
    bco, bsu = synthesize_webgraph(n)
    assert len(co) == n + 1 and co[-1] == len(su)
    deg, bdeg = np.diff(co), np.diff(bco)
    others = np.setdiff1d(np.arange(n), ids)
    np.testing.assert_array_equal(deg[others], bdeg[others])
    for x in others[::97]:
        np.testing.assert_array_equal(su[co[x]:co[x + 1]],
                                      bsu[bco[x]:bco[x + 1]])
    for x, d in zip(ids, degrees):
        lst = su[co[x]:co[x + 1]]
        assert len(lst) == d and (np.diff(lst) > 0).all()
        assert 0 <= lst[0] and lst[-1] < n
    again = chip_smoke.hub_graph(n, ids, degrees, seed=2)
    np.testing.assert_array_equal(again[1], su)
