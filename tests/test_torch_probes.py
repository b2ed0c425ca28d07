"""The probe ports against the JAX package's Pallas probes.

Every probe kernel of ``experiments/pallas_probe*.py`` runs in Pallas
interpret mode on the CPU (``pl.pallas_call`` with ``interpret=True``), and
its port in ``webgraph_tpu_torch.experiments`` runs on CPU tensors (the
wrappers' plain versions) on the same inputs.  Every value is an integer:
the tolerance is exact equality.

The probes are reached without editing them: their ``timeit`` is replaced by
a stub that returns the result, their module-level step counts are lowered
where that keeps the run short, their ``np`` is replaced by a recorder that
draws ``np.random.randint`` from a seeded generator and keeps what
``np.asarray`` returns, and ``pallas_probe16.py`` (which times the TPU at
import) has only its imports, constants and ``make`` executed.
"""

import ast
import functools
import importlib
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.pallas import primitives as pallas_primitives
from jax.experimental import pallas as pl

from webgraph_tpu_torch.experiments import (lanes, probe, probe2, probe3,
                                            probe4, probe5, probe6, probe7,
                                            probe8, probe9, probe10, probe11,
                                            probe12, probe13, probe14,
                                            probe15, probe16, probe17)
from webgraph_tpu_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXP = ROOT / "experiments"
CSRC = ROOT / "webgraph_tpu_torch" / "csrc"
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs")


class _RecRandom:
    def __init__(self, rng, log):
        self.rng, self.log = rng, log

    def randint(self, lo, hi=None, size=None):
        v = self.rng.integers(lo, hi, size)
        self.log.append(v)
        return v


class RecNp:
    """Stands in for a probe module's ``np``: forwards to numpy, draws
    ``random.randint`` from a seeded generator and records the draws
    (``inputs``) and what ``asarray`` returns (``outputs``)."""

    def __init__(self, seed):
        self.inputs, self.outputs = [], []
        self.random = _RecRandom(np.random.default_rng(seed), self.inputs)

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, a, *args, **kw):
        r = np.asarray(a, *args, **kw)
        self.outputs.append(r)
        return r


def _load_probe16():
    """``pallas_probe16.py``'s imports, constants and ``make``, without its
    timing loop."""
    path = EXP / "pallas_probe16.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign)
                and all(isinstance(t, ast.Name) and t.id.isupper()
                        for t in n.targets))]
    ns = {"__name__": "pallas_probe16"}
    exec(compile(ast.Module(keep, []), str(path), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def jp():
    """The JAX probe modules, with ``pallas_call`` in interpret mode; the
    jax config values they set at import are restored."""
    saved = {k: getattr(jax.config, k) for k in CONFIG}
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    sys.path.insert(0, str(EXP))
    try:
        mods = {n: importlib.import_module(f"pallas_probe{n}")
                for n in ["", *range(2, 16), 17]}
        mods[16] = _load_probe16()
        for k, v in saved.items():
            jax.config.update(k, v)
        yield mods
    finally:
        pl.pallas_call = orig
        sys.path.remove(str(EXP))
        for k, v in saved.items():
            jax.config.update(k, v)


def t32(a) -> torch.Tensor:
    """numpy integers -> int32 tensor of the same low 32 bits."""
    return torch.from_numpy(np.asarray(a).astype(np.int64).astype(np.int32))


def eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def _record(monkeypatch, mod, seed, stub=None):
    rec = RecNp(seed)
    monkeypatch.setattr(mod, "np", rec)
    if stub is not None:
        monkeypatch.setattr(mod, "timeit", stub)
    return rec


def _stub_pair(f, *a, **kw):
    return 0.0, f(*a)


def _stub_result(f, *a, **kw):
    return f(*a)


# ---------------------------------------------------------------- probe.py
PROBE_STEPS = 60


@pytest.mark.parametrize("name", ["trivial", "vpu_loop", "gather_sublane",
                                  "gather_ref", "gather_1d", "gather_32"])
def test_probe(jp, monkeypatch, name):
    m = jp[""]
    rec = _record(monkeypatch, m, 1, _stub_pair)
    monkeypatch.setattr(m, "STEPS", PROBE_STEPS)
    _, want = getattr(m, name)()
    if name == "trivial":
        got = probe.trivial(torch.arange(1024, dtype=torch.int32)
                            .reshape(8, 128))
    elif name == "vpu_loop":
        got = probe.vpu_loop(t32(rec.inputs[0]), steps=PROBE_STEPS)
    else:
        tbl, idx = map(t32, rec.inputs)
        got = getattr(probe, name)(tbl, idx, steps=PROBE_STEPS)
    eq(got, want)


# ------------------------------------------------------- probe2 / 3 / 4
@pytest.mark.parametrize("body,steps,shape", [
    ("add", 100, (8, 128)), ("add", 1000, (8, 128)),
    ("add", 10000, (8, 128)), ("add10", 1000, (8, 128)),
    ("mul", 1000, (8, 128)), ("shift", 1000, (8, 128)),
    ("gather_tile", 1000, (8, 128)), ("gather_tile", 1000, (16, 128)),
    ("add", 1000, (64, 128))])
def test_probe2(jp, monkeypatch, body, steps, shape):
    m = jp[2]
    rec = _record(monkeypatch, m, 2, _stub_pair)
    _, want = m.loop_kernel(steps, body, shape)()
    eq(probe2.loop_kernel(t32(rec.inputs[0]), steps, body), want)


@pytest.mark.parametrize("steps", [200, 2000, 100000])
def test_probe3(jp, monkeypatch, steps):
    m = jp[3]
    rec = _record(monkeypatch, m, 3, _stub_result)
    want = m.loop_kernel(steps)
    eq(probe3.loop_kernel(t32(rec.inputs[0]), steps), want)


@pytest.mark.parametrize("steps,ops,shape", [
    (100, 1, (8, 128)), (10000, 1, (8, 128)), (1000, 10, (8, 128)),
    (200, 50, (8, 128)), (1000, 1, (32, 128))])
def test_probe4(jp, monkeypatch, steps, ops, shape):
    m = jp[4]
    rec = _record(monkeypatch, m, 4, _stub_result)
    want = m.loop_kernel(steps, shape, ops)
    eq(probe4.loop_kernel(t32(rec.inputs[0]), steps, ops), want)


def test_probe4_torch_ops():
    """The probe's XLA parts, as torch ops: the two-key sort against
    numpy's lexsort, the gather against numpy's take."""
    rng = np.random.default_rng(5)
    k1 = rng.integers(0, 50, 2000)
    k2 = rng.integers(0, 50, 2000)
    v = rng.integers(0, 1 << 30, 2000)
    got = probe4.sort_2key(t32(k1), t32(k2), t32(v))
    eq(got, v[np.lexsort((k2, k1))])
    idx = rng.integers(0, 2000, 500)
    eq(probe4.gather(t32(v), torch.from_numpy(idx)), v[idx])
    a = torch.ones((16, 16))
    assert probe4.noop_roundtrip(a.to(torch.int32)) == 2
    x = probe3.matmul_chain(torch.eye(8) * 2, 3)
    assert torch.equal(x, torch.eye(8))
    assert probe3.many_dispatches(torch.zeros(4), 2).allclose(
        torch.full((4,), 2.00001))


# ---------------------------------------------------------------- probe16
@pytest.mark.parametrize("nc,sweep", [(4, 0), (40, 0), (64, 0), (4, 8)])
def test_probe16(jp, nc, sweep):
    ns = jp[16]
    ns["STEPS"] = 300
    x = np.random.default_rng(16).integers(-50, 50, (8, 128)).astype(
        np.int32)
    want = jax.jit(ns["make"](nc, sweep))(jnp.asarray(x))
    eq(probe16.make(t32(x), nc, sweep, steps=300), want)


# ---------------------------------------------------------------- probe5
@pytest.mark.parametrize("name", ["clz", "varshift", "while", "dyngather_u32",
                                  "scratch_dyn", "u32_cmp_mix",
                                  "dma_dynoffset"])
def test_probe5(jp, monkeypatch, name):
    m = jp[5]
    rec = _record(monkeypatch, m, 5)
    want, expect = getattr(m, f"t_{name}")()
    np.testing.assert_array_equal(np.asarray(want), expect)
    args = [t32(a) for a in rec.inputs]
    port = {"while": probe5.while_max}.get(name) or getattr(probe5, name)
    eq(port(*args), want)


def test_probe5_dma_steps():
    """The copy loop past the probe's 8 steps wraps its offsets the same."""
    h = np.random.default_rng(6).integers(0, 100, (9, 8, 128))
    want = sum(h[(i * 7) % 5] + h[(i * 7) % 5 + 3] for i in range(40))
    eq(probe5.dma_dynoffset(t32(h), steps=40), want)


# ---------------------------------------------------------------- probe6
@pytest.mark.parametrize("steps,V", [(100, 640), (70, 24)])
def test_probe6(jp, monkeypatch, steps, V):
    """At V = 24 the write wraps and copy-head reads reach rows past V."""
    m = jp[6]
    monkeypatch.setattr(m, "V", V)
    col = np.random.default_rng(60 + V).integers(0, 1 << 30, (64, 8, 128))
    out, diag = m.build(steps, interpret=True)(jnp.asarray(col, jnp.int32))
    got_out, got_diag = probe6.build(t32(col), steps, V=V)
    eq(got_out, out)
    eq(got_diag, diag)


# ------------------------------------------------------- probes 7 to 15
LANE_PROBES = {7: probe7, 8: probe8, 9: probe9, 10: probe10, 11: probe11,
               12: probe12, 13: probe13, 14: probe14, 15: probe15}
LANE_CASES = [(n, fn.__name__) for n, mod in LANE_PROBES.items()
              for fn, _, _ in mod.BODIES]


P7_KERNELS = {"p7_refwrite": "k_while_refwrite",
              "p7_maskedwrite": "k_while_maskedwrite",
              "p7_fori_maskedwrite": "k_fori_maskedwrite",
              "p7_maskedsum_col": "k_while_maskedsum_col",
              "p7_maskedread_out": "k_while_maskedread_out",
              "p7_uintshift": "k_uintshift_while"}
P8_KERNELS = {"p8_vec_mod_vec": "k_vec_mod_vec",
              "p8_scalar_bcast": "k_scalar_bcast",
              "p8_two_outputs": "k_two_outputs",
              "p8_mixed_carry": "k_mixed_carry_dtypes",
              "p8_shift_by_32_minus": "k_shift_by_32_minus"}
P11_BODIES = {f"p11_v{i}": fn for i, fn in enumerate(
    ["v1_shift_by_loaded", "v2_shift_by_carry_mixed", "v3_no_varshift",
     "v4_varshift_const_amount", "v5_varshift_int32",
     "v6_unrolled_select_shift", "v7_shift_of_unloaded_by_loaded"], 1)}
P12_BODIES = {"p12_p1": "p1_shiftpair", "p12_p2": "p2_condrefill",
              "p12_p3": "p3_both", "p12_p4": "p4_pair_int32amount"}
P13_BODIES = {"p13_q1": "q1_neg_redirect", "p13_q2": "q2_no_mod",
              "p13_q3": "q3_uncond_load", "p13_q4": "q4_const_shift",
              "p13_q5": "q5_cond_from_const"}
P14_ARGS = {"p14_q8": (True, True), "p14_q6": (False, False),
            "p14_q9": (True, False), "p14_q10": (False, True)}


def _port(n: int, body: str):
    return next(fn for fn, _, _ in LANE_PROBES[n].BODIES
                if fn.__name__ == body)


@pytest.mark.parametrize("n,body", LANE_CASES)
def test_lane_probe(jp, monkeypatch, n, body):
    m = jp[n]
    port = _port(n, body)
    if n in (9, 10):
        col = np.random.default_rng(n).integers(0, 1 << 30, (64, 8, 128))
        if n == 9:
            want = m.build(*map(bool, lanes.P9_FLAGS[body]))(
                jnp.asarray(col, jnp.int32))
        else:
            want = m.build(body[4:])(jnp.asarray(col, jnp.int32))
        got = port(t32(col))
        if n == 9:
            eq(got[0], want[0])
            eq(got[1], want[1])
        else:
            eq(got, want)
        return
    rec = _record(monkeypatch, m, 100 + n)
    if n == 7:
        m.run(body, getattr(m, P7_KERNELS[body]))
    elif n == 8:
        m.run(body, getattr(m, P8_KERNELS[body]),
              two_out=body == "p8_two_outputs")
    elif n == 11:
        m.run(body, getattr(m, P11_BODIES[body]))
    elif n == 12:
        m.run(body, getattr(m, P12_BODIES[body]))
    elif n == 13:
        m.run(body, getattr(m, P13_BODIES[body]))
    elif n == 14:
        m.run(body, *P14_ARGS[body])
    else:
        m.run(body, body[4:])
    assert len(rec.inputs) == 1 and len(rec.outputs) == 1, (
        "the probe failed; see its FAIL line")
    got = port(t32(rec.inputs[0]))
    eq(got[0] if isinstance(got, tuple) else got, rec.outputs[0])
    if body == "p8_two_outputs":
        _, diag = pl.pallas_call(
            m.k_two_outputs,
            out_shape=(jax.ShapeDtypeStruct((m.V, 8, 128), jnp.int32),
                       jax.ShapeDtypeStruct((2, 8, 128), jnp.int32)))(
            jnp.asarray(rec.inputs[0], jnp.int32))
        eq(got[1], diag)


def test_lane_machine_beyond_v():
    """probe7's masked write and read-back with V below the step count,
    so rows wrap; and probe13's q2 with a column of 16 rows."""
    col = np.random.default_rng(77).integers(0, 1 << 30, (16, 8, 128))
    a = lanes.run_plain("p7_maskedread_out", t32(col), 50, 7)
    acc = np.arange(50)
    want = np.zeros((7, 1024), np.int64)
    for s in acc:
        want[s % 7] += s
    eq(a, want.reshape(7, 8, 128))
    with pytest.raises(ValueError):
        lanes.run("probe13.run", "p13_q2", t32(col[:12]), 10, 1)


# ---------------------------------------------------------------- probe17
@pytest.mark.parametrize("variant", probe17.VARIANTS)
def test_probe17(jp, monkeypatch, variant):
    """The output reads ``out_buf[0, 0] + tm_buf[0, 0]``, so it depends on
    what scratch holds before it is written.  The TPU leaves it undefined,
    interpret mode fills it with INT_MIN, the port zero-fills it: here
    interpret mode's fill is made zero too."""
    m = jp[17]
    monkeypatch.setattr(m, "STEPS", 1100)
    monkeypatch.setattr(pallas_primitives, "uninitialized_value",
                        lambda shape, dtype: jnp.zeros(shape, dtype))
    x = np.random.default_rng(17).integers(0, 1 << 20, (8, 128)).astype(
        np.int32)
    want = jax.jit(m.make(variant))(jnp.asarray(x))
    eq(probe17.make(t32(x), variant, steps=1100), want)


# ------------------------------------------------- the port's own wiring
def test_every_site_has_a_launch_count():
    sites = sorted(
        f"experiments/{p.name}:{i + 1}"
        for p in EXP.glob("pallas_probe*.py")
        for i, line in enumerate(p.read_text().splitlines())
        if "pl.pallas_call(" in line)
    assert len(sites) == 23
    assert sorted(rep for _, rep in _build.PROBE_SITES.values()) == sites
    assert all((CSRC / src).exists() for src, _ in _build.PROBE_SITES.values())
    assert set(_build.PROBE_SITES) <= set(_build.LAUNCHES)


def test_variant_ids_match_the_cuda_sources():
    lane_src = (CSRC / "probe_lane.cu").read_text()
    ids = [int(i) for i in re.findall(r"^\s*LANE\((\d+),", lane_src, re.M)]
    assert ids == list(range(len(lanes.BODIES)))
    flush_src = (CSRC / "probe_flush.cu").read_text()
    enum = re.search(r"enum \{ (NONE[^}]*) \}", flush_src).group(1)
    assert [e.strip().lower() for e in enum.split(",")] == list(
        probe17.VARIANTS)
    loop_src = (CSRC / "probe_loop.cu").read_text()
    names = re.findall(r"^\s+([A-Z_0-9]+) = (\d+),", loop_src, re.M)
    from webgraph_tpu_torch.experiments import common
    for name, i in names:
        assert getattr(common, f"LOOP_{name}") == int(i), name
    prims_src = (CSRC / "probe_prims.cu").read_text()
    names = re.findall(r"^\s+([A-Z_0-9]+) = (\d+),", prims_src, re.M)
    for name, i in names:
        assert getattr(probe5, "V_DMA" if name == "DMA" else name) == int(i)


def test_wrappers_check_their_arguments():
    before = dict(_build.LAUNCHES)
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        probe5.clz(x.to(torch.int64))
    with pytest.raises(ValueError):
        probe17.make(x[:, :64], "none")
    with pytest.raises(ValueError):
        probe17.make(x, "bogus")
    with pytest.raises(ValueError):
        probe16.make(x, 5)
    with pytest.raises(ValueError):
        probe4.loop_kernel(x, 10, body_ops=3)
    with pytest.raises(ValueError):
        lanes.run("probe7.run", "p7_refwrite", x.t().contiguous()[:8], 5, 4)
    # on the CPU the plain versions run and nothing is launched
    probe5.clz(x)
    probe7.while_refwrite(torch.zeros((4, 8, 128), dtype=torch.int32),
                          steps=3)
    assert _build.LAUNCHES == before
