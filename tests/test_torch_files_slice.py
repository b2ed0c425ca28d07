"""The slice as a whole: from the files a user holds to a CSR on a device.

A graph is stored as a BVGraph basename and as an EFGraph basename by the
port and by the JAX package (the same bytes), read back through the port's
entries ``load_csr(basename, device="cpu")`` and ``EFGraph.to_device``, and
held against the JAX package's decodes of its own files; then the
analytics run on the decoded CSR and equal the JAX analytics on the
original graph.  Integers exact; the neighbourhood function at
``rtol = 1e-12``.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import algo as J
from webgraph_tpu.codecs.bvgraph import BVGraph as JBV
from webgraph_tpu.codecs.efgraph import EFGraph as JEF
from webgraph_tpu.core import graph as jcore
from webgraph_tpu.core.graph import CSRGraph as JCSR
from webgraph_tpu.ops.efdecode import ef_decode_to_csr as j_ef_decode
from webgraph_tpu_torch import algo as P
from webgraph_tpu_torch import native
from webgraph_tpu_torch.codecs.bvgraph import BVGraph
from webgraph_tpu_torch.codecs.efgraph import EFGraph
from webgraph_tpu_torch.core.graph import CSRGraph, load_csr

from .graphs import erdos_renyi
from .test_torch_algo_slice import synthetic
from .torch_file_cases import props_lines

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def inputs():
    co, su = synthetic(600)
    e = erdos_renyi(300, 0.02, seed=11)
    return {"synthetic": (co, su), "erdos_renyi": (e.offsets, e.succ)}


def _same_files(a, b):
    for ext in (".graph", ".offsets"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
    assert props_lines(a + ".properties") == props_lines(b + ".properties")


@pytest.mark.parametrize("which", ["synthetic", "erdos_renyi"])
def test_files_to_csr_then_analytics_match_jax(inputs, tmp_path, which):
    co, su = inputs[which]
    n = len(co) - 1
    j = JCSR(co, su)
    g = CSRGraph(co, su, device=CPU)
    base = {k: str(tmp_path / k) for k in ("bv", "jbv", "ef", "jef")}
    BVGraph.store(g, base["bv"])
    JBV.store(j, base["jbv"])
    EFGraph.store(g, base["ef"])
    JEF.store(j, base["jef"])
    _same_files(base["bv"], base["jbv"])
    _same_files(base["ef"], base["jef"])

    bv = load_csr(base["bv"], device="cpu")
    assert bv.report["route"] == "kernel" and bv.report["fallback_arcs"] == 0
    ef = load_csr(base["ef"], device="cpu")
    assert ef.report["route"] == "torch"
    jb = jcore.load(base["jbv"]).to_csr()
    hco, hsu = native.bv_decode_all(np.fromfile(base["bv"] + ".graph",
                                                np.uint8), n, len(su),
                                    BVGraph.load(base["bv"]).settings)
    jef = JEF.load(base["jef"])
    eco, esu = j_ef_decode(jef.words, jef.offsets, jef.upper_bound,
                           jef.log2_quantum)
    for got in (bv, ef):
        assert got.device == CPU and got.num_nodes == n
        for want_co, want_su in ((co, su), (jb.offsets, jb.succ),
                                 (hco, hsu), (eco, esu)):
            np.testing.assert_array_equal(got.offsets.numpy(), want_co)
            np.testing.assert_array_equal(got.succ.numpy(), want_su)

    jd, jr = J.bfs(j, [0])
    for got in (bv, ef):
        pd, pr = P.bfs(got, [0])
        assert pr == jr
        np.testing.assert_array_equal(pd.numpy(), jd)
    kw = dict(log2m=5, seed=1)
    jh = J.HyperBall(j, **kw)
    ph = P.HyperBall(bv, **kw)
    np.testing.assert_allclose(ph.run(), jh.run(), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ph.regs.numpy(), np.asarray(jh.regs))
