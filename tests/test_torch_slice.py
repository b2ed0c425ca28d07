"""The whole slice: cold decode -> device CSR -> one HyperBall round.

The JAX package's cold path (``plan_kernel_decode`` -> ``resolve_halos`` ->
``decode_to_csr`` -> ``device_round``, its kernels in interpret mode) and
the port's (plain twins on CPU tensors) run on the same synthetic web graph
encoded by the native encoder; both must equal the native sequential decode.
Every value is an integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import BVGraphSettings
from webgraph_tpu.utils.synth import synthesize_webgraph
from webgraph_tpu_torch.algo import hyperball as PHB
from webgraph_tpu_torch.ops import csr as PC
from webgraph_tpu_torch.ops import kplan as PP
from webgraph_tpu_torch.ops.resolve import resolve_halos

jnp = pytest.importorskip("jax.numpy")

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _synth(n):
    """``synthesize_webgraph(n)`` made a simple graph: below a few
    thousand nodes its clipped hub lists run past ``n`` and out of order,
    so keep each list's distinct successors below ``n``, ascending."""
    co, su = synthesize_webgraph(n, seed=1)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(co))
    key = np.unique((rows * n + su)[su < n])
    co = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=co[1:])
    return co, key % n


def _encoded(n, settings):
    co, su = _synth(n)
    graph, _gbits, offs, _ob, _st = native.bv_encode(co, su, settings,
                                                     threads=2)
    offsets = native.decode_offset_stream(offs, n, settings.offset_coding)
    hco, hsu = native.bv_decode_all(graph, n, int(co[-1]), settings)
    np.testing.assert_array_equal(hco, co)
    np.testing.assert_array_equal(hsu, su)
    outd = native.decode_outdegrees(graph, offsets, settings.outdegree_coding)
    return graph, offsets, outd, hco, hsu


def _port_cold(graph, offsets, outd, settings):
    plan = PP.plan_kernel_decode(offsets, outd, settings, graph, device=CPU)
    assert plan is not None and plan.cold
    passes = resolve_halos(plan)
    co, succ, filled = PC.decode_to_csr(plan)
    return plan, passes, co, succ, filled


def test_slice_matches_jax_and_native():
    from webgraph_tpu.algo import hyperball as HB
    from webgraph_tpu.ops import kdecode as K

    settings = BVGraphSettings()
    n = 3000
    graph, offsets, outd, hco, hsu = _encoded(n, settings)

    prep = K.plan_kernel_decode(offsets, outd, settings, graph)
    assert prep is not None and prep.cold
    K.resolve_halos(prep)
    jco, jsucc, fill = K.decode_to_csr(prep, data=graph, settings=settings)
    assert fill is None
    regs = HB.hyperloglog_init(n, 4, seed=5)
    jregs = np.asarray(HB.device_round(jco, jsucc, jnp.asarray(regs)))

    plan, passes, pco, psucc, filled = _port_cold(graph, offsets, outd,
                                                  settings)
    assert 1 <= passes <= settings.max_ref_count + 1
    assert filled == 0
    np.testing.assert_array_equal(pco, np.asarray(jco))
    np.testing.assert_array_equal(psucc.numpy(), np.asarray(jsucc))
    np.testing.assert_array_equal(pco, hco)
    np.testing.assert_array_equal(psucc.numpy(), hsu)

    pregs = PHB.device_round(pco, psucc, torch.from_numpy(regs))
    np.testing.assert_array_equal(pregs.numpy(), jregs)
    # a round changes something and never lowers a register
    assert (pregs.numpy() >= regs).all() and (pregs.numpy() != regs).any()


def test_slice_port_alone_50k():
    settings = BVGraphSettings()
    graph, offsets, outd, hco, hsu = _encoded(50_000, settings)
    plan, passes, co, succ, filled = _port_cold(graph, offsets, outd,
                                                settings)
    assert filled == 0 and passes >= 1
    np.testing.assert_array_equal(co, hco)
    np.testing.assert_array_equal(succ.numpy(), hsu)
