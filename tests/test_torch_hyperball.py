"""The port's HyperBall round against the JAX package's device_round.

Same CSR, same initial registers (``hyperloglog_init`` of both packages
must agree too); the JAX round runs on uint8 registers and on packed uint32
registers (its DenseRoundPlan path).  Registers are integers: exact.
"""

import numpy as np
import pytest
import torch

from webgraph_tpu.algo import hyperball as HB
from webgraph_tpu_torch import state
from webgraph_tpu_torch.algo import hyperball as PHB

from .graphs import erdos_renyi, star_graph

jnp = pytest.importorskip("jax.numpy")

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("log2m", [4, 5])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_matches(log2m, seed):
    np.testing.assert_array_equal(PHB.hyperloglog_init(500, log2m, seed),
                                  HB.hyperloglog_init(500, log2m, seed))


@pytest.mark.parametrize("gfn,log2m", [
    (lambda: erdos_renyi(300, 0.03, seed=1), 4),
    (lambda: erdos_renyi(200, 0.1, seed=2), 5),
    (lambda: star_graph(100), 4)])
def test_device_round_matches_jax(gfn, log2m):
    g = gfn().to_csr()
    n = len(g.offsets) - 1
    regs = HB.hyperloglog_init(n, log2m, seed=7)
    succ32 = g.succ.astype(np.int32)

    j_u8 = np.asarray(HB.device_round(g.offsets, jnp.asarray(succ32),
                                      jnp.asarray(regs)))
    j_packed = HB.device_round(g.offsets, jnp.asarray(succ32),
                               HB.pack_registers(jnp.asarray(regs)))
    j_packed = np.asarray(HB.unpack_registers(j_packed))

    csr = state.csr_from_numpy(g.offsets, g.succ, CPU)
    got = PHB.device_round(csr.offsets, csr.succ,
                           state.registers_from_jax(regs, CPU))
    got = state.registers_to_jax(got)
    np.testing.assert_array_equal(got, j_u8)
    np.testing.assert_array_equal(got, j_packed)
    # a second round from the first's output still agrees
    got2 = PHB.device_round(csr.offsets, csr.succ,
                            state.registers_from_jax(got, CPU))
    j2 = HB.device_round(g.offsets, jnp.asarray(succ32), jnp.asarray(j_u8))
    np.testing.assert_array_equal(state.registers_to_jax(got2),
                                  np.asarray(j2))


def test_round_in_slices_matches_one_slice(monkeypatch):
    g = erdos_renyi(150, 0.08, seed=4).to_csr()
    regs = torch.from_numpy(PHB.hyperloglog_init(150, 4, seed=1))
    succ = torch.from_numpy(g.succ.astype(np.int32))
    whole = PHB.device_round(g.offsets, succ, regs)
    monkeypatch.setattr(PHB, "ARC_SLICE", 37)
    np.testing.assert_array_equal(
        PHB.device_round(g.offsets, succ, regs).numpy(), whole.numpy())


def test_estimate_counts_matches():
    regs = HB.hyperloglog_init(64, 4, seed=2)
    regs[5, :] = 0
    np.testing.assert_allclose(PHB.estimate_counts(regs),
                               HB.estimate_counts(regs), rtol=0, atol=0)
