"""State converters between the JAX package and the port."""

import numpy as np
import pytest
import torch

from webgraph_tpu.algo import hyperball as HB
from webgraph_tpu_torch import state

jnp = pytest.importorskip("jax.numpy")

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("log2m", [4, 6])
def test_registers_round_trip(log2m):
    rng = np.random.default_rng(log2m)
    regs = rng.integers(0, 64, size=(33, 1 << log2m)).astype(np.uint8)
    packed = np.asarray(HB.pack_registers(jnp.asarray(regs)))
    t = state.registers_from_jax(regs, CPU)
    assert t.dtype == torch.uint8 and t.shape == regs.shape
    np.testing.assert_array_equal(state.registers_to_jax(t), regs)
    # packed uint32 in pack_registers' little-endian byte order
    tp = state.registers_from_jax(packed, CPU)
    np.testing.assert_array_equal(tp.numpy(), regs)
    back = state.registers_to_jax(tp, packed=True)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, packed)
    np.testing.assert_array_equal(
        np.asarray(HB.unpack_registers(jnp.asarray(back))), regs)


def test_registers_reject_other_dtypes():
    with pytest.raises(ValueError):
        state.registers_from_jax(np.zeros((2, 16), np.int32), CPU)


def test_csr_from_numpy():
    co = np.asarray([0, 2, 2, 5])
    su = np.asarray([1, 2, 0, 1, 2])
    csr = state.csr_from_numpy(co, su, CPU)
    assert csr.offsets.dtype == torch.int64 and csr.succ.dtype == torch.int32
    assert csr.num_nodes == 3 and csr.device == CPU
    np.testing.assert_array_equal(csr.offsets.numpy(), co)
    np.testing.assert_array_equal(csr.succ.numpy(), su)
    with pytest.raises(ValueError):
        state.csr_from_numpy(np.asarray([0, 2, 4]), su, CPU)
