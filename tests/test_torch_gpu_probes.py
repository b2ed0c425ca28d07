"""The probe kernels on the card against their plain PyTorch versions.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (and no jax), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_probes.py

Every case of every probe module (``webgraph_tpu_torch/experiments``) runs
its kernel and its plain version on the same inputs; every value is an
integer, so every comparison is exact.
"""

import importlib

import numpy as np
import pytest
import torch

from webgraph_tpu_torch.experiments import common, lanes
from webgraph_tpu_torch.ops import _build

pytestmark = pytest.mark.gpu

MODULES = ["probe", "probe2", "probe3", "probe4", "probe5", "probe6",
           "probe7", "probe8", "probe9", "probe10", "probe11", "probe12",
           "probe13", "probe14", "probe15", "probe16", "probe17"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", MODULES)
def test_probe_kernels_match_plain(cuda, name):
    mod = importlib.import_module(f"webgraph_tpu_torch.experiments.{name}")
    for case in mod.cases(cuda, np.random.default_rng(1)):
        before = _build.LAUNCHES[case.site]
        row = common.run_case(case)
        assert _build.LAUNCHES[case.site] > before
        assert row.ok, (case.name, row.max_abs_err)


@pytest.mark.parametrize("body", [b.name for b in lanes.BODIES])
def test_lane_bodies_small_v(cuda, body):
    """Every lane body at a small V, where writes wrap and copy-head reads
    reach rows past V, and with steps past the probes' 200."""
    rng = np.random.default_rng(2)
    R = 16
    col = torch.from_numpy(rng.integers(0, 1 << 30, (R, 8, 128)).astype(
        np.int32)).to(cuda)
    got = lanes.run("probe9.build", body, col, 300, 24)
    exp = lanes.run_plain(body, col, 300, 24)
    assert common.max_abs_err(got, exp) == 0


def test_probe_wrappers_raise_on_a_cpu_cuda_mix(cuda):
    from webgraph_tpu_torch.experiments import probe, probe5
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        probe5.varshift(x, x.cpu())
    with pytest.raises(ValueError):
        probe.gather_sublane(torch.zeros((16, 128), dtype=torch.int32), x)
