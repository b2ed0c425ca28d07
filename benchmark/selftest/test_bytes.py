"""The byte counts and roofline shares come out right from shapes."""

from types import SimpleNamespace

import pytest

from benchmark.layers import _roofline as R
from benchmark.harness import load_module

H100 = "NVIDIA H100 80GB HBM3"


def test_byte_counts_from_shapes():
    # a 1,000-arc graph whose stream is 300 bytes
    assert R.b1_bytes(300, 1000) == 300 + 4 * 1000
    assert R.b2_bytes(1000) == 8 * 1000
    assert R.peak_bytes_per_s(H100) == 3.35e12
    assert R.peak_bytes_per_s("cpu") is None


def test_share_of_the_roofline():
    # 3.35e9 bytes in 1 ms is the whole roofline; in 2 ms, half of it
    assert R.share_pct(3.35e9, 1e-3, H100) == pytest.approx(100.0)
    assert R.share_pct(3.35e9, 2e-3, H100) == pytest.approx(50.0)
    assert R.share_pct(1, 0.0, H100) is None
    assert R.share_pct(1, 1.0, "cpu") is None


class _Trace:
    def __init__(self, per_kernel):
        self.k = per_kernel

    def device_time_s(self, name):
        return sum(v for k, v in self.k.items() if name in k)


def _ctx(trace, calls=10, m=1_000_000, stream=250_000):
    return SimpleNamespace(trace=trace, calls=calls, kind=H100,
                           counters={"stream_bytes": stream},
                           env=SimpleNamespace(m=m))


def test_kernel_readers():
    # B1: 10 calls, 20 ms of bv_decode_lanes in all: 2 ms a call
    tr = _Trace({"bv_decode_lanes_kernel": 0.02,
                 "compact_runs_kernel": 0.004})
    b1 = load_module("layers", "b1_roofline").read(_ctx(tr))
    assert b1 == pytest.approx(100 * (250_000 + 4e6) / 3.35e12 / 2e-3)
    b2 = load_module("layers", "b2_roofline").read(_ctx(tr))
    assert b2 == pytest.approx(100 * 8e6 / 3.35e12 / 4e-4)
    # a kernel that is not on the path: nothing to read, not 0
    assert load_module("layers", "b2_roofline").read(
        _ctx(_Trace({"bv_decode_lanes_kernel": 0.02}))) is None
    assert load_module("layers", "b1_roofline").read(_ctx(None)) is None
