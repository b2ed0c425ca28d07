"""webgraph_tpu_torch: the PyTorch / CUDA port of webgraph_tpu.

The cold BVGraph decode -> device CSR -> HyperBall path, with the decode and
compaction kernels written by hand in CUDA C++ for Hopper (``csrc/``).  The
port owns copies of the host pieces it needs of ``webgraph_tpu``: the native
library (``native/``), the settings (``settings``), the synthetic generator
(``utils/synth``) and the word packer (``ops/bitstream``).  Nothing here
imports jax or ``webgraph_tpu``.

Every function that touches a device takes it explicitly.  On CPU tensors the
kernel wrappers run their plain PyTorch versions; on CUDA tensors they launch
the kernels or raise.
"""

from .device import require_cuda

__all__ = ["require_cuda"]
