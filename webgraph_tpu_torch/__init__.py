"""webgraph_tpu_torch: the PyTorch / CUDA port of webgraph_tpu.

The cold BVGraph decode -> device CSR -> HyperBall path, with the decode and
compaction kernels written by hand in CUDA C++ for Hopper (``csrc/``).  The
host layer (native decoder and encoder, codecs, graph containers, synthetic
generator) is shared with ``webgraph_tpu`` and imported from there; nothing
here imports jax.

Every function that touches a device takes it explicitly.  On CPU tensors the
kernel wrappers run their plain PyTorch versions; on CUDA tensors they launch
the kernels or raise.
"""

from .device import require_cuda

__all__ = ["require_cuda"]
