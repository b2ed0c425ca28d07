"""Ports of the JAX package's Pallas probes (``experiments/pallas_probe*.py``).

Each probe asked one question about a building block of the BVGraph decode
kernel: what a loop step costs, which per-lane gathers work, how clz,
variable shifts, tile-wide votes and async copies behave, what the
refill / shift / copy-read / write state machine costs, and how the decode's
output flush is best stored.  Here every probe kernel is a CUDA kernel for
Hopper (``webgraph_tpu_torch/csrc/probe_*.cu``) beside a plain PyTorch twin,
one module per probe file with the same name (``probe.py`` ...
``probe17.py``); ``python -m webgraph_tpu_torch.experiments.probeN`` runs one
on the card and prints a line per kernel.

One lane is one int32 element of an ``(R, 128)`` tile and one thread; an
``(8, 128)`` tile of 1,024 lanes is one thread block wherever a loop
condition reduces over the tile.  On CPU tensors every wrapper runs its plain
version; on CUDA tensors it launches its kernel or raises.
"""
