"""State carried between the JAX package and the port, as numpy arrays.

HyperLogLog registers: the JAX package keeps them as uint8 ``(n, 2^log2m)``
or packed uint32 ``(n, 2^log2m / 4)``, four registers per word in
little-endian byte order (``hyperball.pack_registers``); the port keeps
uint8.  A CSR is host int64 offsets plus device successors.  The decode plan
itself is not converted: it is rebuilt from the same .graph/.offsets bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceCSR(NamedTuple):
    offsets: np.ndarray      # int64[n+1], host
    succ: torch.Tensor       # int32[m], device


def registers_from_jax(a, device) -> torch.Tensor:
    """uint8 (n, R) or packed uint32 (n, R/4) registers -> torch uint8
    (n, R) on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.astype("<u4").view(np.uint8).reshape(a.shape[0], -1)
    elif a.dtype != np.uint8:
        raise ValueError(f"registers must be uint8 or uint32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def registers_to_jax(regs: torch.Tensor, packed: bool = False) -> np.ndarray:
    """torch uint8 (n, R) registers -> numpy uint8 (n, R), or packed uint32
    (n, R/4) when ``packed``."""
    a = regs.detach().cpu().numpy()
    if a.dtype != np.uint8:
        raise ValueError(f"registers must be uint8, got {a.dtype}")
    if not packed:
        return a
    return np.ascontiguousarray(a).view("<u4").astype(np.uint32)


def csr_from_numpy(offsets, succ, device) -> DeviceCSR:
    """Host CSR arrays -> (host int64 offsets, device int32 successors)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    succ = np.asarray(succ)
    if len(offsets) == 0 or offsets[0] != 0 or offsets[-1] != len(succ):
        raise ValueError("offsets must start at 0 and end at len(succ)")
    if len(succ) and (succ.min() < 0 or succ.max() >= (1 << 31)):
        raise ValueError("successors must fit int32")
    return DeviceCSR(offsets, torch.from_numpy(
        succ.astype(np.int32)).to(device))
