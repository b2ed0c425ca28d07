"""Device selection: always explicit, never implied."""

from __future__ import annotations

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on the GPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index} "
                           f"({torch.cuda.device_count()} present)")
    return torch.device("cuda", index)
