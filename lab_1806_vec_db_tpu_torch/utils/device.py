"""Device selection without a hidden fallback.

Every store, index and database takes an explicit `device`.  Asking for a
CUDA device on a machine without one raises; the code never carries on on
the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device; RuntimeError if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')")
    return dev
