"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for CUDA where there is
none raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev
