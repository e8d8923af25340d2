"""Device selection shared by the entry points.

The port runs on the GPU.  An entry point left at ``device=None`` takes
``cuda`` and raises when there is none; running on the host is an explicit
``device="cpu"`` (the tests do that), never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        return torch.device("cuda")
    return torch.device(device)
