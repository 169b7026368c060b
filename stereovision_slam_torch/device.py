"""Device choice for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". Without a card the
caller must ask for the CPU explicitly: nothing moves to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
