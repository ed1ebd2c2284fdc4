"""The device an entry point runs on.

Every entry point of the port defaults to "cuda" and runs the kernels there;
the plain PyTorch versions run only when the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device when torch
    sees no card, so that a missing card never turns into a silent run of the
    plain versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; pass device='cpu' "
                           "to run the plain PyTorch version")
    return device
