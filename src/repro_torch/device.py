"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA device without a card raises — the port never drifts to
    the CPU on its own; tests pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
