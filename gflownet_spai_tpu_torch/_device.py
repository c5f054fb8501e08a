"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  ``None`` means CUDA and raises when no card is present —
    the port never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "TrainConfig(platform='cpu')) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
