"""Device policy of the port's entry points: CUDA unless the caller asks."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable GPU raises:
    nothing falls back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spiking_fullsubnet_torch: CUDA requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions.")
    return dev
