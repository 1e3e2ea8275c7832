"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device. With no GPU and no
    device named, or a CUDA device named, this raises: the port never falls
    back to the CPU on its own."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return device if device is not None else torch.device("cuda")
