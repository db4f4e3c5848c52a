"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. A CUDA device without a GPU raises: the
    port never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable name of ``device`` (the card's name for CUDA)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
