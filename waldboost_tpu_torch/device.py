"""Where the port's entry points run: the card unless the caller says
otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` is the current CUDA device, and raises when there is no
    card: the port never falls back to the CPU on its own.  Any other value
    is taken as given (``"cpu"`` runs each kernel's plain-torch version);
    an unindexed ``"cuda"`` becomes the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

